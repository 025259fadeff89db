"""The whole step's share of the card's fp32 peak, %: the window's model
FLOPs over (window seconds x 67 TFLOP/s).  Model FLOPs are 2 Din Dout per
matrix product of each layer's UPDATE for every row in that layer's l-hop
out-neighbourhood of each batch's touched vertices, counted by the
benchmark on its own copy of the graph (``work.formulas.lhop_rows``): an
upper bound on the matrix work an exact incremental pass could need."""
from bench.work.formulas import PEAK_FLOPS, layer_flops_per_row, lhop_rows


def read(ctx):
    if not ctx.batches or ctx.trace.window_s <= 0:
        return None
    cfg, dims = ctx.cfg, ctx.dims
    rows = lhop_rows(ctx.n, ctx.final_src, ctx.final_dst, ctx.batches,
                     len(dims) - 1, cfg["self_dependent"])
    flops = sum(int(rows[:, l].sum())
                * layer_flops_per_row(cfg["update"], cfg["aggregator"],
                                      dims[l], dims[l + 1])
                for l in range(len(dims) - 1))
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FLOPS)
