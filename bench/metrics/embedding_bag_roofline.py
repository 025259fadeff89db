"""``embedding_bag``'s share of its roofline, %: the least time of the
window's bags (``work.formulas.bag_work`` over each hop's needed
recipients and kept lanes, not the padded rectangle) over the kernel's
summed device time, found by its symbols.  Layer: kernels/embedding_bag
(csrc/embedding_bag.cu)."""
from bench.work.formulas import bag_work, bound_s

SYMBOLS = ("bag_span_kernel", "bag_combine_kernel", "bag_narrow_kernel")


def read(ctx):
    t = ctx.trace.device_s(SYMBOLS)
    sizes = ctx.counters["sizes_total"]
    if t is None or sizes is None:
        return None
    nbytes = flops = 0
    for l in range(len(ctx.dims) - 1):
        b, f = bag_work(int(sizes[l, 0]), int(sizes[l, 2]), ctx.dims[l])
        nbytes, flops = nbytes + b, flops + f
    return 100.0 * bound_s(nbytes, flops) / t
