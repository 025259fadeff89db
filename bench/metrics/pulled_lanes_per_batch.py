"""Pulled lanes a batch: the pulled-lanes channel (index 2) of the
engine's per-hop needed sizes, summed over hops and the window's batches,
over the batches.  Layer: the re-aggregation (in-neighbourhood pulls)."""


def read(ctx):
    sizes = ctx.counters["sizes_total"]
    if sizes is None or sizes.ndim != 2 or sizes.shape[1] < 3 \
            or not ctx.batches:
        return None
    return float(sizes[:, 2].sum()) / len(ctx.batches)
