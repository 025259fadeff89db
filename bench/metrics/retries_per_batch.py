"""Overflow retries a batch: the engine's ``retries`` counter over the
window, over the window's batches.  Layer: the cap ladder (an overflowed
batch runs again on fitting caps)."""


def read(ctx):
    r = ctx.counters["retries"]
    if r is None or not ctx.batches:
        return None
    return r / len(ctx.batches)
