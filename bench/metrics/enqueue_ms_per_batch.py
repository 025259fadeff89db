"""Host ms a batch in the propagation's enqueue: the program's
``DeviceEngine.propagate`` spans in the traced window (one for each
attempt, so retries count), summed, over the window's batches.  Layer: the
launch path, the host enqueueing every hop's device operations and the
gated commit.  None where the program has no such span."""


def read(ctx):
    spans = ctx.trace.spans_named("DeviceEngine.propagate")
    if not spans or not ctx.batches:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / len(ctx.batches)
