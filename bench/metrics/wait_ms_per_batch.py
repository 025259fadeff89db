"""Host ms a batch blocked on the device: the program's
``DeviceEngine.wait`` spans (the read of each attempt's report, retries
included) in the traced window, summed, over the window's batches.  Layer:
the batch's one wait on the device.  None where the program has no such
span."""


def read(ctx):
    spans = ctx.trace.spans_named("DeviceEngine.wait")
    if not spans or not ctx.batches:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / len(ctx.batches)
