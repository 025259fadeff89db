"""Host ms a batch in routing: the program's ``DeviceEngine.route`` spans
(host graph mutation, feature dedup, padding and the batch's uploads) in
the traced window, summed, over the window's batches.  None where the
program has no such span."""


def read(ctx):
    spans = ctx.trace.spans_named("DeviceEngine.route")
    if not spans or not ctx.batches:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / len(ctx.batches)
