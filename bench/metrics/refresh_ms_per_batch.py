"""Host ms a batch in the CSR mirrors' refresh: the program's
``DeviceCSRMirror.refresh`` spans (one for each mirror refreshed, rebuilds
included) in the traced window, summed, over the window's batches; 0 where
no batch touched a row.  None where the program has no batch-path spans
(no ``DeviceEngine.propagate``)."""


def read(ctx):
    if not ctx.batches \
            or not ctx.trace.spans_named("DeviceEngine.propagate"):
        return None
    spans = ctx.trace.spans_named("DeviceCSRMirror.refresh")
    return sum(e - s for s, e in spans) * 1e-6 / len(ctx.batches)
