"""Host ms a batch: for each ``apply_one`` in the traced window, its wall
time less the union of device intervals inside it; the mean over batches.
Layer: the session and engine host path (routing, graph mutation, mirror
refresh, launches)."""
import numpy as np


def read(ctx):
    spans = ctx.trace.spans_named("bench.batch")
    if not spans:
        return None
    a = np.array([s for s, _ in spans], np.int64)
    b = np.array([e for _, e in spans], np.int64)
    return float(((b - a) - ctx.trace.covered_ns(a, b)).mean() * 1e-6)
