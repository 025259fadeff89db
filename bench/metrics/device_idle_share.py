"""The device's idle share of the traced window, %: one minus the union of
kernel, copy and fill intervals over the window's wall time."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 else None
