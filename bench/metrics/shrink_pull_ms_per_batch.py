"""Device ms a batch in the SHRINK pull kernel: ``shrink_pull``'s summed
device time in the traced window, found by its symbol, over the window's
batches.  Layer: re-aggregation, the monotonic hop's SHRINK pull
(kernels/shrink_pull, csrc/shrink_pull.cu).  None where the program has no
such kernel, and None on a card whose trace holds none of it (a run that
went round the kernel was not measured); 0 only for a window that ran
nothing on a device (a CPU run, whose route is the plain version) with
the kernel never launched in the process."""

SYMBOLS = ("shrink_pull",)


def read(ctx):
    if not ctx.batches:
        return None
    t = ctx.trace.device_s(SYMBOLS)
    if t is not None:
        return 1000.0 * t / len(ctx.batches)
    try:
        from repro_torch.kernels.shrink_pull import shrink_pull
    except ImportError:
        return None
    on_cpu = len(ctx.trace.dev_name) == 0
    return 0.0 if on_cpu and shrink_pull.launches == 0 else None
