"""``extremum_apply``'s share of its roofline, %: the least time of the
window's calls (``work.formulas.extremum_work`` over each hop's needed
recipients, not the cap rung) over the kernel's summed device time, found
by its symbols.  Layer: kernels/extremum_apply (csrc/extremum_apply.cu)."""
from bench.work.formulas import bound_s, extremum_work

SYMBOLS = ("ExtremumFold", "kchunk_kernel")


def read(ctx):
    t = ctx.trace.device_s(SYMBOLS)
    sizes = ctx.counters["sizes_total"]
    launches = ctx.counters["launches"].get("extremum_apply")
    if t is None or sizes is None or not launches:
        return None
    L = len(ctx.dims) - 1
    nbytes = flops = 0
    for l in range(L):
        b, f = extremum_work(int(sizes[l, 0]), ctx.dims[l], ctx.dims[l + 1],
                             launches // L)
        nbytes, flops = nbytes + b, flops + f
    return 100.0 * bound_s(nbytes, flops) / t
