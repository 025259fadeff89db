"""``shrink_pull_ms_per_batch`` by hand on a synthetic trace: the kernel's
device ms inside the window over the window's batches; without its
symbol, None for a program that lacks the kernel, for a card's trace and
for a kernel that launched unseen, 0 for a window with no device op and
the kernel never launched (a CPU run)."""
import sys

import numpy as np
import pytest

from repro_torch.kernels.shrink_pull import shrink_pull

from bench import harness
from bench.trace import Trace

MS = 1_000_000                      # ns
KERNEL = "void (anonymous namespace)::shrink_pull_kernel(unsigned char " \
    "const*, long long const*)"


def _ctx(names, starts, ends, batches=2):
    tr = Trace(window=(0, 100 * MS), spans=[("bench.batch", 0, 100 * MS)],
               dev_start=np.array(starts) * MS, dev_end=np.array(ends) * MS,
               dev_name=list(names))
    return harness.ReadContext(trace=tr, cfg={}, dims=(),
                               batches=[0] * batches, counters={}, n=0,
                               final_src=None, final_dst=None)


@pytest.mark.parametrize("batches,want", [(2, (1.5 + 0.5 + 1.0) / 2),
                                          (3, (1.5 + 0.5 + 1.0) / 3)])
def test_shrink_pull_ms_by_hand(batches, want):
    """Three launches, the last cut by the window's end; the other
    kernels and the span's own device range are not read."""
    read = harness.load_reader("shrink_pull_ms_per_batch").read
    names = [KERNEL, "ExtremumFold", KERNEL, "Memset (Device)", KERNEL]
    ctx = _ctx(names, [1, 2, 10, 11, 99], [2.5, 9, 10.5, 12, 101], batches)
    assert read(ctx) == pytest.approx(want)


def test_shrink_pull_ms_without_the_symbol(monkeypatch):
    read = harness.load_reader("shrink_pull_ms_per_batch").read
    cpu = _ctx([], [], [])                     # no device op in the window
    card = _ctx(["ExtremumFold"], [1], [2])    # a card's, without the kernel
    monkeypatch.setattr(shrink_pull, "launches", 0)
    assert read(cpu) == 0.0                    # never launched: the CPU
    assert read(card) is None                  # went round it: not measured
    assert read(_ctx([KERNEL], [1], [2], batches=0)) is None
    monkeypatch.setattr(shrink_pull, "launches", 3)
    assert read(cpu) is None                   # launched, not in the trace
    assert read(card) is None
    # a program without the kernel: nothing to read, nothing raised
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.shrink_pull", None)
    assert read(cpu) is None and read(card) is None
