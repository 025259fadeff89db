"""The readers of the program's spans and set-up record, by hand on a
synthetic trace of two batches, and what they read from a program that has
neither."""
import sys

import numpy as np
import pytest

from bench import harness
from bench.trace import Trace

MS = 1_000_000                      # ns


def _ctx(spans, batches=2):
    tr = Trace(window=(0, 100 * MS), spans=spans,
               dev_start=np.array([5 * MS]), dev_end=np.array([6 * MS]),
               dev_name=["k"])
    return harness.ReadContext(trace=tr, cfg={}, dims=(),
                               batches=[0] * batches, counters={}, n=0,
                               final_src=None, final_dst=None)


# two batches; batch 2 retried once; a span outside the window is not read
SPANS = [("bench.batch", 1 * MS, 40 * MS),
         ("DeviceEngine.route", 1 * MS, 3 * MS),
         ("DeviceCSRMirror.refresh", 3 * MS, 4 * MS),
         ("DeviceCSRMirror.refresh", 4 * MS, 6 * MS),
         ("DeviceEngine.propagate", 6 * MS, 30 * MS),
         ("DeviceEngine.hop0", 6 * MS, 20 * MS),
         ("DeviceEngine.wait", 30 * MS, 39 * MS),
         ("bench.batch", 50 * MS, 99 * MS),
         ("DeviceEngine.route", 50 * MS, 54 * MS),
         ("DeviceEngine.propagate", 55 * MS, 70 * MS),
         ("DeviceEngine.wait", 70 * MS, 71 * MS),
         ("DeviceEngine.retry", 71 * MS, 98 * MS),
         ("DeviceEngine.propagate", 71 * MS, 91 * MS),
         ("DeviceEngine.wait", 91 * MS, 98 * MS),
         ("DeviceEngine.propagate", 120 * MS, 130 * MS)]


@pytest.mark.parametrize("metric,want", [
    ("enqueue_ms_per_batch", (24 + 15 + 20) / 2),
    ("wait_ms_per_batch", (9 + 1 + 7) / 2),
    ("route_ms_per_batch", (2 + 4) / 2),
    ("refresh_ms_per_batch", (1 + 2) / 2)])
def test_span_reader_by_hand(metric, want):
    read = harness.load_reader(metric).read
    assert read(_ctx(SPANS)) == pytest.approx(want)
    assert read(_ctx(SPANS, batches=0)) is None
    # a program without the spans: nothing to read, nothing raised
    bare = [s for s in SPANS if s[0].startswith("bench.")]
    assert read(_ctx(bare)) is None


def test_refresh_reads_zero_where_no_row_was_touched():
    read = harness.load_reader("refresh_ms_per_batch").read
    spans = [s for s in SPANS if s[0] != "DeviceCSRMirror.refresh"]
    assert read(_ctx(spans)) == 0.0


def test_session_setup_reader_sums_the_outermost_stages(monkeypatch):
    from repro_torch import tracing
    read = harness.load_reader("session_setup_s").read
    monkeypatch.setattr(tracing, "_STAGES", {
        "DynamicGraph.csr": (1.5, True, 1),
        "InferenceState.full_pass": (4.0, True, 2),
        "DeviceEngine.warm": (2.0, True, 3),
        "kernels.load": (1.25, False, 3)})
    assert read(_ctx([])) == pytest.approx(7.5)
    monkeypatch.setattr(tracing, "_STAGES", {})
    assert read(_ctx([])) is None
    # a program without the record: nothing to read, nothing raised
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(_ctx([])) is None


class _Ev:
    """A host-side user annotation as the profiler's raw event gives it."""

    def __init__(self, name, start, end):
        self._v = (name, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CPU

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def is_user_annotation(self):
        return True


def test_trace_keeps_the_programs_span_names():
    names = ["DeviceEngine.route", "DeviceCSRMirror.refresh",
             "DeviceEngine.propagate", "DeviceEngine.hop0",
             "DeviceEngine.expand", "DeviceEngine.grow",
             "DeviceEngine.shrink", "DeviceEngine.pull",
             "DeviceEngine.apply", "DeviceEngine.commit",
             "DeviceEngine.wait", "DeviceEngine.retry"]
    evs = [_Ev("bench.window", 0, 100)]
    evs += [_Ev(n, 10 + i, 20 + i) for i, n in enumerate(names)]
    evs += [_Ev("InferenceState.full_pass", 1, 2)]   # set-up: not kept
    tr = Trace.from_events(evs)
    assert [s[0] for s in tr.spans] == names
