"""The port's spans: named host intervals at the boundaries of its layers.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
profiler records, so the span lies in the profiler's trace beside the
device operations, on the same clock; nesting gives its parent, and the
caller's span around a batch identifies the request.  With no profiler
recording it costs one flag check and returns the shared no-op
``NO_SPAN``: it enters no ``record_function``, allocates nothing and reads
no clock.  To see the spans, run the program under
``torch.profiler.profile`` and export the trace (``export_chrome_trace``).

The device engine's batch path (``core/device_engine.py``):

- ``DeviceEngine.route``: host graph mutation, feature dedup, padding and
  the batch's three uploads;
- ``DeviceCSRMirror.refresh``: one for each mirror refreshed (rebuilds
  included);
- ``DeviceEngine.propagate``: one for each attempt, the whole enqueue of
  the propagation, holding ``DeviceEngine.hop0`` .. ``hop{L-1}`` and one
  ``DeviceEngine.commit`` (the gated writes and the report);
- inside a hop: ``DeviceEngine.expand`` (frontier edges, recipient
  compaction), ``DeviceEngine.grow`` (SHRINK classification, GROW's
  candidate extremum, the re-cover probe) and ``DeviceEngine.shrink`` (the
  in-CSR pull and its extremum) in the monotonic family,
  ``DeviceEngine.pull`` (the in-neighbourhood re-aggregation) in the
  bounded family, and ``DeviceEngine.apply`` (the hop apply and the
  frontier filter) in every family;
- ``DeviceEngine.wait``: the host blocked on the device, reading the
  batch's report;
- ``DeviceEngine.retry``: one for each turn of the overflow loop, holding
  the retry's ``propagate`` and ``wait``.

With ``async_dispatch`` the engine resolves batch t-1 inside batch t's
call, so the ``wait`` and ``retry`` spans inside batch t's call belong to
batch t-1.  The spans sit in host code only: a kernel runs on the device
after the span that launched it has closed.

Set-up stages (``span(name, setup=True)``) also time themselves on the
host clock, whether or not a profiler records, and :func:`setup_seconds`
gives each stage's latest occurrence: ``DynamicGraph.csr`` and
``DynamicGraph.edge_set`` (the graph store), ``InferenceState.full_pass``,
``InferenceState.contributors`` and ``InferenceState.aux`` (the
bootstrap), ``DeviceEngine.upload`` and ``DeviceEngine.warm`` (the
engine), and ``kernels.load`` (a kernel library's build and load).
"""
from __future__ import annotations

import functools
import itertools
import threading
import time

import torch
import torch.profiler

_recording = torch._C._autograd._profiler_enabled


class _NoSpan:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()

# set-up stages: name -> (seconds, outermost, the outermost stage's id);
# a stage nested in another adds up its occurrences inside that one
_STAGES: dict[str, tuple[float, bool, int]] = {}
_OUTER_IDS = itertools.count(1)
_OPEN = threading.local()       # per thread: the outermost stage open, depth


class _SetupSpan:
    """A set-up stage: a span while a profiler records, and its host-clock
    seconds in the set-up record always."""

    __slots__ = ("name", "_rf", "_t0", "_outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        depth = getattr(_OPEN, "depth", 0)
        if depth == 0:
            _OPEN.outer_id = next(_OUTER_IDS)
        _OPEN.depth = depth + 1
        self._outer = depth == 0
        self._rf = torch.profiler.record_function(self.name) \
            if _recording() else None
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _OPEN.depth -= 1
        outer_id = _OPEN.outer_id
        prev = _STAGES.get(self.name)
        if prev is not None and not self._outer and prev[2] == outer_id:
            dt += prev[0]
        _STAGES[self.name] = (dt, self._outer, outer_id)
        return False


def span(name: str, *, setup: bool = False):
    """A context manager around one stage named ``name``: a
    ``record_function`` range while a profiler records, else ``NO_SPAN``.
    A set-up stage (``setup``) also stores its host-clock seconds in the
    set-up record."""
    if setup:
        return _SetupSpan(name)
    if _recording():
        return torch.profiler.record_function(name)
    return NO_SPAN


def spanned(name: str, *, setup: bool = False):
    """A decorator: every call of the function runs in ``span(name,
    setup=setup)``, chosen at the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, setup=setup):
                return fn(*args, **kwargs)
        return inner
    return wrap


def setup_seconds(*, outermost: bool = False) -> dict[str, float]:
    """Host-clock seconds of each set-up stage at its latest occurrence
    (the occurrences of a nested stage inside one outermost stage add
    up); with ``outermost`` only the stages no other set-up stage held,
    whose sum is the set-up time counted once."""
    return {name: s for name, (s, outer, _) in _STAGES.items()
            if outer or not outermost}
