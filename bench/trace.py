"""The traced window: spans from the benchmark's side, device intervals from
the profiler, and their reduction.

``torch.profiler`` records the window with CPU and CUDA activity.  The
benchmark marks its own spans with ``record_function``: ``bench.window``
around the window, ``bench.generate`` around making a batch, ``bench.batch``
around ``apply_one``, and, through wrappers it installs for the traced run
only, one span per call of the program's layer entries named in
``LAYER_SPANS`` (a missing entry is skipped).  Device intervals are the
kernels, copies and fills that ran on the card.  Everything is read from
the profiler's raw events, on one clock.

Events are sorted by what they are, not by their names: a device-side
event is a device operation unless the profiler flags it as a user
annotation (the device range of a ``record_function`` span, the
benchmark's or the program's, which covers idle time too); a span is a
host-side user annotation.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys
from dataclasses import dataclass, field

import numpy as np

# (module, class, method) of the program's layer entries that get a span
LAYER_SPANS = (
    ("repro_torch.core.device_engine", "DeviceEngine", "_route"),
    ("repro_torch.core.device_engine", "DeviceEngine", "_dispatch"),
    ("repro_torch.core.device_engine", "DeviceEngine", "_resolve"),
    ("repro_torch.core.device_engine", "DeviceCSRMirror", "refresh_rows"),
)
SPAN_PREFIXES = ("bench.",) + tuple(f"{c}." for _, c, _ in LAYER_SPANS)


def _ns(ev) -> tuple[int, int]:
    """An event's (start, end) in ns."""
    start = ev.start_ns()
    return start, start + ev.duration_ns()


@contextlib.contextmanager
def layer_spans():
    """Wrap each entry of ``LAYER_SPANS`` in a ``record_function`` span
    named ``Class.method`` while the context is open."""
    from torch.profiler import record_function
    undo = []
    for mod_name, cls_name, meth in LAYER_SPANS:
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
            fn = getattr(cls, meth)
        except (ImportError, AttributeError):
            continue

        def wrap(fn=fn, label=f"{cls_name}.{meth}"):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with record_function(label):
                    return fn(*args, **kwargs)
            return spanned
        setattr(cls, meth, wrap())
        undo.append((cls, meth, fn))
    try:
        yield
    finally:
        for cls, meth, fn in undo:
            setattr(cls, meth, fn)


@dataclass
class Trace:
    """What the window's profile holds, in ns on the profiler's clock."""

    window: tuple[int, int]
    spans: list[tuple[str, int, int]]          # (name, start, end)
    dev_start: np.ndarray                      # device intervals
    dev_end: np.ndarray
    dev_name: list[str]
    merged: np.ndarray = field(init=False)     # [k, 2] disjoint, sorted
    _cum: np.ndarray = field(init=False)

    def __post_init__(self):
        lo, hi = self.window
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        if s.size:
            run_end = np.maximum.accumulate(e)
            new = np.ones(s.size, bool)
            new[1:] = s[1:] > run_end[:-1]
            starts = s[new]
            ends = run_end[np.r_[np.nonzero(new)[0][1:] - 1, s.size - 1]]
            self.merged = np.stack([starts, ends], axis=1)
        else:
            self.merged = np.zeros((0, 2), np.int64)
        lens = self.merged[:, 1] - self.merged[:, 0]
        self._cum = np.concatenate([[0], np.cumsum(lens)])

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        return cls.from_events(prof.profiler.kineto_results.events())

    @classmethod
    def from_events(cls, events) -> "Trace":
        """The trace of the profiler's raw events (``_KinetoEvent``)."""
        from torch.autograd import DeviceType
        window = None
        spans, ds, de, dn = [], [], [], []
        skipped = 0
        for ev in events:
            if ev.device_type() == DeviceType.CUDA:
                if ev.is_user_annotation():
                    skipped += 1
                    continue
                start, end = _ns(ev)
                ds.append(start)
                de.append(end)
                dn.append(ev.name())
            elif ev.is_user_annotation() \
                    and ev.name().startswith(SPAN_PREFIXES):
                span = (ev.name(), *_ns(ev))
                if span[0] == "bench.window":
                    window = span[1:]
                else:
                    spans.append(span)
        print(f"device events: {len(ds)} operations, {skipped} annotation "
              "ranges left out", file=sys.stderr, flush=True)
        if window is None:
            raise RuntimeError("the profile holds no bench.window span")
        return cls(window=window, spans=spans,
                   dev_start=np.asarray(ds, np.int64),
                   dev_end=np.asarray(de, np.int64), dev_name=dn)

    # -- reductions --------------------------------------------------------
    def covered_ns(self, a, b) -> np.ndarray:
        """Device-busy ns inside each interval [a, b) (arrays)."""
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)

        def upto(t):
            k = np.searchsorted(self.merged[:, 0], t, side="right") - 1
            kc = np.clip(k, 0, None)
            part = np.clip(t - self.merged[kc, 0], 0,
                           self.merged[kc, 1] - self.merged[kc, 0]) \
                if self.merged.size else np.zeros_like(t)
            return np.where(k >= 0, self._cum[kc] + part, 0)
        return upto(b) - upto(a)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return float(self._cum[-1]) * 1e-9

    def spans_named(self, name: str) -> list[tuple[int, int]]:
        lo, hi = self.window
        return [(s, e) for n, s, e in self.spans
                if n == name and s >= lo and e <= hi]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took the most time: [[name, s]]."""
        lo, hi = self.window
        tot: dict[str, int] = {}
        for name, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            d = min(int(e), hi) - max(int(s), lo)
            if d > 0:
                key = name if len(name) <= 120 else name[:117] + "..."
                tot[key] = tot.get(key, 0) + d
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-9] for k, v in best]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Device-idle time inside the window, by what the host was doing:
        each gap is named by the innermost span around its middle (or
        "host" where no span is open), and summed by name: [[name, s]]."""
        lo, hi = self.window
        edges = np.concatenate([[lo], self.merged.ravel(), [hi]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        if not gaps.size:
            return []
        mid = (gaps[:, 0] + gaps[:, 1]) // 2
        names = np.full(mid.size, "host", dtype=object)
        width = np.full(mid.size, np.iinfo(np.int64).max)
        for name, s, e in self.spans:
            a = np.searchsorted(mid, s, side="left")
            b = np.searchsorted(mid, e, side="right")
            if b > a:
                inner = width[a:b] > e - s
                names[a:b][inner] = name
                width[a:b][inner] = e - s
        tot: dict[str, int] = {}
        for name, g in zip(names, gaps[:, 1] - gaps[:, 0]):
            tot[name] = tot.get(name, 0) + int(g)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-9] for k, v in best]

    def span_ms(self) -> dict[str, float]:
        """Host ms in each span name over the window (for the log)."""
        out: dict[str, float] = {}
        lo, hi = self.window
        for name, s, e in self.spans:
            if s >= lo and e <= hi:
                out[name] = out.get(name, 0.0) + (e - s) * 1e-6
        return out

    def device_s(self, fragments: tuple[str, ...]) -> float | None:
        """Summed device seconds of the operations whose name holds any of
        ``fragments``; None when none ran."""
        lo, hi = self.window
        total, hit = 0, False
        for name, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            if any(f in name for f in fragments):
                d = min(int(e), hi) - max(int(s), lo)
                if d > 0:
                    total += d
                    hit = True
        return total * 1e-9 if hit else None
