"""The port's spans (``repro_torch.tracing``) on the CPU: the device
engine's batch path under ``torch.profiler``, the off path without one,
and the set-up record."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.api import InferenceSession
from repro_torch.core.graph import (DynamicGraph, EdgeUpdate, FeatureUpdate,
                                    UpdateBatch, erdos_renyi)
from repro_torch.core.workloads import make_workload
from repro_torch.kernels import _build

N, M, D, LAYERS = 300, 1500, 8, 3
HOP_STAGES = {"gs-max": ("DeviceEngine.expand", "DeviceEngine.grow",
                         "DeviceEngine.shrink", "DeviceEngine.apply"),
              "gp-m": ("DeviceEngine.expand", "DeviceEngine.pull",
                       "DeviceEngine.apply")}
SETUP_STAGES = {"gs-max": "InferenceState.contributors",
                "gp-m": "InferenceState.aux"}


def _session(name, **engine_options):
    wl = make_workload(name, n_layers=LAYERS, d_in=D, d_hidden=D,
                       n_classes=4)
    params = wl.init_params(torch.Generator().manual_seed(3), device="cpu")
    src, dst, w = erdos_renyi(N, M, seed=5)
    x = np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)
    graph = DynamicGraph(N, src, dst, w)
    return InferenceSession.bootstrap(wl, params, x, graph, engine="device",
                                      device="cpu",
                                      engine_options=engine_options)


def _batches(session, count, seed=11, n_feat=6):
    """``count`` batches of additions, deletions and feature updates."""
    rng = np.random.default_rng(seed)
    g = session.graph
    src, dst, _ = g.coo()
    out = []
    for _ in range(count):
        edges = [EdgeUpdate(int(u), int(v), True)
                 for u, v in rng.integers(0, N, size=(6, 2)) if u != v]
        edges += [EdgeUpdate(int(src[i]), int(dst[i]), False)
                  for i in rng.choice(src.size, size=4, replace=False)]
        feats = [FeatureUpdate(int(v), rng.normal(size=D).astype(np.float32))
                 for v in rng.choice(N, size=n_feat, replace=False)]
        out.append(UpdateBatch(edges=edges, features=feats))
    return out


def _spans(prof):
    """The profile's ``record_function`` ranges: [(name, start, end)]."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return sorted(out, key=lambda t: (t[1], -t[2]))


def _inside(spans, outer, name=None):
    """The spans inside ``outer`` (and not ``outer`` itself), by name."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b
            and (name is None or s[0] == name)]


def _children(spans, outer):
    """The spans directly inside ``outer``: no third span between."""
    inner = _inside(spans, outer)
    return [s for s in inner
            if not any(p is not s and p[1] <= s[1] and s[2] <= p[2]
                       for p in inner)]


def _traced(session, batches):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            with record_function("test.batch"):
                session.apply_one(b)
    return _spans(prof)


@pytest.mark.parametrize("name", ["gs-max", "gp-m"])
def test_batch_spans_nest_as_the_layers(name):
    s = _session(name)
    batches = _batches(s, 8)
    for b in batches[:5]:            # past the cap ladder's first retries
        s.apply_one(b)
    retries = s.engine.impl.retries
    spans = _traced(s, batches[5:])
    assert s.engine.impl.retries == retries
    batches = [sp for sp in spans if sp[0] == "test.batch"]
    assert len(batches) == 3
    hops = [f"DeviceEngine.hop{l}" for l in range(LAYERS)]
    for batch in batches:
        top = _children(spans, batch)
        names = [sp[0] for sp in top]
        # two mirrors refreshed (out and in), between route and propagate
        assert names == ["DeviceEngine.route", "DeviceCSRMirror.refresh",
                         "DeviceCSRMirror.refresh", "DeviceEngine.propagate",
                         "DeviceEngine.wait"]
        prop = top[3]
        assert [sp[0] for sp in _children(spans, prop)] \
            == hops + ["DeviceEngine.commit"]
        for hop in _children(spans, prop)[:LAYERS]:
            assert tuple(sp[0] for sp in _children(spans, hop)) \
                == HOP_STAGES[name]


@pytest.mark.parametrize("name", ["gs-max", "gp-m"])
def test_overflow_adds_a_retry_span(name):
    s = _session(name, min_bucket=4)
    eng = s.engine.impl
    spans = _traced(s, _batches(s, 1, n_feat=40))
    assert eng.retries > 0
    batch, = [sp for sp in spans if sp[0] == "test.batch"]
    retries = [sp for sp in _children(spans, batch)
               if sp[0] == "DeviceEngine.retry"]
    assert len(retries) == eng.retries
    for r in retries:
        assert [sp[0] for sp in _children(spans, r)] \
            == ["DeviceEngine.propagate", "DeviceEngine.wait"]


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracing.span("DeviceEngine.route") is tracing.NO_SPAN
    assert tracing.span("DeviceEngine.wait") is tracing.NO_SPAN
    for name in ("gs-max", "gp-m"):
        s = _session(name)          # the set-up stages too
        for b in _batches(s, 2):
            s.apply_one(b)


@pytest.mark.parametrize("name", ["gs-max", "gp-m"])
def test_state_is_the_same_with_and_without_a_profiler(name):
    plain, traced = _session(name), _session(name)
    batches = _batches(plain, 4)
    for b in batches:
        plain.apply_one(b)
    _traced(traced, batches)
    a, b = plain.sync(), traced.sync()
    for x, y in zip(a.H + a.S + (a.C or []), b.H + b.S + (b.C or [])):
        np.testing.assert_array_equal(x, y)
    for la, lb in zip(a.A or [], b.A or []):
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.parametrize("name", ["gs-max", "gp-m"])
def test_setup_record_holds_every_stage(name):
    t0 = time.perf_counter()
    _session(name)
    wall = time.perf_counter() - t0
    stages = ("DynamicGraph.csr", "DynamicGraph.edge_set",
              "InferenceState.full_pass", SETUP_STAGES[name],
              "DeviceEngine.upload", "DeviceEngine.warm")
    outer = tracing.setup_seconds(outermost=True)
    assert set(stages) <= set(outer)
    assert all(outer[k] > 0 for k in stages)
    assert sum(outer[k] for k in stages) <= wall


def test_nested_stage_is_not_outermost_and_adds_up(monkeypatch):
    clock = [0.0]

    def tick(seconds):
        clock[0] += seconds
    monkeypatch.setattr(tracing, "time",
                        SimpleNamespace(perf_counter=lambda: clock[0]))
    monkeypatch.setattr(_build, "build_all", lambda names: tick(1.0))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with tracing.span("DeviceEngine.warm", setup=True):
        _build.load("a")
        tick(0.5)
        _build.load("b")
        _build.load("a")            # loaded already: no stage
    every = tracing.setup_seconds()
    outer = tracing.setup_seconds(outermost=True)
    assert "kernels.load" not in outer
    assert (every["kernels.load"], outer["DeviceEngine.warm"]) == (2.0, 2.5)
    # the latest outermost stage replaces what the earlier one held
    with tracing.span("DeviceEngine.warm", setup=True):
        _build.load("c")
    assert tracing.setup_seconds()["kernels.load"] == 1.0
    assert tracing.setup_seconds()["DeviceEngine.warm"] == 1.0
    assert set(_build._LIBS) == {"a", "b", "c"}
