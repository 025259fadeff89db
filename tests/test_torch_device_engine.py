"""The port's ``device`` engine on the CPU against the JAX package's
``DeviceEngine(use_pallas=True)`` on the same stream, and the reference's
own device-engine contracts (tests/test_device_engine.py) on the port."""
import numpy as np
import pytest

import jax
import torch

import repro.core.graph as rgraph
from repro.core import (DynamicGraph, InferenceState, erdos_renyi,
                        make_workload, params_to_numpy)
from repro.core.device_engine import DeviceEngine as RefDeviceEngine

import repro_torch.core.graph as tgraph
from repro_torch.core.device_engine import (DeviceEngine,
                                            _unique_recipients, propagate)
from repro_torch.core.full import full_inference
from repro_torch.core.state import InferenceState as TState
from repro_torch.core.workloads import INVERTIBLE_WORKLOAD_NAMES
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy

ATOL = 2e-3


def _port(name, n=48, m=200, n_layers=2, seed=0):
    """(workload, graph, layers, state) of the port, with the reference's
    weights and the graph/features of tests/test_device_engine.py."""
    wl = make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                       n_classes=5)
    params = params_to_numpy(wl.init_params(jax.random.PRNGKey(seed)))
    twl = t_make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                          n_classes=5)
    src, dst, w = erdos_renyi(n, m, seed=seed, weighted=wl.spec.weighted)
    x = np.random.default_rng(seed + 1).normal(size=(n, 8)).astype(
        np.float32)
    layers = params_from_numpy(twl, params, "cpu")
    g = tgraph.DynamicGraph(n, src, dst, w)
    return twl, g, layers, TState.bootstrap(twl, layers, x, g, device="cpu")


def _engine(name, *, n=48, m=200, n_layers=2, **opts):
    wl, g, layers, state = _port(name, n=n, m=m, n_layers=n_layers)
    opts.setdefault("min_bucket", 16)
    return DeviceEngine(wl, layers, g, state, device="cpu", **opts)


def _plan(g, rng, n_batches=6, d0=8):
    """A stream as plain tuples (tests/test_device_engine.py::_stream),
    built into either package's update classes by :func:`_batch`."""
    plan = []
    for _ in range(n_batches):
        items = []
        for _ in range(4):
            u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
            if u != v:
                items.append(("e", u, v, not g.has_edge(u, v),
                              float(rng.uniform(0.2, 1.0))))
        items.append(("f", int(rng.integers(0, g.n)),
                      rng.normal(size=d0).astype(np.float32)))
        plan.append(items)
    return plan


def _batch(items, mod):
    b = mod.UpdateBatch()
    for it in items:
        if it[0] == "e":
            b.edges.append(mod.EdgeUpdate(*it[1:]))
        else:
            b.features.append(mod.FeatureUpdate(it[1], it[2].copy()))
    return b


def _assert_oracle(eng):
    """Every layer of the engine against the port's full-inference oracle
    on the engine's current graph and features."""
    H = eng.host_H()
    layers = eng.workload.make_layers("cpu")
    for layer, p in zip(layers, eng.params):
        for name, t in layer.named_parameters():
            t.copy_(p[name])
    ref, _ = full_inference(eng.workload, layers, torch.as_tensor(H[0]),
                            *eng.graph.coo(), eng.graph.in_degree)
    for l, (h, href) in enumerate(zip(H, ref)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=f"layer {l}")


@pytest.mark.parametrize("name,n,m", [
    *[(name, 48, 200) for name in INVERTIBLE_WORKLOAD_NAMES],
    # message buckets far below n/2: the sort regime of recipient compaction
    ("gc-w", 600, 2400), ("gi-s", 600, 2400)])
def test_matches_reference_device_engine(name, n, m):
    """Same stream through both packages: identical affected ids per batch
    and H within 1e-4 (the reference runs its Pallas kernels in interpret
    mode; the port its kernels' plain versions)."""
    n_layers = 3 if name == "gs-s" else 2
    wl = make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                       n_classes=5)
    params = wl.init_params(jax.random.PRNGKey(0))
    src, dst, w = erdos_renyi(n, m, seed=0, weighted=wl.spec.weighted)
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    g = DynamicGraph(n, src, dst, w)
    ref = RefDeviceEngine(wl, params, g,
                          InferenceState.bootstrap(wl, params, x, g),
                          min_bucket=16, use_pallas=True)
    port = _engine(name, n=n, m=m, n_layers=n_layers)
    for step, items in enumerate(_plan(g, np.random.default_rng(9))):
        a_ref = ref.apply_batch(_batch(items, rgraph))
        a_port = port.apply_batch(_batch(items, tgraph))
        np.testing.assert_array_equal(a_port, a_ref, err_msg=f"step {step}")
    assert port.retries == ref.retries
    for l, (h, href) in enumerate(zip(port.host_H(), ref.host_H())):
        np.testing.assert_allclose(h, href, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} layer {l}")


@pytest.mark.parametrize("r_cap", [4, 16, 64])
def test_unique_recipients_both_regimes(r_cap):
    """Mask regime (bucket >= n/2) and sort regime give the same ascending
    unique recipients, count and slot map as NumPy, truncated at r_cap."""
    n = 100
    rng = np.random.default_rng(r_cap)
    dst = np.concatenate([rng.integers(0, n, size=30), np.full(8, n)])
    rng.shuffle(dst)
    uniq = np.unique(dst[dst < n])
    outs = []
    for pad in (0, n):   # 38 messages: sort regime; padded to 138: mask
        all_dst = torch.as_tensor(np.concatenate([dst, np.full(pad, n)]))
        rec, pos, n_rec = _unique_recipients(n, all_dst, r_cap)
        assert int(n_rec) == uniq.size
        want = np.full(r_cap, n)
        want[:min(r_cap, uniq.size)] = uniq[:r_cap]
        np.testing.assert_array_equal(rec.numpy(), want)
        slot = np.full(n + 1, r_cap)
        slot[uniq[:r_cap]] = np.arange(min(r_cap, uniq.size))
        np.testing.assert_array_equal(pos.numpy(), slot)
        outs.append(rec.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
def test_matches_oracle(name):
    eng = _engine(name)
    rng = np.random.default_rng(3)
    for step in range(4):
        batch = tgraph.UpdateBatch()
        u, v = int(rng.integers(0, eng.n)), int(rng.integers(0, eng.n))
        if u != v:
            batch.edges.append(tgraph.EdgeUpdate(
                u, v, not eng.graph.has_edge(u, v),
                float(rng.uniform(0.2, 1.0))))
        batch.features.append(tgraph.FeatureUpdate(
            int(rng.integers(0, eng.n)), rng.normal(size=8).astype(
                np.float32)))
        eng.apply_batch(batch)
        _assert_oracle(eng)


def test_overflow_retry_small_buckets():
    """Tiny initial buckets: the ladder must retry and stay exact."""
    eng = _engine("gc-s", n=64, m=700, min_bucket=4)
    rng = np.random.default_rng(0)
    eng.apply_batch(tgraph.UpdateBatch(features=[
        tgraph.FeatureUpdate(int(v), rng.normal(size=8).astype(np.float32))
        for v in rng.choice(eng.n, size=20, replace=False)]))
    assert eng.retries > 0
    _assert_oracle(eng)


def test_mirror_single_upload_across_stream():
    """The CSR mirror uploads the full pool once; every later batch is
    touched-row refreshes only (no O(E) host->device transfer)."""
    eng = _engine("gs-s")
    for items in _plan(eng.graph, np.random.default_rng(5), n_batches=8):
        eng.apply_batch(_batch(items, tgraph))
    m = eng.out_mirror
    assert m.uploads == 1 and m.rebuilds == 0 and m.row_refreshes > 0
    _assert_oracle(eng)


def test_mirror_rebuild_on_slack_overflow():
    """Concentrated appends outgrow one row's slack: the mirror rebuilds
    and stays equal to the host adjacency row for row."""
    eng = _engine("gc-s")
    g = eng.graph
    eng.apply_batch(tgraph.UpdateBatch(edges=[
        tgraph.EdgeUpdate(0, v, True, 1.0) for v in range(1, 40)
        if not g.has_edge(0, v)]))
    m = eng.out_mirror
    assert m.rebuilds >= 1
    col, start, length = (t.numpy() for t in (m.col, m.start, m.length))
    for v in range(g.n):
        np.testing.assert_array_equal(
            np.sort(col[start[v]:start[v] + length[v]]),
            np.sort(g.out.row(v)[0]), err_msg=f"row {v}")
    _assert_oracle(eng)


@pytest.mark.parametrize("donate", [True, False])
def test_overflow_commits_nothing(donate):
    """An overflowing attempt leaves the state bit-identical, updated in
    place or not -- the gated-commit contract behind the ladder retry."""
    eng = _engine("gc-s", n=64, m=700, warm=False)
    rng = np.random.default_rng(0)
    dev_batch, _, _ = eng._route(tgraph.UpdateBatch(features=[
        tgraph.FeatureUpdate(int(v), rng.normal(size=8).astype(np.float32))
        for v in rng.choice(eng.n, size=16, replace=False)]))
    before = eng.state.clone()
    new_state, report = propagate(eng.workload, eng.n, ((4, 4), (4, 4)),
                                  eng.params, eng.eps, eng.state,
                                  eng.out_mirror.csr(), dev_batch,
                                  donate=donate)
    overflow, _, _, final = eng._read(report)
    assert overflow
    for a, b in zip(new_state.H + new_state.S, before.H + before.S):
        torch.testing.assert_close(a[:eng.n], b[:eng.n], rtol=0, atol=0)
    torch.testing.assert_close(new_state.k[:eng.n], before.k[:eng.n],
                               rtol=0, atol=0)
    assert np.all(final == eng.n)


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
def test_donated_matches_fresh(name):
    """In-place propagation matches the copying path on the same stream."""
    don = _engine(name, donate=True)
    ref = _engine(name, donate=False)
    plan = _plan(don.graph, np.random.default_rng(9))
    for items in plan:
        np.testing.assert_array_equal(don.apply_batch(_batch(items, tgraph)),
                                      ref.apply_batch(_batch(items, tgraph)))
    for l, (h1, h2) in enumerate(zip(don.host_H(), ref.host_H())):
        np.testing.assert_allclose(h1, h2, atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name} layer {l}")


@pytest.mark.parametrize("name", ["gc-s", "gi-s"])
def test_async_matches_sync(name):
    """Pipelined dispatch (lazy overflow check) drains to the same state
    as the synchronous engine, one batch of latency behind."""
    asy = _engine(name, async_dispatch=True, debug_checks=True)
    ref = _engine(name)
    prev = np.empty(0, np.int64)
    for items in _plan(asy.graph, np.random.default_rng(13)):
        np.testing.assert_array_equal(asy.apply_batch(_batch(items, tgraph)),
                                      prev)
        prev = ref.apply_batch(_batch(items, tgraph))
    np.testing.assert_array_equal(asy.flush(), prev)
    np.testing.assert_allclose(asy.state.k[:asy.n].numpy(),
                               asy.graph.in_degree)
    for l, (h1, h2) in enumerate(zip(asy.host_H(), ref.host_H())):
        np.testing.assert_allclose(h1, h2, atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name} layer {l}")


def test_k_maintained_on_device():
    """The in-degree vector is maintained on the device from each batch's
    add/delete counts; debug_checks asserts it per batch."""
    eng = _engine("gc-m", debug_checks=True)
    for items in _plan(eng.graph, np.random.default_rng(17), n_batches=8):
        eng.apply_batch(_batch(items, tgraph))
    np.testing.assert_allclose(eng.state.k[:eng.n].numpy(),
                               eng.graph.in_degree)
    _assert_oracle(eng)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="bounded"):
        _engine("gc-s", tolerance=0.1)
    with pytest.raises(RuntimeError, match="enable_commit_log"):
        _engine("gc-s").drain_commits()
