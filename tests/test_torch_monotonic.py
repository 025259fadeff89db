"""The port's monotonic (max/min) family against the JAX package: the
aggregator primitives, bootstrap, the ``device`` engine in both SHRINK
pull regimes batch for batch, and the reference's monotonic contracts
(tests/test_aggregators.py, tests/test_device_engine.py) on the port."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core.aggregators as ragg
import repro.core.graph as rgraph
from repro.core import (DynamicGraph, InferenceState, erdos_renyi,
                        make_workload, params_to_numpy)
from repro.core.device_engine import DeviceEngine as RefDeviceEngine

import repro_torch.core.aggregators as tagg
import repro_torch.core.graph as tgraph
from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core.device_engine import (DeviceEngine, _masked_pairs,
                                            propagate_monotonic)
from repro_torch.core.full import full_inference
from repro_torch.core.graph import EdgeUpdate, FeatureUpdate, UpdateBatch
from repro_torch.core.state import InferenceState as TState
from repro_torch.core.workloads import MONOTONIC_WORKLOAD_NAMES
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy

ATOL = 2e-3
AGGS = {"max": (ragg.MAX, tagg.MAX), "min": (ragg.MIN, tagg.MIN)}


# ---------------------------------------------------------------------------
# aggregator primitives
# ---------------------------------------------------------------------------
def test_aggregator_registry():
    for name, (_, agg) in AGGS.items():
        assert tagg.get_aggregator(name) is agg
        assert agg.algebra == "monotonic"
    assert tagg.MAX.identity == -np.inf and tagg.MIN.identity == np.inf
    x = torch.tensor([[1.0, -np.inf, np.inf, -2.0]])
    assert torch.equal(tagg.MAX.normalize(x, None),
                       torch.tensor([[1.0, 0.0, 0.0, -2.0]]))


def _extremum_case(seed, E=40, n_rows=6, d=4):
    """Values from a small integer set (many ties, as ReLU zeros make them)
    with some padding lanes (seg == n_rows)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2, 3, size=(E, d)).astype(np.float32)
    seg = rng.integers(0, n_rows + 1, size=E)
    src = rng.integers(0, 1 << 26, size=E)   # ids beyond float32's 2^24
    base = rng.integers(-2, 3, size=(n_rows, d)).astype(np.float32)
    base[0] = np.inf   # an identity row of either sign
    base[1] = -np.inf
    base_refs = rng.integers(0, 50, size=(n_rows, d)).astype(np.int32)
    return vals, seg, src, base, base_refs


@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("with_base", [False, True])
def test_segment_extremum_matches_reference(agg, pairs, with_base):
    """S bit-equal and C exactly equal to ``jnp_segment_extremum``: the
    same tie rule (the largest winning src id), in the 2-D and the 1-D
    pair form, with and without base folding."""
    ref_agg, t_agg = AGGS[agg]
    vals, seg, src, base, base_refs = _extremum_case(3)
    if pairs:
        vals, base, base_refs = vals[:, 0], base[:, 0], base_refs[:, 0]
    kw_j, kw_t = {}, {}
    if with_base:
        kw_j = dict(base=jnp.asarray(base), base_refs=jnp.asarray(base_refs))
        kw_t = dict(base=torch.as_tensor(base),
                    base_refs=torch.as_tensor(base_refs))
    S_j, C_j = ragg.jnp_segment_extremum(ref_agg, jnp.asarray(vals),
                                         jnp.asarray(seg), 6,
                                         jnp.asarray(src, dtype=jnp.int32),
                                         **kw_j)
    S_t, C_t = tagg.segment_extremum(t_agg, torch.as_tensor(vals),
                                     torch.as_tensor(seg), 6,
                                     torch.as_tensor(src), **kw_t)
    np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
    np.testing.assert_array_equal(C_t.numpy(), np.asarray(C_j))
    assert C_t.dtype == torch.int32


def test_segment_extremum_ids_beyond_float32():
    """Witness ids above 2^24 stay exact (the reduction runs in int64)."""
    vals = torch.tensor([1.0, 1.0, 0.5])
    src = torch.tensor([(1 << 24) + 1, (1 << 24) + 3, 7])
    S, C = tagg.segment_extremum(tagg.MAX, vals, torch.tensor([0, 0, 0]), 1,
                                 src)
    assert S.tolist() == [1.0] and C.tolist() == [(1 << 24) + 3]


@pytest.mark.parametrize("agg", ["max", "min"])
def test_host_primitives_match_reference(agg):
    """The NumPy copies give what the reference's give."""
    ref_agg, t_agg = AGGS[agg]
    vals, seg, src, base, base_refs = _extremum_case(5)
    ok = seg < 6
    for kw in ({}, dict(base=base, base_refs=base_refs)):
        for a, b in zip(tagg.np_segment_extremum(t_agg, vals[ok], seg[ok], 6,
                                                 src[ok], **kw),
                        ragg.np_segment_extremum(ref_agg, vals[ok], seg[ok],
                                                 6, src[ok], **kw)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    C_rows = rng.integers(0, 4, size=(12, 4)).astype(np.int32)
    S_rows = rng.normal(size=(12, 4)).astype(np.float32)
    msrc, mvals = rng.integers(0, 4, size=12), rng.normal(size=(12, 4))
    is_del = rng.random(12) < 0.3
    np.testing.assert_array_equal(
        tagg.np_shrink_dims(t_agg, C_rows, S_rows, msrc, mvals, is_del),
        ragg.np_shrink_dims(ref_agg, C_rows, S_rows, msrc, mvals, is_del))
    g = DynamicGraph(30, *erdos_renyi(30, 120, seed=2))
    H = [rng.integers(-1, 2, size=(30, 4)).astype(np.float32)
         for _ in range(2)]
    S = [np.empty(0)] + [np.asarray(ragg.MAX.segment_jnp(
        jnp.asarray(H[0][g.coo()[0]]), jnp.asarray(g.coo()[1]), 30))]
    for a, b in zip(tagg.compute_contributors(t_agg, H, S, g),
                    ragg.compute_contributors(ref_agg, H, S, g)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [3, 8, 64])
def test_masked_pairs_row_major_and_truncated(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((9, 5)) < 0.3
    pr, pdim = _masked_pairs(torch.as_tensor(mask), cap, 9)
    rows, dims = np.nonzero(mask)
    k = min(cap, rows.size)
    np.testing.assert_array_equal(pr[:k].numpy(), rows[:k])
    np.testing.assert_array_equal(pdim[:k].numpy(), dims[:k])
    assert (pr[k:] == 9).all() and (pdim[k:] == 0).all()


# ---------------------------------------------------------------------------
# bootstrap against the reference
# ---------------------------------------------------------------------------
def _both(name, n=60, m=260, n_layers=2, seed=0):
    """The reference's and the port's (workload, params, graph, state) on
    the same graph, features and weights."""
    wl = make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                       n_classes=5)
    params = wl.init_params(jax.random.PRNGKey(seed))
    src, dst, w = erdos_renyi(n, m, seed=seed)
    x = np.random.default_rng(seed + 1).normal(size=(n, 8)).astype(
        np.float32)
    g = DynamicGraph(n, src, dst, w)
    twl = t_make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                          n_classes=5)
    layers = params_from_numpy(twl, params_to_numpy(params), "cpu")
    tg = tgraph.DynamicGraph(n, src, dst, w)
    return ((wl, params, g, InferenceState.bootstrap(wl, params, x, g)),
            (twl, layers, tg, TState.bootstrap(twl, layers, x, tg,
                                               device="cpu")))


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
@pytest.mark.parametrize("n_layers", [2, 3])
def test_bootstrap_matches_reference(name, n_layers):
    (_, _, _, ref), (_, _, _, got) = _both(name, n=120, m=600,
                                           n_layers=n_layers)
    for l, (a, b) in enumerate(zip(ref.H, got.H)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=ATOL,
                                   err_msg=f"H[{l}]")
    # a max/min over the unchanged features involves no rounding
    np.testing.assert_array_equal(got.S[1], ref.S[1])
    np.testing.assert_array_equal(got.C[1], ref.C[1])
    assert not np.isfinite(got.S[1][got.k == 0]).any()
    _assert_witnesses(got)


def _assert_witnesses(state, graph=None):
    """S[l][v,d] == H[l-1][C[l][v,d], d] wherever C >= 0, identity where
    C == -1, and (given the graph) contributors are in-neighbors."""
    for l in range(1, len(state.S)):
        C, S, H_prev = state.C[l], state.S[l], state.H[l - 1]
        rows, dims = np.nonzero(C >= 0)
        np.testing.assert_array_equal(H_prev[C[rows, dims], dims],
                                      S[rows, dims],
                                      err_msg=f"layer {l} witness broken")
        assert not np.isfinite(S[C < 0]).any(), f"layer {l}"
        if graph is not None:
            for v in np.unique(rows)[:8]:
                nbrs = set(graph.in_nbrs(int(v))[0].tolist())
                assert set(C[v][C[v] >= 0].tolist()) <= nbrs


# ---------------------------------------------------------------------------
# the device engine against the reference's, batch for batch
# ---------------------------------------------------------------------------
def _plan(g, rng, n_batches=8, d0=8):
    """A stream as plain tuples: adds of absent edges, deletes of present
    ones (every delete may be a SHRINK) and a feature update per batch."""
    src, dst, _ = g.coo()
    edges = set(zip(src.tolist(), dst.tolist()))
    plan = []
    for _ in range(n_batches):
        items = []
        for _ in range(2):
            u, v = (int(a) for a in rng.integers(0, g.n, size=2))
            if u != v and (u, v) not in edges:
                edges.add((u, v))
                items.append(("e", u, v, True))
        for _ in range(2):
            u, v = sorted(edges)[int(rng.integers(0, len(edges)))]
            edges.discard((u, v))
            items.append(("e", u, v, False))
        items.append(("f", int(rng.integers(0, g.n)),
                      rng.normal(size=d0).astype(np.float32)))
        plan.append(items)
    return plan


def _batch(items, mod):
    b = mod.UpdateBatch()
    for it in items:
        if it[0] == "e":
            b.edges.append(mod.EdgeUpdate(it[1], it[2], it[3]))
        else:
            b.features.append(mod.FeatureUpdate(it[1], it[2].copy()))
    return b


def _counters(eng):
    return (eng.last_shrink_events, eng.last_rows_reaggregated,
            eng.last_dims_reaggregated, eng.last_recover_hits)


@pytest.mark.parametrize("name,pull,n_layers", [
    ("gs-max", "rows", 2), ("gs-max", "pairs", 2),
    ("gc-min", "rows", 2), ("gc-min", "pairs", 2),
    ("gs-max", "pairs", 3)])
def test_matches_reference_device_engine(name, pull, n_layers):
    """Same stream through both packages, in the same pull regime: the
    reference runs rows with its Pallas kernels in interpret mode and
    pairs through its plain path (``interpret = False`` set after
    construction); per batch the affected ids and the four counters are
    equal, retries too, and at the end H is within 1e-4 and C holds the
    witness invariant."""
    (wl, params, g, ref_state), (twl, layers, tg, state) = _both(
        name, n_layers=n_layers)
    ref = RefDeviceEngine(wl, params, g, ref_state, min_bucket=16,
                          use_pallas=pull == "rows")
    ref.interpret = pull == "rows"
    port = DeviceEngine(twl, layers, tg, state, device="cpu", min_bucket=16,
                        pull=pull)
    shrinks = 0
    for step, items in enumerate(_plan(g, np.random.default_rng(9))):
        a_ref = ref.apply_batch(_batch(items, rgraph))
        a_port = port.apply_batch(_batch(items, tgraph))
        np.testing.assert_array_equal(a_port, a_ref, err_msg=f"step {step}")
        assert _counters(port) == _counters(ref), f"step {step}"
        shrinks += port.last_shrink_events
    assert shrinks > 0
    assert port.retries == ref.retries
    for l, (h, href) in enumerate(zip(port.host_H(), ref.host_H())):
        np.testing.assert_allclose(h, href, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} layer {l}")
    host = TState(H=port.host_H(), S=[s[:port.n].numpy() for s in
                                      port.state.S],
                  k=tg.in_degree, C=[c[:port.n].numpy() for c in
                                     port.state.C])
    _assert_witnesses(host, tg)


# ---------------------------------------------------------------------------
# the reference's contracts on the port
# ---------------------------------------------------------------------------
def _session(name, engine="device", n=40, m=170, seed=0, **over):
    cfg = dict(workload=name, engine=engine, graph="er", n=n, m=m, d_in=8,
               d_hidden=12, n_classes=5, seed=seed, device="cpu")
    cfg.update(over)
    return InferenceSession.build(SessionConfig(**cfg))


def _assert_exact(session, label=""):
    st = session.sync()
    H, S = full_inference(session.workload, session.params,
                          torch.as_tensor(st.H[0]), *session.graph.coo(),
                          session.graph.in_degree)
    for l, (h, href) in enumerate(zip(st.H, H)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=f"{label} layer {l}")
    return S


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
@pytest.mark.parametrize("engine", ["device", "full"])
def test_random_stream_matches_oracle(name, engine):
    s = _session(name, engine)
    for step, items in enumerate(_plan(s.graph, np.random.default_rng(11),
                                       n_batches=5)):
        s.ingest(_batch(items, tgraph))
        _assert_exact(s, f"{name}/{engine} step {step}")
    _assert_witnesses(s.sync(), s.graph)


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
def test_delete_the_argmax(name):
    """Adversarial SHRINK: delete exactly the tracked contributor's edge."""
    s = _session(name)
    rng = np.random.default_rng(3)
    shrinks = 0
    for _ in range(6):
        C1 = s.sync().C[1]
        rows = np.nonzero((C1 >= 0).any(axis=1))[0]
        v = int(rows[rng.integers(0, rows.size)])
        dims = np.nonzero(C1[v] >= 0)[0]
        u = int(C1[v][dims[rng.integers(0, dims.size)]])
        assert s.graph.has_edge(u, v)
        res = s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, False)]))
        shrinks += res.results[0].shrink_events
        _assert_exact(s, f"{name} delete argmax ({u}->{v})")
    assert shrinks > 0


def _one_dim_argmax_victim(session):
    """(v, u, dim): u is v's tracked layer-1 contributor in exactly one
    dim, so deleting the edge u->v shrinks exactly one cell."""
    C1 = session.sync().C[1]
    for v in range(C1.shape[0]):
        refs = C1[v]
        if (refs < 0).all():
            continue
        uniq, counts = np.unique(refs[refs >= 0], return_counts=True)
        for u, c in zip(uniq, counts):
            if c == 1 and session.graph.has_edge(int(u), int(v)):
                return int(v), int(u), int(np.nonzero(refs == u)[0][0])
    return None


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("pull", ["rows", "pairs"])
def test_per_dim_shrink_gathers_only_touched_dims(name, donate, pull):
    """Deleting the argmax edge of exactly one dim re-derives exactly that
    cell, bit-exact; a same-batch candidate that beats the lost extremum
    re-witnesses a shrunk cell with no gather (the re-cover probe).  One
    hop, so the counters are exact."""
    s = _session(name, n_layers=1, engine_options={"donate": donate})
    s.engine.impl.pull = pull
    v, u, _ = _one_dim_argmax_victim(s)
    r = s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, False)])).results[0]
    S_ref = _assert_exact(s, f"{name} one-dim shrink")
    np.testing.assert_array_equal(s.sync().S[1], S_ref[1].numpy())
    assert r.shrink_events >= 1
    assert (r.rows_reaggregated, r.dims_reaggregated, r.recover_hits) \
        == (1, 1, 0)

    victim2 = _one_dim_argmax_victim(s)
    if victim2 is None:
        return
    v2, u2, _ = victim2
    sign = 1.0 if s.workload.spec.aggregator == "max" else -1.0
    g = s.graph
    w = next(x for x in range(g.n)
             if x not in (v2, u2) and not g.has_edge(x, v2))
    r2 = s.ingest(UpdateBatch(
        features=[FeatureUpdate(w, np.full(8, sign * 100.0, np.float32))],
        edges=[EdgeUpdate(u2, v2, False), EdgeUpdate(w, v2, True)]
    )).results[0]
    _assert_exact(s, f"{name} re-cover probe")
    assert r2.shrink_events >= 1 and r2.recover_hits >= 1
    assert r2.dims_reaggregated == 0


@pytest.mark.parametrize("pull", ["rows", "pairs"])
def test_delete_last_in_edge_empties_row(pull):
    """Removing a vertex's only in-edge falls back to the identity
    aggregate (read as 0 through normalize) and clears the contributor."""
    s = _session("gs-max")
    s.engine.impl.pull = pull
    g = s.graph
    v = int(np.argmin(g.in_degree))
    u = (v + 1) % g.n
    if not g.has_edge(u, v):
        s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, True)]))
    others = [int(x) for x in g.in_nbrs(v)[0] if int(x) != u]
    if others:
        s.ingest(UpdateBatch(edges=[EdgeUpdate(x, v, False)
                                    for x in others]))
    assert g.in_degree[v] == 1
    s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, False)]))
    st = s.sync()
    assert st.k[v] == 0
    assert np.all(st.C[1][v] == -1)
    assert not np.isfinite(st.S[1][v]).any()
    _assert_exact(s, "empty-row fallback")


def test_swap_engine_roundtrips_tracked_state():
    """device -> full -> device mid-stream: the contributor refs travel
    with the state (the full engine re-derives them) and the stream ends
    where a device-only session ends."""
    a = _session("gs-max", n=60, m=260)
    b = _session("gs-max", n=60, m=260)
    ua = list(a.make_stream(24, seed=1))
    ub = list(b.make_stream(24, seed=1))
    a.ingest(ua, batch_size=4)
    b.ingest(ub[:8], batch_size=4)
    _assert_witnesses(b.sync(), b.graph)
    b.swap_engine("full")
    b.ingest(ub[8:16], batch_size=4)
    _assert_witnesses(b.sync(), b.graph)
    b.swap_engine("device")
    b.ingest(ub[16:], batch_size=4)
    for l, (ha, hb) in enumerate(zip(a.sync().H, b.sync().H)):
        np.testing.assert_allclose(ha, hb, atol=ATOL, rtol=ATOL,
                                   err_msg=f"swap layer {l}")
    _assert_witnesses(b.sync(), b.graph)
    _assert_exact(b, "post-swap")


def _engine(name, **opts):
    _, (twl, layers, tg, state) = _both(name, n=64, m=700)
    opts.setdefault("min_bucket", 16)
    return DeviceEngine(twl, layers, tg, state, device="cpu", **opts)


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("pull", ["rows", "pairs"])
def test_overflow_commits_nothing(donate, pull):
    """An overflowing attempt leaves H, S, C and k bit-identical, updated
    in place or not."""
    eng = _engine("gs-max", warm=False)
    rng = np.random.default_rng(0)
    dev_batch, _, _ = eng._route(UpdateBatch(features=[
        FeatureUpdate(int(v), rng.normal(size=8).astype(np.float32))
        for v in rng.choice(eng.n, size=16, replace=False)]))
    before = eng.state.clone()
    new_state, report = propagate_monotonic(
        eng.workload, eng.n, ((4, 4, 4, 4),) * 2, eng.params, eng.state,
        eng.out_mirror.csr(), eng.in_mirror.csr(), dev_batch,
        donate=donate, pull=pull)
    overflow, _, _, final = eng._read(report)
    assert overflow
    for a, b in zip(new_state.H + new_state.S + new_state.C + (new_state.k,),
                    before.H + before.S + before.C + (before.k,)):
        assert torch.equal(a[:eng.n], b[:eng.n])
    assert np.all(final == eng.n)


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
def test_donated_matches_fresh(name):
    don = _engine(name, donate=True)
    ref = _engine(name, donate=False)
    for items in _plan(don.graph, np.random.default_rng(9)):
        np.testing.assert_array_equal(don.apply_batch(_batch(items, tgraph)),
                                      ref.apply_batch(_batch(items, tgraph)))
        assert _counters(don) == _counters(ref)
    for l, (h1, h2) in enumerate(zip(don.host_H(), ref.host_H())):
        np.testing.assert_allclose(h1, h2, atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name} layer {l}")
    for c1, c2 in zip(don.state.C, ref.state.C):
        assert torch.equal(c1, c2)


def test_async_matches_sync():
    asy = _engine("gs-max", async_dispatch=True, debug_checks=True)
    ref = _engine("gs-max")
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
                                   err_msg=f"layer {l}")
    assert asy.in_mirror.uploads == 1 and asy.in_mirror.row_refreshes > 0
