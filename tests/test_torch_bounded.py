"""The port's bounded-recompute family (attention / top-k / PNA) against the
JAX package: the aggregator primitives and certified bounds, bootstrap,
the ``embedding_bag`` plain version against the Pallas kernel, the
``device`` engine batch for batch, and the reference's bounded contracts
(tests/test_bounded.py, tests/test_device_engine.py) on the port."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core.aggregators as ragg
import repro.core.graph as rgraph
from repro.core import (DynamicGraph, InferenceState, erdos_renyi,
                        make_workload, params_to_numpy)
from repro.core.device_engine import DeviceEngine as RefDeviceEngine
from repro.core.workloads import Workload as RWorkload
from repro.core.workloads import WorkloadSpec as RWorkloadSpec
from repro.kernels.embedding_bag import embedding_bag_pallas

import repro_torch.core.aggregators as tagg
import repro_torch.core.graph as tgraph
from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core.device_engine import DeviceEngine, propagate_bounded
from repro_torch.core.full import bounded_aux, full_inference
from repro_torch.core.graph import EdgeUpdate, FeatureUpdate, UpdateBatch
from repro_torch.core.state import InferenceState as TState
from repro_torch.core.workloads import BOUNDED_WORKLOAD_NAMES
from repro_torch.core.workloads import Workload as TWorkload
from repro_torch.core.workloads import WorkloadSpec as TWorkloadSpec
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy
from repro_torch.kernels.embedding_bag import embedding_bag

ATOL = 2e-3          # engine vs oracle, as tests/test_bounded.py
AUX_TOL = 1e-5       # one reaggregation against another on the same input
AGGS = {"attn": (ragg.ATTN, tagg.ATTN), "topk": (ragg.TOPK, tagg.TOPK),
        "pna": (ragg.PNA, tagg.PNA)}


# ---------------------------------------------------------------------------
# aggregator primitives
# ---------------------------------------------------------------------------
def test_aggregator_registry():
    for name, (ref, agg) in AGGS.items():
        assert tagg.get_aggregator(name) is agg
        assert agg.algebra == "bounded" and agg.tracks_aux
        assert agg.aux_names == ref.aux_names
        assert agg.x_multiplier == ref.x_multiplier
        for nm, a in agg.init_aux(5, 3).items():
            b = ref.init_aux(5, 3)[nm]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tagg.SUM.x_multiplier == 1 and not tagg.MAX.tracks_aux


def _reagg_case(seed, ties, E=60, n_rows=7, d=5, n_src=30):
    """Gathered in-neighbour values with padding lanes (seg == n_rows); with
    ``ties`` the values come from a small integer set, as ReLU zeros make
    them."""
    rng = np.random.default_rng(seed)
    if ties:
        H = rng.integers(-2, 3, size=(n_src, d)).astype(np.float32)
    else:
        H = rng.normal(size=(n_src, d)).astype(np.float32)
    src = rng.integers(0, n_src, size=E)
    seg = rng.integers(0, n_rows + 1, size=E)
    seg[:3] = 0                     # a row with enough lanes for top-k
    seg[-1] = n_rows                # padding
    k = np.bincount(seg[seg < n_rows], minlength=n_rows).astype(np.float32)
    return H, src, seg, k


@pytest.mark.parametrize("name", list(AGGS))
@pytest.mark.parametrize("ties", [False, True])
def test_reaggregate_matches_reference(name, ties):
    """The torch reaggregate against ``jnp_reaggregate`` on the same padded
    inputs (x and every aux array within 1e-5, ``mref`` and ``theta``
    exact), and the NumPy copy against the reference's ``np_reaggregate``
    exactly; ``mref`` against the host's only where the witness is
    unique, since the host keeps the last writer among ties."""
    ref, agg = AGGS[name]
    H, src, seg, k = _reagg_case(7, ties)
    n_rows = k.shape[0]
    x_t, aux_t = agg.reaggregate(torch.as_tensor(H[src]),
                                 torch.as_tensor(src), torch.as_tensor(seg),
                                 n_rows, torch.as_tensor(k))
    x_j, aux_j = ref.jnp_reaggregate(jnp.asarray(H[src]),
                                     jnp.asarray(src, dtype=jnp.int32),
                                     jnp.asarray(seg), n_rows, jnp.asarray(k))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=AUX_TOL,
                               rtol=AUX_TOL)
    for nm, a, b in zip(agg.aux_names, aux_t, aux_j):
        if nm in ("mref", "theta"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=nm)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=AUX_TOL, rtol=AUX_TOL,
                                       err_msg=nm)
    ok = seg < n_rows
    x_n, aux_n = agg.np_reaggregate(H, src[ok], seg[ok], n_rows, k)
    x_r, aux_r = ref.np_reaggregate(H, src[ok], seg[ok], n_rows, k)
    np.testing.assert_array_equal(x_n, x_r)
    for nm in agg.aux_names:
        np.testing.assert_array_equal(aux_n[nm], aux_r[nm], err_msg=nm)
    np.testing.assert_allclose(x_t.numpy(), x_n, atol=AUX_TOL, rtol=AUX_TOL)
    for nm, a in zip(agg.aux_names, aux_t):
        if nm == "mref":
            rows, dims = np.nonzero(aux_n["mx"] > -np.inf)
            np.testing.assert_array_equal(H[a.numpy()[rows, dims], dims],
                                          aux_n["mx"][rows, dims])
            if not ties:
                np.testing.assert_array_equal(a.numpy(), aux_n[nm])
        else:
            np.testing.assert_allclose(a.numpy(), aux_n[nm], atol=AUX_TOL,
                                       rtol=AUX_TOL, err_msg=nm)


def test_topk_passes_match_reference():
    H, src, seg, _ = _reagg_case(3, ties=True)
    for kk in (1, 3, 5):
        x_t, th_t = tagg.topk_passes(torch.as_tensor(H[src]),
                                     torch.as_tensor(seg), 7, kk)
        x_j, th_j = ragg._jnp_topk_passes(jnp.asarray(H[src]),
                                          jnp.asarray(seg), 7, kk)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))


# ---------------------------------------------------------------------------
# bootstrap and certified bounds against the reference
# ---------------------------------------------------------------------------
def _topk_specs():
    """Top-k has no named workload: the reference's hand-built spec
    (tests/test_bounded.py) in both packages."""
    kw = dict(name="gc-topk", aggregator="topk", self_dependent=False,
              n_layers=2, dims=(8, 12, 5))
    return (RWorkload(spec=RWorkloadSpec(**kw), family="gc"),
            TWorkload(spec=TWorkloadSpec(**kw), family="gc"))


def _workloads(name, n_layers=2):
    if name == "topk":
        return _topk_specs()
    return (make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                          n_classes=5),
            t_make_workload(name, n_layers=n_layers, d_in=8, d_hidden=12,
                            n_classes=5))


def _both(name, n=60, m=260, n_layers=2, seed=0):
    """The reference's and the port's (workload, params, graph, state) on
    the same graph, features and weights."""
    import jax
    wl, twl = _workloads(name, n_layers)
    params = wl.init_params(jax.random.PRNGKey(seed))
    src, dst, w = erdos_renyi(n, m, seed=seed)
    x = np.random.default_rng(seed + 1).normal(size=(n, 8)).astype(
        np.float32)
    g = DynamicGraph(n, src, dst, w)
    layers = params_from_numpy(twl, params_to_numpy(params), "cpu")
    tg = tgraph.DynamicGraph(n, src, dst, w)
    return ((wl, params, g, InferenceState.bootstrap(wl, params, x, g)),
            (twl, layers, tg, TState.bootstrap(twl, layers, x, tg,
                                               device="cpu")))


def _assert_witnesses(A, H, graph):
    """PNA's tracked max: ``H[l-1][mref[v,d], d] == mx[v,d]`` wherever
    mref >= 0, -inf where it is -1, and every witness an in-neighbour."""
    for l in range(1, len(A)):
        mref, mx = A[l]["mref"], A[l]["mx"]
        rows, dims = np.nonzero(mref >= 0)
        np.testing.assert_array_equal(H[l - 1][mref[rows, dims], dims],
                                      mx[rows, dims], err_msg=f"layer {l}")
        assert not np.isfinite(mx[mref < 0]).any()
        for v in np.unique(rows)[:8]:
            nbrs = set(graph.in_nbrs(int(v))[0].tolist())
            assert set(mref[v][mref[v] >= 0].tolist()) <= nbrs


@pytest.mark.parametrize("name", list(BOUNDED_WORKLOAD_NAMES) + ["topk"])
def test_bootstrap_matches_reference(name):
    """H, S and A within 2e-3 of the reference's bootstrap (its A is the
    host's ``compute_bounded_aux``, the port's the device reaggregation);
    ``mref`` equals the device tie rule (the reference's
    ``jnp_reaggregate`` on the port's own H), and the port's NumPy
    ``compute_bounded_aux`` equals the reference's on the same H."""
    (wl, _, g, ref), (twl, _, tg, got) = _both(name)
    for l, (a, b) in enumerate(zip(ref.H, got.H)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=ATOL,
                                   err_msg=f"H[{l}]")
    for l in range(1, len(ref.S)):
        np.testing.assert_allclose(got.S[l], ref.S[l], atol=ATOL, rtol=ATOL,
                                   err_msg=f"S[{l}]")
        for nm in twl.agg.aux_names:
            a, b = got.A[l][nm], ref.A[l][nm]
            assert a.dtype == b.dtype and a.shape == b.shape, nm
            if nm == "mref":
                continue
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL,
                                       err_msg=f"A[{l}][{nm}]")
    np.testing.assert_array_equal(got.eps, ref.eps)
    src, dst, _ = tg.coo()
    for l in range(1, len(got.H)):
        _, aux_j = wl.agg.jnp_reaggregate(
            jnp.asarray(got.H[l - 1][src]), jnp.asarray(src, jnp.int32),
            jnp.asarray(dst), tg.n, jnp.asarray(tg.in_degree))
        for nm, a in zip(twl.agg.aux_names, aux_j):
            if nm in ("mref", "theta"):
                np.testing.assert_array_equal(got.A[l][nm], np.asarray(a))
    for a, b in zip(tagg.compute_bounded_aux(twl.agg, got.H, tg),
                    ragg.compute_bounded_aux(wl.agg, got.H, g)):
        for nm in a:
            np.testing.assert_array_equal(a[nm], b[nm], err_msg=nm)
    if name == "gp-m":
        _assert_witnesses(got.A, got.H, tg)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_certified_bounds_match_reference(name):
    """Same NumPy arithmetic: the Lipschitz constants, the certified error
    recursion and, with one interior layer, the deferral budgets equal the
    reference's to 1e-12."""
    (wl, params, _, _), (twl, layers, _, _) = _both(name, n_layers=2)
    p_np = params_to_numpy(params)
    eps = np.array([0.0, 3e-3, 0.0])
    M = np.array([2.0, 3.5, 4.0])
    assert tagg.workload_lipschitz(twl, p_np) \
        == pytest.approx(ragg.workload_lipschitz(wl, p_np), abs=1e-12)
    for kmax in (0.0, 7.0):
        np.testing.assert_allclose(
            tagg.certified_error_bound(twl, p_np, eps, M, kmax),
            ragg.certified_error_bound(wl, p_np, eps, M, kmax),
            atol=1e-12, rtol=1e-12)
        for tol in (0.0, 1e-3, 1e-1):
            np.testing.assert_allclose(
                tagg.deferral_budgets(twl, p_np, eps, M, kmax, tol),
                ragg.deferral_budgets(wl, p_np, eps, M, kmax, tol),
                atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_deferral_budgets_hold_jointly(name):
    """With two interior layers the reference budgets each layer as if the
    other stayed at its eps, and deferring up to both budgets in one batch
    certifies more than the tolerance; the port's budgets never exceed the
    reference's, never fall below eps, and keep the bound with every layer
    at its budget within the tolerance."""
    (wl, params, _, _), (twl, _, _, _) = _both(name, n_layers=3)
    p_np = params_to_numpy(params)
    M = np.array([2.0, 3.5, 4.0, 5.0])
    tol = 1e-1
    start = tagg.deferral_budgets(twl, p_np, np.zeros(4), M, 7.0, tol)
    for eps in (np.zeros(4), start / 4):
        ref = ragg.deferral_budgets(wl, p_np, eps, M, 7.0, tol)
        got = tagg.deferral_budgets(twl, p_np, eps, M, 7.0, tol)
        joint = lambda t: tagg.certified_error_bound(  # noqa: E731
            twl, p_np, np.maximum(eps, t), M, 7.0)[-1]
        assert joint(ref) > tol * (1 + 1e-3)
        assert joint(got) <= tol
        assert np.all(got <= ref) and np.all(got >= eps)
        assert np.all(got[1:3] > eps[1:3])


# ---------------------------------------------------------------------------
# embedding_bag's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V,B,hot,d", [(100, 8, 1, 16), (1000, 32, 4, 64),
                                       (5000, 16, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_matches_pallas(V, B, hot, d, dtype):
    """tests/test_kernels.py's sweep and bars: 1e-5 in fp32, 2e-2 in bf16
    (the reference sums in bf16, the port in fp32 with one rounding)."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, hot)).astype(np.int32)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    out_j = embedding_bag_pallas(jnp.asarray(idx),
                                 jnp.asarray(table, getattr(jnp, dtype)),
                                 interpret=True)
    t_table = torch.as_tensor(table).to(getattr(torch, dtype))
    out_t = embedding_bag(t_table, torch.as_tensor(idx))
    assert out_t.dtype == t_table.dtype and out_t.shape == (B, d)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("V,R,hot,d", [(64, 16, 8, 16), (200, 48, 12, 32)])
def test_embedding_bag_engine_pattern(V, R, hot, d):
    """The engine's gather: a left-packed [R, hot] id rectangle padded with
    sentinel V, a zero row at V; with and without ``padding_idx`` the bag
    sum equals the Pallas kernel's (1e-5).  An index outside the table
    raises."""
    rng = np.random.default_rng(1)
    table = np.concatenate([rng.normal(size=(V, d)),
                            np.zeros((1, d))]).astype(np.float32)
    idx = np.full((R, hot), V, dtype=np.int32)
    for r, deg in enumerate(rng.integers(0, hot + 1, size=R)):
        idx[r, :deg] = rng.integers(0, V, size=deg)
    ref = np.asarray(embedding_bag_pallas(jnp.asarray(idx),
                                          jnp.asarray(table),
                                          interpret=True))
    for pad in (None, V):
        out = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                            padding_idx=pad)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    idx[0, 0] = V + 1
    with pytest.raises(IndexError):
        embedding_bag(torch.as_tensor(table), torch.as_tensor(idx))


# ---------------------------------------------------------------------------
# the device engine against the reference's, batch for batch
# ---------------------------------------------------------------------------
def _plan(g, rng, n_batches=6, d0=8):
    """A stream as plain tuples: adds of absent edges, a delete of a
    present one and two feature updates per batch."""
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
        u, v = sorted(edges)[int(rng.integers(0, len(edges)))]
        edges.discard((u, v))
        items.append(("e", u, v, False))
        for _ in range(2):
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
    return (eng.last_rows_reaggregated, eng.last_deferred_rows,
            eng.last_bound_violations, eng.last_patch_events)


@pytest.mark.parametrize("name,use_pallas", [
    ("ga-s", False), ("gp-m", True), ("gp-m", False), ("topk", False)])
def test_matches_reference_device_engine(name, use_pallas):
    """Same stream through both packages: per batch the affected ids and
    the counters are equal (the frontier filter compares bits, and no row
    changes by rounding alone in either package here), H within 2e-3.
    The port always checks PNA's rectangle width, as the reference does on
    its Pallas route only, so retries and per-hop needed sizes are held to
    the reference with ``use_pallas=True``."""
    (wl, params, g, ref_state), (twl, layers, tg, state) = _both(name)
    ref = RefDeviceEngine(wl, params, g, ref_state, min_bucket=16,
                          use_pallas=use_pallas)
    port = DeviceEngine(twl, layers, tg, state, device="cpu", min_bucket=16)
    reagg = 0
    for step, items in enumerate(_plan(g, np.random.default_rng(9))):
        np.testing.assert_array_equal(
            port.apply_batch(_batch(items, tgraph)),
            ref.apply_batch(_batch(items, rgraph)), err_msg=f"step {step}")
        assert _counters(port) == _counters(ref), f"step {step}"
        for l, (h, href) in enumerate(zip(port.host_H(), ref.host_H())):
            np.testing.assert_allclose(h, href, atol=ATOL, rtol=ATOL,
                                       err_msg=f"step {step} layer {l}")
        reagg += port.last_rows_reaggregated
    assert reagg > 0
    if use_pallas or name != "gp-m":
        assert port.retries == ref.retries
        np.testing.assert_array_equal(port._hw, np.asarray(ref._hw))


# ---------------------------------------------------------------------------
# the reference's contracts on the port
# ---------------------------------------------------------------------------
def _session(name, engine="device", n=40, m=170, seed=0, **over):
    cfg = dict(workload=name, engine=engine, graph="er", n=n, m=m, d_in=8,
               d_hidden=12, n_classes=5, seed=seed, device="cpu")
    cfg.update(over)
    return InferenceSession.build(SessionConfig(**cfg))


def _oracle(session):
    st = session.sync()
    H, S = full_inference(session.workload, session.params,
                          torch.as_tensor(st.H[0]), *session.graph.coo(),
                          session.graph.in_degree)
    return [h.numpy() for h in H]


def _assert_exact(session, label=""):
    for l, (h, href) in enumerate(zip(session.sync().H, _oracle(session))):
        np.testing.assert_allclose(h, href, atol=ATOL, rtol=ATOL,
                                   err_msg=f"{label} layer {l}")


def _assert_aux_current(session, label=""):
    """The state's A equals a fresh device reaggregation over the current
    graph and H (2e-3; maxima bit-equal, PNA witnesses exact)."""
    st = session.sync()
    src, dst, _ = session.graph.coo()
    fresh = bounded_aux(session.workload,
                        [torch.as_tensor(h) for h in st.H], src, dst)
    for l in range(1, len(st.H)):
        for nm, ref in fresh[l].items():
            got = st.A[l][nm]
            if nm in ("m", "mx", "theta"):
                np.testing.assert_array_equal(got, ref.numpy(),
                                              err_msg=f"{label} A[{l}] {nm}")
            elif nm != "mref":
                np.testing.assert_allclose(got, ref.numpy(), atol=ATOL,
                                           rtol=ATOL,
                                           err_msg=f"{label} A[{l}] {nm}")
    if "mref" in session.workload.agg.aux_names:
        _assert_witnesses(st.A, st.H, session.graph)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
@pytest.mark.parametrize("engine", ["device", "full"])
def test_random_stream_matches_oracle(name, engine):
    s = _session(name, engine)
    for step, items in enumerate(_plan(s.graph, np.random.default_rng(13),
                                       n_batches=4)):
        s.ingest(_batch(items, tgraph))
        _assert_exact(s, f"{name}/{engine} step {step}")
    _assert_aux_current(s, f"{name}/{engine}")
    assert float(s.engine.error_bound().max()) == 0.0


def test_delete_the_dominant_logit():
    """Attention's worst case: boost one in-neighbour's logit until it
    dominates a row's softmax, then delete exactly that edge; the row must
    re-aggregate to the oracle's value."""
    s = _session("ga-s")
    rng = np.random.default_rng(5)
    for round_ in range(4):
        st = s.sync()
        rows = np.nonzero(s.graph.in_degree >= 3)[0]
        v = int(rows[rng.integers(0, rows.size)])
        nbrs, _ = s.graph.in_nbrs(v)
        u = int(nbrs[np.argmax(st.H[0][nbrs].sum(axis=1))])
        s.ingest(UpdateBatch(features=[
            FeatureUpdate(u, np.full(8, 6.0, dtype=np.float32))]))
        _assert_exact(s, f"round {round_} boost")
        s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, False)]))
        _assert_exact(s, f"round {round_} delete-dominant")


def _engine(name, **opts):
    _, (twl, layers, tg, state) = _both(name, n=64, m=700)
    opts.setdefault("min_bucket", 16)
    return DeviceEngine(twl, layers, tg, state, device="cpu", **opts)


def _assert_engine_exact(eng):
    H_ref, _ = full_inference(eng.workload, eng.layers,
                              eng.state.H[0][:eng.n], *eng.graph.coo(),
                              eng.graph.in_degree)
    for l, (h, href) in enumerate(zip(eng.host_H(), H_ref)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=f"layer {l}")


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_overflow_retry_small_buckets(name):
    eng = _engine(name, min_bucket=4)
    rng = np.random.default_rng(0)
    eng.apply_batch(UpdateBatch(features=[
        FeatureUpdate(int(v), rng.normal(size=8).astype(np.float32))
        for v in rng.choice(eng.n, size=20, replace=False)]))
    assert eng.retries > 0
    _assert_engine_exact(eng)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
@pytest.mark.parametrize("donate", [True, False])
def test_overflow_commits_nothing(name, donate):
    """An overflowing attempt leaves H, S, every A tensor and k
    bit-identical, updated in place or not; gp-m's caps overflow only
    its rectangle width, so the h_cap check alone must gate the commit."""
    eng = _engine(name, warm=False)
    rng = np.random.default_rng(0)
    dev_batch, _, _ = eng._route(UpdateBatch(features=[
        FeatureUpdate(int(v), rng.normal(size=8).astype(np.float32))
        for v in rng.choice(eng.n, size=16, replace=False)]))
    before = eng.state.clone()
    caps = ((64, 1024, 1024, 4),) * 2 if name == "gp-m" \
        else ((4, 4, 4, 4),) * 2
    new_state, report = propagate_bounded(
        eng.workload, eng.n, caps, eng.layers, eng.state,
        eng.out_mirror.csr(), eng.in_mirror.csr(), dev_batch,
        eng._taus(), donate=donate)
    overflow, sizes, _, final = eng._read(report)
    assert overflow
    if name == "gp-m":
        assert (sizes[:, :3] <= np.array(caps)[:, :3]).all()
    flat = lambda st: st.H + st.S + (st.k,) + sum(st.A, ())  # noqa: E731
    assert len(flat(new_state)) == len(flat(before))
    for a, b in zip(flat(new_state), flat(before)):
        assert torch.equal(a[:eng.n], b[:eng.n])
    assert np.all(final == eng.n)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
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
    for a1, a2 in zip(sum(don.state.A, ()), sum(ref.state.A, ())):
        np.testing.assert_allclose(a1.numpy(), a2.numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_async_matches_sync_and_k_on_device(name):
    """Pipelined dispatch drains to the synchronous engine's state, one
    batch behind; debug_checks holds the device's k to the host graph's
    in-degree after every batch."""
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
    assert asy.in_mirror.uploads == 1 and asy.in_mirror.row_refreshes > 0
    _assert_engine_exact(asy)


# ---------------------------------------------------------------------------
# approximate mode
# ---------------------------------------------------------------------------
def test_tolerance_rejected_for_non_bounded():
    for name in ("gc-s", "gs-max"):
        with pytest.raises(ValueError, match="bounded"):
            _session(name, engine_options={"tolerance": 0.1})


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
@pytest.mark.parametrize("tol", [1e-3, 1e-1])
def test_certified_bound_covers_published_error(name, tol):
    """At tolerance > 0 the engine may serve stale embeddings, but every
    published row's error against the oracle stays under the certified
    per-vertex bound (2e-3 of float noise allowed), which itself stays
    within the tolerance."""
    s = _session(name, n=50, m=220, engine_options={"tolerance": tol})
    stream = list(s.make_stream(36, seed=6, mix=(1, 1, 2), skew=1.2,
                                feature_target="in_degree"))
    for i in range(0, len(stream), 6):
        s.ingest(stream[i:i + 6])
        bound = s.engine.error_bound()
        assert bound.shape == (s.graph.n,)
        assert float(bound.max()) <= tol + 1e-6
        err = np.abs(s.sync().H[-1] - _oracle(s)[-1]).max(axis=1)
        assert np.all(err <= bound + ATOL), \
            f"published error {err.max():.3e} exceeds certified bound " \
            f"{bound.max():.3e} at tolerance {tol}"


def _jitter_plan(x, rng, n_batches=6, scale=1e-4):
    """Feature nudges of the current features (sensor jitter): interior
    changes that fit a deferral budget."""
    plan = []
    for _ in range(n_batches):
        vs = rng.choice(x.shape[0], size=4, replace=False)
        items = []
        for v in vs:
            x[v] = x[v] + rng.normal(0, scale, size=x.shape[1]).astype(
                np.float32)
            items.append(("f", int(v), x[v].copy()))
        plan.append(items)
    return plan


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_defers_on_the_reference_batches(name):
    """At tolerance 1e-1 the port defers on exactly the batches on which
    the reference's device engine defers (and does defer), and both
    certified bounds agree to 1e-2 relative: a bound grows with the
    largest deferred change, a difference of nearly equal embeddings that
    the two packages round apart."""
    (wl, params, g, ref_state), (twl, layers, tg, state) = _both(
        name, n=50, m=220)
    ref = RefDeviceEngine(wl, params, g, ref_state, min_bucket=16,
                          tolerance=0.1)
    port = DeviceEngine(twl, layers, tg, state, device="cpu", min_bucket=16,
                        tolerance=0.1)
    x = state.H[0].copy()
    pattern_ref, pattern_port = [], []
    for items in _jitter_plan(x, np.random.default_rng(8)):
        ref.apply_batch(_batch(items, rgraph))
        port.apply_batch(_batch(items, tgraph))
        pattern_ref.append(ref.last_deferred_rows > 0)
        pattern_port.append(port.last_deferred_rows > 0)
    assert pattern_port == pattern_ref
    assert any(pattern_port)
    np.testing.assert_allclose(port.error_bound(), ref.error_bound(),
                               rtol=1e-2)
    assert 0 < float(port.error_bound().max()) <= 0.1 + 1e-6


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_swap_engine_roundtrips_bounded_state(name):
    """device -> full -> device mid-stream: A and eps travel with the state
    (the full engine re-derives A), and the stream ends where a
    device-only session ends."""
    a = _session(name, n=60, m=260)
    b = _session(name, n=60, m=260)
    ua = list(a.make_stream(24, seed=1))
    ub = list(b.make_stream(24, seed=1))
    a.ingest(ua, batch_size=4)
    b.ingest(ub[:8], batch_size=4)
    _assert_aux_current(b, "device")
    b.swap_engine("full")
    assert b.state.A is not None and b.state.eps is not None
    b.ingest(ub[8:16], batch_size=4)
    _assert_aux_current(b, "full")
    b.swap_engine("device")
    b.ingest(ub[16:], batch_size=4)
    for l, (ha, hb) in enumerate(zip(a.sync().H, b.sync().H)):
        np.testing.assert_allclose(ha, hb, atol=ATOL, rtol=ATOL,
                                   err_msg=f"swap layer {l}")
    _assert_aux_current(b, "post-swap")
    _assert_exact(b, "post-swap")
    np.testing.assert_array_equal(b.state.eps, 0.0)
