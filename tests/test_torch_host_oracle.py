"""The port's host engines (``ripple``, ``rc``, ``vertexwise``) and ``full``
engine against the port's own full-inference oracle, at atol/rtol 2e-3:
the cases of the reference's tests/test_engine_equivalence.py, the
host-engine cases of tests/test_aggregators.py and tests/test_bounded.py
(delete the argmax, delete the dominant logit, top-k threshold crossing,
certified bounds at tolerance 1e-3 and 1e-1, ripple refreshing fewer rows
than rc) and the tests/test_session.py round trips and hot swaps between
the host and the device engines.  Everything runs on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core import RecomputeEngine, RippleEngine
from repro_torch.core.full import full_inference
from repro_torch.core.graph import (DynamicGraph, EdgeUpdate, FeatureUpdate,
                                    UpdateBatch, erdos_renyi)
from repro_torch.core.state import InferenceState, params_to_numpy
from repro_torch.core.workloads import (BOUNDED_WORKLOAD_NAMES,
                                        MONOTONIC_WORKLOAD_NAMES,
                                        WORKLOAD_NAMES, Workload,
                                        WorkloadSpec, make_workload)

ATOL = 2e-3
RTOL = 2e-3


# ---------------------------------------------------------------------------
# engine level (tests/test_engine_equivalence.py)
# ---------------------------------------------------------------------------
def _setup(name, n=40, m=160, seed=0, n_layers=2, d_in=8):
    wl = make_workload(name, n_layers=n_layers, d_in=d_in, d_hidden=12,
                       n_classes=5)
    src, dst, w = erdos_renyi(n, m, seed=seed, weighted=wl.spec.weighted)
    g = DynamicGraph(n, src, dst, w)
    x = np.random.default_rng(seed + 1).normal(size=(n, d_in)).astype(
        np.float32)
    params = wl.init_params(torch.Generator().manual_seed(seed), device="cpu")
    state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
    return wl, g, x, params, state


def _oracle(wl, params, g, x_current):
    H, _ = full_inference(wl, params, torch.as_tensor(x_current), *g.coo(),
                          g.in_degree)
    return [h.numpy() for h in H]


def _assert_state_matches(state, H_ref, label=""):
    for l, (h, href) in enumerate(zip(state.H, H_ref)):
        np.testing.assert_allclose(h, href, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label} layer {l}")


def _single_update(g, x, kind):
    if kind == "add":
        u, v = 0, 1
        while g.has_edge(u, v) or u == v:
            v += 1
        return UpdateBatch(edges=[EdgeUpdate(u, v, True, 0.5)])
    if kind == "delete":
        src, dst, _ = g.coo()
        return UpdateBatch(edges=[EdgeUpdate(int(src[3]), int(dst[3]),
                                             False)])
    return UpdateBatch(features=[FeatureUpdate(
        5, np.full(x.shape[1], 0.7, dtype=np.float32))])


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
@pytest.mark.parametrize("engine_cls", [RippleEngine, RecomputeEngine])
@pytest.mark.parametrize("kind", ["add", "delete", "feature"])
def test_single_update_matches_oracle(name, engine_cls, kind):
    wl, g, x, params, state = _setup(name)
    eng = engine_cls(wl, params_to_numpy(params), g, state)
    eng.apply_batch(_single_update(g, x, kind))
    _assert_state_matches(state, _oracle(wl, params, g, state.H[0]), kind)


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
@pytest.mark.parametrize("n_layers", [2, 3])
def test_mixed_batches_sequence(name, n_layers):
    """Many consecutive mixed batches drift-free vs the oracle."""
    wl, g, x, params, state = _setup(name, n=60, m=240, n_layers=n_layers)
    eng = RippleEngine(wl, params_to_numpy(params), g, state)
    rng = np.random.default_rng(7)
    for step in range(6):
        batch = UpdateBatch()
        for _ in range(4):
            kind = rng.integers(0, 3)
            if kind == 0:
                u, v = rng.integers(0, g.n, size=2)
                if u != v:
                    batch.edges.append(EdgeUpdate(
                        int(u), int(v), True, float(rng.uniform(0.1, 1.0))))
            elif kind == 1:
                src, dst, _ = g.coo()
                i = rng.integers(0, src.size)
                batch.edges.append(EdgeUpdate(int(src[i]), int(dst[i]),
                                              False))
            else:
                batch.features.append(FeatureUpdate(
                    int(rng.integers(0, g.n)),
                    rng.normal(size=x.shape[1]).astype(np.float32)))
        eng.apply_batch(batch)
        _assert_state_matches(state, _oracle(wl, params, g, state.H[0]),
                              f"step {step}")


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_ripple_equals_recompute(name):
    """RIPPLE and RC produce the same final states; the filtered families'
    RIPPLE frontier is a subset of RC's unfiltered one."""
    wl, g, x, params, state = _setup(name, n=50, m=200)
    g2 = DynamicGraph(g.n, *g.coo())
    state2 = state.clone()
    rp = RippleEngine(wl, params_to_numpy(params), g, state)
    rc = RecomputeEngine(wl, params_to_numpy(params), g2, state2)
    batch = UpdateBatch(
        edges=[EdgeUpdate(2, 9, True, 0.3), EdgeUpdate(9, 2, True, 0.9)],
        features=[FeatureUpdate(4, np.ones(x.shape[1], dtype=np.float32))])
    s1 = rp.apply_batch(batch)
    s2 = rc.apply_batch(batch)
    for h1, h2 in zip(state.H, state2.H):
        np.testing.assert_allclose(h1, h2, atol=ATOL, rtol=RTOL)
    if wl.agg.algebra == "invertible":
        np.testing.assert_array_equal(np.sort(s1.final_affected),
                                      np.sort(s2.final_affected))
    else:
        assert set(s1.final_affected.tolist()) \
            <= set(s2.final_affected.tolist())


# ---------------------------------------------------------------------------
# sessions (tests/test_session.py, test_aggregators.py, test_bounded.py)
# ---------------------------------------------------------------------------
def _build(name, engine, n=40, m=170, seed=0, **over):
    cfg = dict(workload=name, engine=engine, graph="er", n=n, m=m, d_in=8,
               d_hidden=12, n_classes=5, seed=seed, device="cpu")
    cfg.update(over)
    return InferenceSession.build(SessionConfig(**cfg))


def _oracle_H(session):
    st = session.sync()
    return _oracle(session.workload, session.params, session.graph, st.H[0])


def _assert_exact(session, label=""):
    _assert_state_matches(session.sync(), _oracle_H(session), label)
    np.testing.assert_allclose(session.query(), _oracle_H(session)[-1],
                               atol=ATOL, rtol=RTOL, err_msg=label)


def _assert_contributor_invariant(session):
    """S[l][v,d] == H[l-1][C[l][v,d], d], and C holds in-neighbours."""
    st = session.sync()
    for l in range(1, len(st.S)):
        C, S, H_prev = st.C[l], st.S[l], st.H[l - 1]
        rows, dims = np.nonzero(C >= 0)
        np.testing.assert_array_equal(H_prev[C[rows, dims], dims],
                                      S[rows, dims])
        for v in np.unique(rows)[:8]:
            nbrs = set(session.graph.in_nbrs(int(v))[0].tolist())
            assert set(C[v][C[v] >= 0].tolist()) <= nbrs


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
@pytest.mark.parametrize("engine", ["ripple", "rc", "full"])
def test_session_roundtrip_matches_oracle(name, engine):
    s = _build(name, engine)
    s.ingest(s.make_stream(30, seed=1), batch_size=6)
    _assert_exact(s, f"{name}/{engine}")
    if s.state.C is not None and engine != "full":
        _assert_contributor_invariant(s)


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_vertexwise_query_matches_oracle(name):
    s = _build(name, "vertexwise")
    s.ingest(s.make_stream(12, seed=1), batch_size=4)
    H_ref = _oracle_H(s)
    targets = np.arange(10)
    np.testing.assert_allclose(s.query(targets), H_ref[-1][targets],
                               atol=ATOL, rtol=RTOL)
    assert s.engine.ops > 0
    # sync materializes the whole layered state through the full pass
    _assert_state_matches(s.sync(), H_ref)


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
def test_delete_the_argmax(name):
    """Adversarial SHRINK: delete exactly the tracked contributor's edge."""
    s = _build(name, "ripple")
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


@pytest.mark.parametrize("name", MONOTONIC_WORKLOAD_NAMES)
def test_filtered_propagation_touches_fewer_rows(name):
    rp = _build(name, "ripple", n=300, m=2400)
    rc = _build(name, "rc", n=300, m=2400)
    rep_rp = rp.ingest(list(rp.make_stream(240, seed=2, mix=(1, 3, 1),
                                           skew=0.8)), batch_size=20)
    rep_rc = rc.ingest(list(rc.make_stream(240, seed=2, mix=(1, 3, 1),
                                           skew=0.8)), batch_size=20)
    _assert_exact(rp, "filtered rp")
    assert sum(r.shrink_events for r in rep_rp.results) > 0
    assert sum(r.rows_reaggregated for r in rep_rp.results) \
        < sum(r.rows_reaggregated for r in rep_rc.results)
    assert sum(r.total_affected for r in rep_rp.results) \
        <= sum(r.total_affected for r in rep_rc.results)


def test_delete_the_dominant_logit():
    """Make one in-neighbour's logit dominate a row's softmax, then delete
    exactly that edge: the collapsed normalizer must be refreshed."""
    s = _build("ga-s", "ripple")
    rng = np.random.default_rng(5)
    refreshed = 0
    for round_ in range(4):
        st = s.sync()
        rows = np.nonzero(s.graph.in_degree >= 3)[0]
        v = int(rows[rng.integers(0, rows.size)])
        nbrs, _ = s.graph.in_nbrs(v)
        u = int(nbrs[np.argmax(st.H[0][nbrs].sum(axis=1))])
        s.ingest(UpdateBatch(features=[FeatureUpdate(
            u, np.full(8, 6.0, dtype=np.float32))]))
        _assert_exact(s, f"round {round_} boost")
        res = s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, False)]))
        refreshed += res.results[0].rows_reaggregated
        _assert_exact(s, f"round {round_} delete-dominant")
    assert refreshed > 0


def test_topk_threshold_crossing():
    """Top-k's cache is the k-th-value threshold: crossing it (up or down)
    refreshes the row, staying strictly below it is a PATCH no-op, and
    every path stays oracle-exact."""
    wl = Workload(WorkloadSpec(name="gc-topk", aggregator="topk",
                               self_dependent=False, n_layers=2,
                               dims=(6, 10, 4)), family="gc")
    n = 30
    g = DynamicGraph(n, *erdos_renyi(n, 170, seed=3, weighted=False))
    x = np.random.default_rng(4).normal(size=(n, 6)).astype(np.float32)
    params = wl.init_params(torch.Generator().manual_seed(3), device="cpu")
    state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
    eng = RippleEngine(wl, params_to_numpy(params), g, state)
    v = int(np.argmax(g.in_degree))
    assert g.in_degree[v] >= 5
    u = int(g.in_nbrs(v)[0][0])
    for value, counter in ((50.0, "rows_reaggregated"),
                           (-100.0, "rows_reaggregated"),
                           (-120.0, "patch_events")):
        stats = eng.apply_batch(UpdateBatch(features=[FeatureUpdate(
            u, np.full(6, value, dtype=np.float32))]))
        assert getattr(stats, counter) > 0, value
        _assert_state_matches(state, _oracle(wl, params, g, state.H[0]),
                              f"feature {value}")


def test_tolerance_rejected_for_non_bounded():
    with pytest.raises(ValueError, match="bounded"):
        _build("gc-s", "ripple", engine_options={"tolerance": 0.1})
    with pytest.raises(TypeError, match="does not accept"):
        _build("ga-s", "rc", engine_options={"tolerance": 0.1})


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
@pytest.mark.parametrize("tol", [1e-3, 1e-1])
def test_certified_bound_covers_published_error(name, tol):
    s = _build(name, "ripple", n=50, m=220,
               engine_options={"tolerance": tol})
    stream = list(s.make_stream(36, seed=6, mix=(1, 1, 2), skew=1.2,
                                feature_target="in_degree"))
    for i in range(0, len(stream), 6):
        s.ingest(stream[i:i + 6])
        bound = s.engine.error_bound()
        assert bound.shape == (s.graph.n,)
        assert float(bound.max()) <= tol + 1e-6
        err = np.abs(s.state.H[-1] - _oracle_H(s)[-1]).max(axis=1)
        assert np.all(err <= bound + ATOL)


def test_tolerance_actually_defers():
    s_exact = _build("ga-s", "ripple", n=50, m=220)
    s_apx = _build("ga-s", "ripple", n=50, m=220,
                   engine_options={"tolerance": 1e-1})
    rng = np.random.default_rng(8)
    deferred_apx = deferred_exact = 0
    for _ in range(6):
        vs = rng.choice(50, size=4, replace=False)
        batch = UpdateBatch(features=[
            FeatureUpdate(int(v), s_exact.state.H[0][int(v)]
                          + rng.normal(0, 1e-6, size=8).astype(np.float32))
            for v in vs])
        deferred_exact += s_exact.apply_one(batch).deferred_rows
        deferred_apx += s_apx.apply_one(batch).deferred_rows
    assert deferred_exact == 0 and deferred_apx > 0
    assert float(s_exact.engine.error_bound().max()) == 0.0
    assert float(s_apx.engine.error_bound().max()) > 0.0


def test_ripple_refreshes_fewer_rows_than_rc():
    totals = {}
    for engine in ("ripple", "rc"):
        s = _build("ga-s", engine, n=60, m=260, graph="powerlaw")
        rep = s.ingest(s.make_stream(60, seed=9, mix=(1, 1, 2), skew=1.0),
                       batch_size=6)
        totals[engine] = sum(r.rows_reaggregated for r in rep.results)
        _assert_exact(s, engine)
    assert totals["ripple"] < totals["rc"], totals


@pytest.mark.parametrize("name", ["gs-s", "gi-s", "gs-max", "ga-s", "gp-m"])
def test_hot_swap_ripple_device_ripple(name):
    """ripple -> device -> ripple mid-stream equals never swapping: H, S,
    k, C, A and eps cross both ways."""
    a = _build(name, "ripple", n=60, m=260)
    b = _build(name, "ripple", n=60, m=260)
    ua = list(a.make_stream(24, seed=1))
    ub = list(b.make_stream(24, seed=1))
    a.ingest(ua, batch_size=4)
    b.ingest(ub[:8], batch_size=4)
    b.swap_engine("device")
    assert b.engine_name == "device"
    b.ingest(ub[8:16], batch_size=4)
    b.swap_engine("ripple")
    b.ingest(ub[16:], batch_size=4)
    sa, sb = a.sync(), b.sync()
    for l, (ha, hb) in enumerate(zip(sa.H, sb.H)):
        np.testing.assert_allclose(ha, hb, atol=ATOL, rtol=RTOL,
                                   err_msg=f"swap layer {l}")
    if sb.C is not None:
        _assert_contributor_invariant(b)
    # the caches A may differ between the paths (ripple's softmax anchor
    # is a grow-only upper bound, the device re-derives it), not the
    # embeddings they give
    assert (sb.A is None) == (sb.eps is None) == (sa.A is None)
    _assert_exact(b, f"{name} post-swap")


def test_hot_swap_device_to_host_engines():
    s = _build("gc-m", "device")
    updates = list(s.make_stream(24, seed=1))
    s.ingest(updates[:6], batch_size=3)
    for name in ("ripple", "rc", "vertexwise", "full"):
        s.swap_engine(name)
        assert s.engine_name == name
        i = 6 * ("ripple", "rc", "vertexwise", "full").index(name) + 6
        s.ingest(updates[i:i + 6], batch_size=3)
        _assert_exact(s, f"after {name}")


def test_swap_to_same_engine_is_noop_and_deadline_splits():
    s = _build("gc-s", "ripple")
    eng = s.engine
    assert s.swap_engine("rp") is eng
    stream = s.make_stream(40, seed=1)
    report = s.ingest(stream, batch_size=16, deadline_ms=1e-6)
    assert report.final_batch_size == 1
    assert report.n_batches > 40 // 16 and report.n_updates == len(stream)
    _assert_exact(s)


@pytest.mark.parametrize("engine", ["ripple", "rc", "vertexwise", "full"])
def test_stream_cli_host_engines(engine, capsys):
    from repro_torch.launch.stream import main
    main(["--device", "cpu", "--engine", engine, "--workload", "gc-m",
          "--n", "80", "--m", "320", "--updates", "40", "--batch-size",
          "10"])
    out = capsys.readouterr().out
    assert f"engine={engine}" in out and "updates=40" in out


def test_stream_cli_tolerance_reaches_ripple(capsys):
    from repro_torch.launch.stream import main
    main(["--device", "cpu", "--engine", "ripple", "--workload", "ga-s",
          "--n", "80", "--m", "320", "--updates", "40", "--batch-size", "10",
          "--tolerance", "0.1"])
    out = capsys.readouterr().out
    assert "engine=ripple" in out and "tolerance=0.1" in out \
        and "error_bound=" in out


# ---------------------------------------------------------------------------
# an edge added and deleted again within one batch
# ---------------------------------------------------------------------------
def test_net_topology():
    g = DynamicGraph(4, np.array([0, 1]), np.array([1, 2]),
                     np.array([1.0, 2.0], dtype=np.float32))
    ups = [EdgeUpdate(2, 3, True), EdgeUpdate(2, 3, False),    # transient
           EdgeUpdate(0, 1, False), EdgeUpdate(0, 1, True, 5.0),  # re-added
           EdgeUpdate(3, 0, True), EdgeUpdate(3, 0, False),
           EdgeUpdate(3, 0, True, 7.0),                        # net add
           EdgeUpdate(1, 2, False), EdgeUpdate(1, 2, True),
           EdgeUpdate(1, 2, False)]                            # net delete
    adds, dels = g.net_topology(*g.apply_topology(ups))
    assert [(e.src, e.dst, e.weight) for e in adds] == [(0, 1, 5.0),
                                                        (3, 0, 7.0)]
    assert [(e.src, e.dst, e.weight) for e in dels] == [(0, 1, 1.0),
                                                        (1, 2, 2.0)]


@pytest.mark.parametrize("name", ["gc-s", "gs-max", "gc-min", "ga-s", "gp-m"])
@pytest.mark.parametrize("engine", ["ripple", "rc", "device", "full"])
def test_edge_added_and_deleted_in_one_batch(name, engine):
    """The max-based algebras must not keep the candidate of an edge that
    one batch added and deleted again (the reference's ripple and device
    engines do, for max/min and PNA's max: its own hypothesis test of
    tests/test_aggregators.py fails at seed 3843 on gs-max)."""
    s = _build(name, engine)
    g = s.graph
    for u in range(0, 40, 3):
        for v in range(1, 40, 7):
            if u != v and not g.has_edge(u, v):
                s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, True),
                                            EdgeUpdate(u, v, False)]))
    _assert_exact(s, f"{name}/{engine}")


def _reference_monotonic_case(seed: int, name: str) -> None:
    """The body of the reference's test_property_monotonic_exactness
    (tests/test_aggregators.py) on the port's ripple engine."""
    wl = make_workload(name, n_layers=2, d_in=6, d_hidden=8, n_classes=4)
    g = DynamicGraph(16, *erdos_renyi(16, 48, seed=seed % 7))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    params = wl.init_params(torch.Generator().manual_seed(0), device="cpu")
    state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
    eng = RippleEngine(wl, params_to_numpy(params), g, state)
    for _ in range(3):
        batch = UpdateBatch()
        for _ in range(4):
            kind = rng.integers(0, 3)
            u, v = rng.integers(0, 16, size=2)
            if kind == 0 and u != v:
                batch.edges.append(EdgeUpdate(int(u), int(v), True))
            elif kind == 1 and u != v:
                batch.edges.append(EdgeUpdate(int(u), int(v), False))
            else:
                batch.features.append(FeatureUpdate(
                    int(u), rng.normal(size=6).astype(np.float32)))
        eng.apply_batch(batch)
        _assert_state_matches(state, _oracle(wl, params, g, state.H[0]),
                              f"{name} seed {seed}")


def _reference_incremental_case(n: int, batches: list, name: str) -> None:
    """The body of the reference's test_property_incremental_exactness
    (tests/test_engine_equivalence.py) on the port's ripple engine: each
    op is (kind, u, v, weight), kind 0 adds u -> v, 1 deletes it, anything
    else (or u == v) sets u's features to ``weight``."""
    wl = make_workload(name, n_layers=2, d_in=6, d_hidden=8, n_classes=4)
    g = DynamicGraph(n, *erdos_renyi(n, 3 * n, seed=1,
                                     weighted=wl.spec.weighted))
    x = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
    params = wl.init_params(torch.Generator().manual_seed(0), device="cpu")
    state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
    eng = RippleEngine(wl, params_to_numpy(params), g, state)
    for ops in batches:
        batch = UpdateBatch()
        for kind, u, v, weight in ops:
            if kind == 0 and u != v:
                batch.edges.append(EdgeUpdate(u, v, True, weight))
            elif kind == 1 and u != v:
                batch.edges.append(EdgeUpdate(u, v, False))
            else:
                batch.features.append(FeatureUpdate(
                    u, np.full(6, weight, dtype=np.float32)))
        eng.apply_batch(batch)
        _assert_state_matches(state, _oracle(wl, params, g, state.H[0]),
                              name)


# add u -> v and delete it again in one batch: 1 -> 0 on an 8-vertex
# graph, 0 -> 5 on a 13-vertex one
TRANSIENT = {"1-0": (8, [[(0, 1, 0, 1.0), (1, 1, 0, 1.0)]]),
             "0-5": (13, [[(0, 0, 5, 1.0), (1, 0, 5, 1.0)]])}
HYPOTHESIS_CASES = (
    [pytest.param(_reference_monotonic_case, (seed, "gs-max"),
                  id=f"monotonic-seed{seed}-gs-max")
     for seed in (3843, 2689, 6087)]
    + [pytest.param(_reference_incremental_case, (*data, name),
                    id=f"incremental-transient-{edge}-{name}")
       for edge, data in TRANSIENT.items() for name in WORKLOAD_NAMES])


@pytest.mark.parametrize("case,args", HYPOTHESIS_CASES)
def test_reference_hypothesis_case_seed_3843(case, args):
    """The falsifying examples the reference's own hypothesis searches
    found, each a batch that adds an edge and deletes it again (the
    reference's ripple engine keeps the transient edge's candidate):
    test_property_monotonic_exactness at seeds 3843, 2689 and 6087 on
    gs-max, and test_property_incremental_exactness at ``data=(8, [[(0, 1,
    0, 1.0), (1, 1, 0, 1.0)]])`` and ``data=(13, [[(0, 0, 5, 1.0), (1, 0,
    5, 1.0)]])``, found on gs-max and run on every workload.  The port's
    ripple engine holds its oracle on each."""
    case(*args)
