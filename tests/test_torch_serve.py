"""The port's serving layer (``repro_torch.serve``) on the CPU: the cases
of tests/test_serve.py on the port's ``ripple`` engine and its ``device``
engine donated, fresh and async -- snapshot consistency against a
pause-ingest oracle, read-your-writes, staleness policies, backpressure,
hot swap, deadline-driven micro-batching, the latency model, the load
generators, worker errors and the weighted-deficit tenant share -- plus
the device engine's commit log and a parity case against the reference's
``GraphServer``.  The reference's timing case is tested here by its
mechanism (a held engine lock); the timing itself is measured on the card
by chip_smoke.py.  Every wait has a timeout."""
import threading
import time

import numpy as np
import pytest

import jax

from repro.api import InferenceSession as RefSession
from repro.core import DynamicGraph as RefGraph
from repro.core import erdos_renyi, make_workload, params_to_numpy
from repro.data.streams import snapshot_split
from repro.serve import GraphServer as RefServer

import repro_torch.core.graph as tgraph
import repro_torch.serve as tserve
import repro.serve as rserve
from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy
from repro_torch.serve import (AdmissionError, ClosedLoopLoad, GraphServer,
                               LatencyModel, OpenLoopLoad, ServeStopped,
                               StaleReadError, TenantConfig, split_stream,
                               tenant_shares)

ATOL = RTOL = 2e-3
WAIT_S = 60.0       # the bound on every wait of these tests

ENGINES = [("ripple", {}), ("device", {"donate": True}),
           ("device", {"donate": False}), ("device", {"async_dispatch": True})]
ENGINE_IDS = ["ripple", "device-donated", "device-fresh", "device-async"]


@pytest.fixture(params=ENGINES, ids=ENGINE_IDS)
def engine(request):
    return request.param


def _session(engine="ripple", options=None, **over):
    base = dict(workload="gc-s", engine=engine, graph="er", n=40, m=160,
                d_in=8, d_hidden=12, n_classes=5, seed=0, device="cpu",
                engine_options=dict(options or {}))
    base.update(over)
    return InferenceSession.build(SessionConfig(**base))


def _other(name):
    """The engine a hot swap goes to."""
    return "device" if name == "ripple" else "ripple"


def _bounded(fn, *args, timeout=WAIT_S, **kw):
    """Run ``fn`` on a thread and wait at most ``timeout`` for it; returns
    its result, re-raises its exception, fails if it is still running."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:     # handed to the test thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{fn.__name__} still running after {timeout}s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_exports_match_reference():
    assert sorted(tserve.__all__) == sorted(rserve.__all__)
    for name in rserve.__all__:
        assert hasattr(tserve, name), name


# -- snapshot consistency vs a pause-ingest oracle --------------------------
def test_snapshot_never_observes_half_batch(engine):
    name, options = engine
    s = _session(name, options)
    oracle = _session("ripple")
    srv = GraphServer(s, tenants=["a"], threaded=False, max_batch=6)
    updates = list(s.make_stream(36, seed=1))
    srv.submit("a", updates)
    applied = 0
    while srv.pump(max_batches=1):
        srv.drain()                      # force pipelined tails out too
        v = srv.version
        assert v > applied
        oracle.ingest(updates[applied * 6:v * 6], batch_size=6)
        got = srv.query("a", np.arange(40)).values
        np.testing.assert_allclose(got, oracle.query(), atol=ATOL, rtol=RTOL)
        applied = v
    assert srv.version * 6 >= len(updates)


def test_threaded_snapshot_is_always_a_committed_prefix(engine):
    """Under a live worker, every concurrent read equals the oracle state
    after exactly ``version`` micro-batches."""
    name, options = engine
    s = _session(name, options)
    updates = list(s.make_stream(60, seed=1))
    oracle = _session("ripple")
    states = [oracle.query().copy()]
    for i in range(0, len(updates), 4):
        oracle.ingest(updates[i:i + 4], batch_size=4)
        states.append(oracle.query().copy())
    srv = GraphServer(s, tenants=["a"], max_batch=4).start()
    errs = []

    def reader():
        for _ in range(200):
            with srv._scv:               # pin (version, values) atomically
                v = srv.version
                got = srv._H_pub.copy()
            if not np.allclose(got, states[v], atol=ATOL, rtol=RTOL):
                errs.append(v)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    for i in range(0, len(updates), 4):
        srv.submit("a", updates[i:i + 4])
    _bounded(srv.drain)
    th.join(WAIT_S)
    assert not th.is_alive()
    _bounded(srv.stop)
    assert not errs, f"readers saw non-committed states at versions {errs}"
    assert srv.version == len(updates) // 4


def test_read_your_writes_per_tenant(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("a", staleness="wait",
                                               wait_timeout_s=WAIT_S),
                                  TenantConfig("b", staleness="wait",
                                               wait_timeout_s=WAIT_S)],
                      threaded=False)
    ups = list(s.make_stream(20, seed=1))
    seq_a = srv.submit("a", ups[:12])
    srv.pump()
    srv.drain()
    r = srv.query("a", np.arange(5))
    assert r.seen_seq >= seq_a and r.staleness == 0
    assert srv.tenant("a").behind() == 0
    seq_b = srv.submit("b", ups[12:])
    assert srv.tenant("b").behind() == seq_b   # queued, not yet visible
    srv.pump()
    srv.drain()
    assert srv.query("b", np.arange(5)).staleness == 0


def test_swap_engine_preserves_snapshot_and_sequences(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], threaded=False)
    ups = list(s.make_stream(30, seed=1))
    srv.submit("a", ups[:18])
    srv.pump()
    srv.drain()
    before = srv.query("a", np.arange(40))
    srv.swap_engine(_other(name))
    assert s.engine_name == _other(name)
    after = srv.query("a", np.arange(40))
    np.testing.assert_allclose(before.values, after.values,
                               atol=ATOL, rtol=RTOL)
    assert after.seen_seq == before.seen_seq
    srv.submit("a", ups[18:])
    srv.pump()
    srv.drain()
    oracle = _session("ripple")
    oracle.ingest(ups, batch_size=256)
    np.testing.assert_allclose(srv.query("a", np.arange(40)).values,
                               oracle.query(), atol=ATOL, rtol=RTOL)
    assert srv.tenant("a").behind() == 0


def test_threaded_swap_mid_traffic(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], max_batch=4).start()
    ups = list(s.make_stream(40, seed=1))
    srv.submit("a", ups[:20])
    _bounded(srv.swap_engine, _other(name))     # worker may be mid-batch
    srv.submit("a", ups[20:])
    _bounded(srv.drain)
    _bounded(srv.stop)
    oracle = _session("ripple")
    oracle.ingest(ups, batch_size=4)
    np.testing.assert_allclose(srv.query("a", np.arange(40)).values,
                               oracle.query(), atol=ATOL, rtol=RTOL)


# -- staleness policies -----------------------------------------------------
def test_reject_policy_raises_when_behind(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("a", staleness="reject")],
                      threaded=False)
    srv.submit("a", list(s.make_stream(8, seed=1)))
    with pytest.raises(StaleReadError):
        srv.query("a", [0, 1])
    assert srv.tenant("a").rejected_queries == 1
    srv.pump()
    srv.drain()
    assert srv.query("a", [0, 1]).staleness == 0


def test_max_staleness_slack_allows_bounded_lag(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("a", staleness="reject",
                                               max_staleness=100)],
                      threaded=False)
    srv.submit("a", list(s.make_stream(8, seed=1)))
    r = srv.query("a", [0])                # 8 behind but slack is 100
    assert 0 < r.staleness <= 100


def test_wait_policy_blocks_until_published(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("a", staleness="wait",
                                               wait_timeout_s=WAIT_S)],
                      max_batch=4).start()
    srv.submit("a", list(s.make_stream(12, seed=1)))
    r = srv.query("a", [0, 1])             # blocks until its writes publish
    assert r.staleness == 0
    _bounded(srv.stop)


def test_wait_policy_times_out_without_ingest(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("a", staleness="wait",
                                               wait_timeout_s=0.05)],
                      threaded=False)       # nothing will ever pump
    srv.submit("a", list(s.make_stream(4, seed=1)))
    with pytest.raises(StaleReadError, match="gave up"):
        srv.query("a", [0])


# -- overlap: snapshot reads vs blocking reads (the mechanism) -------------
def test_snapshot_query_overlaps_ingest_blocking_waits(engine):
    """While another thread holds the engine lock (as the worker does for a
    whole batch), a snapshot read returns and a blocking read waits until
    the lock is released."""
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], threaded=False)
    held, release = threading.Event(), threading.Event()

    def hold_engine():
        with srv._elock:
            held.set()
            release.wait(WAIT_S)

    holder = threading.Thread(target=hold_engine, daemon=True)
    holder.start()
    assert held.wait(WAIT_S)
    try:
        snap = _bounded(srv.query, "a", [0, 1], mode="snapshot", timeout=5.0)
        assert snap.values.shape == (2, 5)
        blocked = {}
        reader = threading.Thread(
            target=lambda: blocked.setdefault(
                "r", srv.query("a", [0, 1], mode="blocking")), daemon=True)
        reader.start()
        reader.join(0.3)
        assert reader.is_alive() and "r" not in blocked
    finally:
        release.set()
    reader.join(WAIT_S)
    holder.join(WAIT_S)
    assert not reader.is_alive() and not holder.is_alive()
    np.testing.assert_array_equal(blocked["r"].values, snap.values)
    assert len(srv.query_latencies["blocking"]) == 1


# -- admission control ------------------------------------------------------
def test_backpressure_reject_policy(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], threaded=False, capacity=10,
                      overload="reject")
    ups = list(s.make_stream(16, seed=1))
    srv.submit("a", ups[:10])              # fills the queue exactly
    with pytest.raises(AdmissionError):
        srv.submit("a", ups[10:])
    assert srv.tenant("a").rejected_updates == 6
    srv.pump()                             # drains -> admits again
    assert srv.submit("a", ups[10:]) == 16


def test_backpressure_block_policy_waits_for_drain(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], capacity=8, max_batch=4,
                      overload="block").start()
    ups = list(s.make_stream(40, seed=1))

    def feed():
        for i in range(0, len(ups), 8):
            srv.submit("a", ups[i:i + 8])  # would overflow without draining
        srv.drain()

    _bounded(feed)
    _bounded(srv.stop)
    assert srv.tenant("a").submitted == 40
    assert srv.tenant("a").behind() == 0


def test_blocked_submit_of_stopped_server_raises(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], capacity=4).start()
    _bounded(srv.stop)
    srv.submit("a", list(s.make_stream(4, seed=1)))   # fills the queue
    with pytest.raises(ServeStopped):
        _bounded(srv.submit, "a", list(s.make_stream(4, seed=2)))
    assert srv.tenant("a").submitted == 4


# -- deadline-driven micro-batching -----------------------------------------
def test_session_deadline_shrinks_realized_batch(engine):
    name, options = engine
    loose = _session(name, options)
    tight = _session(name, options)
    ups = list(loose.make_stream(40, seed=1))
    rep_loose = loose.ingest(list(ups), batch_size=16)
    rep_tight = tight.ingest(list(ups), batch_size=16, deadline_ms=1e-6)
    assert rep_loose.n_batches == 3        # 16/16/8, deadline off
    assert rep_tight.final_batch_size == 1
    assert rep_tight.n_batches > rep_loose.n_batches


def test_server_deadline_shrinks_micro_batches(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"], threaded=False,
                      deadline_ms=1e-6, max_batch=16)
    srv.submit("a", list(s.make_stream(32, seed=1)))
    srv.pump()
    sizes = srv.metrics()["batch_sizes"]
    assert sizes[0] == 16                  # no latency model yet -> hi
    assert sizes[-1] == 1                  # model learned: impossible budget
    assert len(sizes) > 2


# -- latency model ----------------------------------------------------------
def test_latency_model_learns_affine_cost():
    m = LatencyModel(alpha=0.5)
    for bs in (1, 8, 64, 8, 1, 64) * 20:
        m.observe(bs, 1e-3 + 1e-4 * bs)    # a=1ms, b=0.1ms/update
    assert m.predict(32) == pytest.approx(1e-3 + 3.2e-3, rel=0.2)
    assert 2 <= m.batch_for(2e-3) <= 12
    assert m.batch_for(0.5e-3) == 1        # under the fixed overhead -> lo
    assert LatencyModel().batch_for(1.0, hi=99) == 99   # no obs -> hi


# -- load generators --------------------------------------------------------
def test_tenant_shares_power_law():
    sh = tenant_shares(4, skew=1.0)
    assert sh[0] > sh[1] > sh[3] and sh.sum() == pytest.approx(1.0)
    np.testing.assert_allclose(tenant_shares(4, skew=0.0), 0.25)
    np.testing.assert_array_equal(sh, rserve.tenant_shares(4, skew=1.0))


def test_split_stream_partitions_everything():
    s = _session("ripple")
    ups = list(s.make_stream(50, seed=1))
    per = split_stream(ups, 3, skew=1.0, seed=0)
    assert sum(len(p) for p in per) == 50
    assert len(per[0]) > len(per[2])       # hot tenant gets more
    ref = rserve.split_stream(list(range(50)), 3, skew=1.0, seed=0)
    at = {id(u): i for i, u in enumerate(ups)}
    assert [[at[id(u)] for u in p] for p in per] == ref


@pytest.mark.parametrize("loader", [ClosedLoopLoad, OpenLoopLoad])
def test_load_generators_deliver_everything(engine, loader):
    name, options = engine
    s = _session(name, options)
    names = ["a", "b"]
    srv = GraphServer(s, tenants=names, max_batch=8).start()
    ups = list(s.make_stream(40, seed=1))
    per = dict(zip(names, split_stream(ups, 2, seed=0)))
    kw = {"rate": 2000.0} if loader is OpenLoopLoad else {}
    rep = _bounded(loader(srv, per, chunk=4, query_every=2, seed=0,
                          **kw).run)
    _bounded(srv.stop)
    assert rep.n_updates == 40 and rep.n_rejected == 0
    assert rep.n_queries > 0 and len(rep.query_latencies) == rep.n_queries
    assert srv.version > 0
    assert srv.metrics()["published_updates"] == 40
    # the published snapshot bit-matches the engine's state once drained
    np.testing.assert_array_equal(srv._H_pub,
                                  np.asarray(srv.session.query()))


def test_worker_error_surfaces_on_api_calls(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"]).start()

    def boom(batch):
        raise RuntimeError("engine exploded")

    s.apply_one = boom
    srv.submit("a", list(s.make_stream(4, seed=1)))
    with pytest.raises(RuntimeError, match="engine exploded"):
        for _ in range(1000):
            time.sleep(0.01)
            srv.query("a", [0])
    srv._error = None
    _bounded(srv.stop, drain=False)


def test_worker_error_reraised_by_stop(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=["a"]).start()

    def boom(batch):
        raise ValueError("bad batch")

    s.apply_one = boom
    srv.submit("a", list(s.make_stream(4, seed=1)))
    with pytest.raises(ValueError, match="bad batch"):
        _bounded(srv.stop)
    assert srv._error is None and srv._worker is None


# -- weighted-deficit tenant scheduling -------------------------------------
def test_weighted_deficit_tenant_share(engine):
    name, options = engine
    s = _session(name, options)
    srv = GraphServer(s, tenants=[TenantConfig("heavy", weight=3.0),
                                  TenantConfig("light", weight=1.0)],
                      threaded=False, max_batch=8)
    updates = list(s.make_stream(200, seed=2))
    srv.submit("heavy", updates[:100])
    srv.submit("light", updates[100:])
    srv.pump(max_batches=10)             # both backlogs still non-empty
    m = srv.metrics()["tenants"]
    h, l = m["heavy"]["committed"], m["light"]["committed"]
    assert h + l >= 40, "pump served too little to measure the share"
    assert h < 100 and l < 100, "a backlog drained: not saturated"
    ratio = h / max(l, 1)
    assert 2.2 <= ratio <= 3.8, \
        f"3:1-weighted pair served at {ratio:.2f}:1 ({h} vs {l})"
    srv.pump()
    srv.drain()
    m = srv.metrics()["tenants"]
    assert m["heavy"]["committed"] == 100
    assert m["light"]["committed"] == 100


# -- the device engine's commit log ----------------------------------------
def _commit_engines():
    """Two device sessions over one graph: synchronous and async."""
    return (_session("device", {"async_dispatch": False}),
            _session("device", {"async_dispatch": True}))


def test_drain_commits_rows_and_fifo_order():
    """Each logged commit holds the batch's affected ids and exactly
    H[-1][affected] as committed; under async_dispatch the commits come
    out one batch late, in FIFO order, with the same ids and rows."""
    sync_s, async_s = _commit_engines()
    for s in (sync_s, async_s):
        s.engine.enable_commit_log()
        assert s.engine.drain_commits() == []
    batches = list(sync_s.make_stream(40, seed=1).batches(5))
    want = []
    for i, b in enumerate(batches):
        res = sync_s.apply_one(b)
        (idx, aff, rows), = sync_s.engine.drain_commits()
        assert idx == i + 1
        np.testing.assert_array_equal(aff, res.affected)
        H = sync_s.engine.impl.state.H[-1]
        np.testing.assert_array_equal(rows, H[aff].numpy())
        assert rows.dtype == np.float32 and rows.shape == (aff.size, 5)
        want.append((aff, rows))
    got = []
    for i, b in enumerate(batches):
        async_s.apply_one(b)
        commits = async_s.engine.drain_commits()
        assert [c[0] for c in commits] == ([] if i == 0 else [i])
        got += commits
    async_s.engine.flush()
    got += async_s.engine.drain_commits()
    assert [c[0] for c in got] == list(range(1, len(batches) + 1))
    for (_idx, aff, rows), (w_aff, w_rows) in zip(got, want):
        np.testing.assert_array_equal(aff, w_aff)
        np.testing.assert_allclose(rows, w_rows, atol=1e-6, rtol=1e-6)
    # the logged rows are copies: later batches do not write through them
    assert got[0][2].base is None or not np.shares_memory(
        got[0][2], async_s.engine.impl.state.H[-1].numpy())
    assert async_s.engine.impl.commit_log_seconds > 0


def test_enable_commit_log_resolves_inflight_batch():
    _sync, s = _commit_engines()
    b = list(s.make_stream(10, seed=1).batches(5))
    s.apply_one(b[0])                      # in flight
    s.engine.enable_commit_log()           # predates the log: not logged
    assert s.engine.drain_commits() == []
    s.apply_one(b[1])
    s.engine.flush()
    assert [c[0] for c in s.engine.drain_commits()] == [1]


# -- parity with the reference's GraphServer -------------------------------
def _server_pair(engine):
    """The reference's and the port's session over the same graph, split,
    features and weights (the reference on host ripple)."""
    name, options = engine
    wl = make_workload("gc-s", n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    params = wl.init_params(jax.random.PRNGKey(0))
    src, dst, w = erdos_renyi(40, 160, seed=0)
    snap, hold = snapshot_split(src, dst, w, 0.1, seed=0)
    x = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    ref = RefSession.bootstrap(wl, params, x, RefGraph(40, *snap), "ripple",
                               holdout=hold)
    twl = t_make_workload("gc-s", n_layers=2, d_in=8, d_hidden=12,
                          n_classes=5)
    port = InferenceSession.bootstrap(
        twl, params_from_numpy(twl, params_to_numpy(params), "cpu"), x,
        tgraph.DynamicGraph(40, *snap), name, device="cpu", holdout=hold,
        engine_options=options)
    return ref, port


def test_server_parity_with_reference(engine):
    """The same params and updates through both packages' servers
    (threaded=False, two weighted tenants): after every micro-batch the
    versions and tenant watermarks are equal and the published values
    within 2e-3."""
    ref, port = _server_pair(engine)
    tenants = [("a", 2.0), ("b", 1.0)]
    servers = [cls(sess, tenants=[tc(n, weight=wt) for n, wt in tenants],
                   threaded=False, max_batch=6)
               for cls, sess, tc in ((RefServer, ref, rserve.TenantConfig),
                                     (GraphServer, port, TenantConfig))]
    for srv in servers:   # each package's own update objects, equal values
        ups = list(srv.session.make_stream(48, seed=1).updates)
        srv.submit("a", ups[:30])
        srv.submit("b", ups[30:])
    steps = 0
    while True:
        done = [srv.pump(max_batches=1) for srv in servers]
        assert done[0] == done[1]
        if not done[0]:
            break
        for srv in servers:
            srv._flush_tail()            # publish a pipelined batch only
        r, t = servers
        assert r.version == t.version
        for n, _ in tenants:
            assert r.tenant(n).committed == t.tenant(n).committed
            assert r.tenant(n).behind() == t.tenant(n).behind()
        np.testing.assert_allclose(t._H_pub, r._H_pub, atol=ATOL, rtol=RTOL)
        steps += 1
    assert steps == 8
    r, t = servers
    assert r.metrics()["batch_sizes"] == t.metrics()["batch_sizes"]
    np.testing.assert_allclose(t.query("b", np.arange(40)).values,
                               r.query("b", np.arange(40)).values,
                               atol=ATOL, rtol=RTOL)


# -- the CLI and the examples, on the CPU ----------------------------------
@pytest.mark.parametrize("mode", ["closed", "open"])
def test_serve_cli_on_cpu(capsys, mode):
    from repro_torch.serve.__main__ import main
    _bounded(main, ["--device", "cpu", "--engine", "device", "--tenants",
                    "4", "--n", "120", "--m", "480", "--updates", "120",
                    "--mode", mode, "--rate", "4000"])
    out = capsys.readouterr().out
    assert "engine=device device=cpu tenants=4 updates=120" in out
    assert "(120 updates" in out and "micro-batch:" in out


def test_examples_on_cpu(capsys):
    from repro_torch.examples import quickstart, streaming_serve
    _bounded(quickstart.main, ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "max difference 0 from the tip" in out
    _bounded(streaming_serve.main, ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2000 updates from 4 tenants on cpu" in out
    assert "snapshot preserved, +100 updates committed" in out
