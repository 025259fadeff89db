"""The port's distributed engines (``dist``, ``dist-rc``) against the JAX
package's.

Three levels:

 - the local primitives (bucket packing, recipient compaction, the frontier
   message stream) and the tensor-parallel UPDATE, on the same NumPy
   inputs as the reference's functions;
 - sessions at world size 1 (a one-rank gloo group in this process), all
   nine workloads in both engines: exact against the oracle, the
   ripple -> dist -> device round trip, a sharded checkpoint and restore;
 - sessions on 4 ranks: tests/torch_dist_ranks.py runs the port on 4 gloo
   CPU processes and the reference on 4 virtual JAX devices, over the same
   meshes, weights, graph and stream; each batch's messages_per_hop and
   affected ids must equal the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.core import distributed as rdist
from repro.core import make_workload as r_make_workload
from repro.core.state import params_to_numpy as r_params_to_numpy
from repro.utils import make_mesh_compat, shard_map_compat

import repro_torch.core.distributed as tdist
from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core.full import full_inference
from repro_torch.core.graph import EdgeUpdate, UpdateBatch
from repro_torch.core.workloads import WORKLOAD_NAMES
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.launch.mesh import default_mesh

ATOL = RTOL = 2e-3
RUNNER = os.path.join(os.path.dirname(__file__), "torch_dist_ranks.py")
REF_PROCS = 2     # JAX processes the reference's cases are split over


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Local primitives against the reference's, on the same NumPy inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_buckets", [3, 70])   # one-hot and sorted regimes
@pytest.mark.parametrize("cap", [4, 16])
def test_pack_buckets_matches_reference(n_buckets, cap):
    rng = np.random.default_rng(n_buckets * 10 + cap)
    n = 200
    bucket = rng.integers(0, n_buckets + 1, n)     # n_buckets drops
    key = rng.integers(0, 1000, n)
    vals = rng.integers(-8, 8, (n, 3)).astype(np.float32) / 4
    ref = rdist._pack_buckets(n_buckets, cap, jnp.asarray(bucket),
                              jnp.asarray(key), 999, jnp.asarray(vals))
    got = tdist._pack_buckets(n_buckets, cap, _t(bucket), _t(key), 999,
                              _t(vals))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n_msgs", [10, 120])   # sort and mask regimes
def test_compact_matches_reference(n_msgs):
    rng = np.random.default_rng(n_msgs)
    n, r_cap = 100, 64
    dst = rng.integers(0, n + 1, n_msgs)           # n is the sentinel
    vals = rng.integers(-8, 8, (n_msgs, 4)).astype(np.float32) / 4
    ref = rdist._compact(n, jnp.asarray(dst), jnp.asarray(vals), r_cap)
    got = tdist._compact(n, _t(dst), _t(vals), r_cap)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("weighted,self_dep", [(False, False), (True, True)])
def test_local_frontier_messages_matches_reference(weighted, self_dep):
    rng = np.random.default_rng(int(weighted))
    nl, n_pad, pool, d, e_cap = 20, 60, 256, 3, 64
    length = rng.integers(0, 5, nl)
    start = np.concatenate([[0], np.cumsum(length + 2)[:-1]])
    col = rng.integers(0, n_pad, pool)
    w = rng.integers(1, 4, pool).astype(np.float32) / 2
    h_pre = rng.integers(-8, 8, (nl, d)).astype(np.float32) / 4
    frontier = np.array([3, 7, 11, nl, 15, nl])
    delta = rng.integers(-8, 8, (6, d)).astype(np.float32) / 4
    delta[frontier == nl] = 0
    # the reference reads the layer as written by the previous hop
    h_l = h_pre.copy()
    h_l[frontier[frontier < nl]] += delta[frontier < nl]
    a_src, a_dst = np.array([2, 7, nl]), np.array([40, 5, n_pad])
    d_src, d_dst = np.array([9, nl, nl]), np.array([33, n_pad, n_pad])
    aw = np.array([0.5, 1.5, 0.0], np.float32)
    dw = np.array([2.0, 0.0, 0.0], np.float32)
    args = (frontier, delta, a_src, a_dst, aw, d_src, d_dst, dw)
    kw = dict(weighted=weighted, self_dep=self_dep, e_cap=e_cap, my_part=1)
    ref = rdist._local_frontier_messages(
        nl, n_pad, jnp.asarray(h_l), jnp.asarray(col), jnp.asarray(w),
        jnp.asarray(start), jnp.asarray(length),
        *(jnp.asarray(a) for a in args), **kw)
    got = tdist._local_frontier_messages(
        nl, n_pad, _t(h_pre), _t(col), _t(w), _t(start), _t(length),
        *(_t(a) for a in args), **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["gc-s", "gs-s", "gi-s"])
@pytest.mark.parametrize("layer", [0, 1])
def test_tp_update_matches_reference(name, layer):
    """The tensor-parallel UPDATE on a (1, 1) mesh: the reference's
    ``psum_scatter`` under ``shard_map`` against the port's
    reduce-scatter over a one-rank model group."""
    wl = r_make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=4)
    params = wl.init_params(jax.random.PRNGKey(layer))
    p_np = r_params_to_numpy(params)[layer]
    rng = np.random.default_rng(layer)
    d_in = wl.spec.dims[layer]
    h = rng.normal(size=(16, d_in)).astype(np.float32)
    x = rng.normal(size=(16, d_in)).astype(np.float32)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    fn = shard_map_compat(
        lambda p, a, b: rdist.tp_update(wl, p, layer, a, b), mesh=mesh,
        in_specs=(rdist.tp_param_specs(wl)[layer], P(), P()), out_specs=P(),
        check_vma=False)
    ref = np.asarray(jax.jit(fn)({k: jnp.asarray(v) for k, v in
                                  p_np.items()}, jnp.asarray(h),
                                 jnp.asarray(x)))
    twl = t_make_workload(name, n_layers=2, d_in=8, d_hidden=12,
                          n_classes=4)
    comm = tdist.MeshComm(default_mesh("cpu"))
    shard = tdist.tp_param_shards([p_np], comm.M, comm.m)[0]
    got = tdist.tp_update(comm, twl, {k: _t(v) for k, v in shard.items()},
                          layer, _t(h), _t(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Sessions at world size 1 (tests/test_session.py:238-268 over all nine
# workloads, both engines)
# ---------------------------------------------------------------------------
def _cfg(workload, engine, **over):
    base = dict(workload=workload, engine=engine, graph="er", n=40, m=160,
                d_in=8, d_hidden=12, n_classes=4, seed=0, device="cpu")
    base.update(over)
    return SessionConfig(**base)


def _assert_exact(s):
    st = s.sync()
    H, _ = full_inference(s.workload, s.params, torch.as_tensor(st.H[0]),
                          *s.graph.coo(), s.graph.in_degree)
    for l, (h, href) in enumerate(zip(st.H, H)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"layer {l}")
    np.testing.assert_allclose(s.query(), H[-1].numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("engine", ["dist", "dist-rc"])
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_dist_session_matches_oracle(name, engine):
    s = InferenceSession.build(_cfg(name, engine))
    report = s.ingest(s.make_stream(18, seed=1), batch_size=6)
    assert report.n_batches == 3
    assert all(r.messages_per_hop for r in report.results)
    assert getattr(s.engine, "bounded_fallback") \
        == (s.workload.agg.algebra == "bounded")
    _assert_exact(s)


@pytest.mark.parametrize("engine", ["dist", "dist-rc"])
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_hot_swap_through_dist_round_trip(name, engine):
    """ripple -> dist -> device mid-stream equals never swapping."""
    a = InferenceSession.build(_cfg(name, "ripple"))
    b = InferenceSession.build(_cfg(name, "ripple"))
    ups = list(a.make_stream(24, seed=1).updates)
    a.ingest(ups, batch_size=4)
    b.ingest(ups[:8], batch_size=4)
    b.swap_engine(engine, mesh=default_mesh("cpu"))
    assert b.engine_name == engine
    b.ingest(ups[8:16], batch_size=4)
    b.swap_engine("device", device="cpu")
    b.ingest(ups[16:], batch_size=4)
    for h_a, h_b in zip(a.sync().H, b.sync().H):
        np.testing.assert_allclose(h_a, h_b, atol=ATOL, rtol=RTOL)
    _assert_exact(b)


@pytest.mark.parametrize("engine", ["dist", "dist-rc"])
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_dist_session_sharded_checkpoint_restore(name, engine, tmp_path):
    """A dist session writes one file per data shard (one here: one rank);
    restore reproduces the snapshot exactly and keeps serving."""
    s = InferenceSession.build(_cfg(name, engine, ckpt_dir=str(tmp_path),
                                    ckpt_every=10_000))
    ups = list(s.make_stream(30, seed=1).updates)
    s.ingest(ups[:15], batch_size=5)
    path = s.checkpoint()
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["n_shards"] == s.engine.ckpt_shards == 1
    H_ckpt = [h.copy() for h in s.sync().H]
    s.ingest(ups[15:], batch_size=5)
    assert s.restore() == 3
    for h, href in zip(s.sync().H, H_ckpt):
        np.testing.assert_array_equal(h, href)
    s.ingest(ups[15:], batch_size=5)
    _assert_exact(s)


@pytest.mark.parametrize("name", ["gc-s", "gs-s", "gc-m", "gi-s", "gc-w",
                                  "gs-max", "gc-min"])
def test_dist_donate_and_async_are_bit_exact(name):
    """Donated (in place) and asynchronous propagation give the bits of the
    copying, synchronous path: the gated-commit contract behind both."""
    outs = []
    for opts in ({"donate": False, "warm": False},
                 {"donate": True, "warm": False},
                 {"donate": True, "async_dispatch": True, "warm": False}):
        s = InferenceSession.build(_cfg(name, "dist", engine_options=opts))
        s.ingest(s.make_stream(12, seed=2), batch_size=4)
        outs.append(s.engine.impl.gather_H())   # drains the pipeline
    for hs in outs[1:]:
        for a, b in zip(outs[0], hs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["dist", "dist-rc"])
@pytest.mark.parametrize("name", ["gs-max", "gc-min"])
def test_dist_edge_added_and_deleted_in_one_batch(name, engine):
    """The max/min propagation takes each edge's net change, as the port's
    device engine does: an edge one batch adds and deletes again leaves no
    candidate behind (ROADMAP.md Queue 3 item 1)."""
    s = InferenceSession.build(_cfg(name, engine))
    g = s.graph
    for u in range(0, 40, 3):
        for v in range(1, 40, 7):
            if u != v and not g.has_edge(u, v):
                s.ingest(UpdateBatch(edges=[EdgeUpdate(u, v, True),
                                            EdgeUpdate(u, v, False)]))
    _assert_exact(s)


def test_stream_cli_dist_on_cpu(capsys):
    from repro_torch.launch.stream import main
    main(["--device", "cpu", "--engine", "dist", "--workload", "gc-min",
          "--n", "80", "--m", "320", "--updates", "40", "--batch-size",
          "10"])
    out = capsys.readouterr().out
    assert "engine=dist" in out and "updates=40" in out


# ---------------------------------------------------------------------------
# 4 ranks: the port over gloo against the reference on 4 virtual devices
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run tests/torch_dist_ranks.py: the reference (its cases over
    REF_PROCS processes) and the 4 port ranks at once, over the
    reference's weights; returns both result sets."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dist_ranks as tdr

    run_dir = str(tmp_path_factory.mktemp("dist_ranks"))
    weights = {}
    for name in tdr.INVERTIBLE + tdr.MONOTONIC:
        wl = r_make_workload(name, n_layers=2, d_in=tdr.D_IN,
                             d_hidden=tdr.D_HID, n_classes=tdr.N_CLS)
        for l, p in enumerate(r_params_to_numpy(
                wl.init_params(jax.random.PRNGKey(0)))):
            weights.update({f"{name}.{l}.{k}": v for k, v in p.items()})
    np.savez(os.path.join(run_dir, "inputs.npz"), **weights)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    roles = [["ref", str(i), str(REF_PROCS)] for i in range(REF_PROCS)] \
        + [["rank", str(r), "4"] for r in range(4)]
    procs = [subprocess.Popen([sys.executable, RUNNER, *role, run_dir],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for role in roles]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"--- {' '.join(p.args[2:4])} (rc {p.returncode}):\n"
              f"{out[-3000:]}" for p, out in zip(procs, outs)
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    res = {"tdr": tdr, "ref": {}, "ref_arrays": {}}
    with open(os.path.join(run_dir, "port.json")) as f:
        res["port"] = json.load(f)
    res["port_arrays"] = dict(np.load(os.path.join(run_dir, "port.npz")))
    for i in range(REF_PROCS):
        with open(os.path.join(run_dir, f"ref{i}.json")) as f:
            res["ref"].update(json.load(f))
        res["ref_arrays"].update(np.load(os.path.join(run_dir,
                                                      f"ref{i}.npz")))
    return res


def _final(res, side, key, name):
    return res[side + "_arrays"][f"{key}/{name}"]


@pytest.mark.parametrize("mode", ["ripple", "rc"])
@pytest.mark.parametrize("name", ["gc-s", "gs-s", "gc-m", "gi-s", "gc-w"])
def test_ranks_invertible_match_reference(ranks, name, mode):
    key = ranks["tdr"].case_key(mode, name, "2x2")
    ref, port = ranks["ref"][key], ranks["port"][key]
    assert len(port["comm"]) == 3
    assert port["comm"] == ref["comm"]
    assert port["affected"] == ref["affected"]
    assert port["oracle_err"] < ranks["tdr"].ORACLE_ATOL
    for l in range(3):
        np.testing.assert_allclose(_final(ranks, "port", key, f"H{l}"),
                                   _final(ranks, "ref", key, f"H{l}"),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["ripple", "rc"])
@pytest.mark.parametrize("name", ["gs-max", "gc-min"])
def test_ranks_monotonic_match_reference(ranks, name, mode):
    """Values within 2e-3, the witness invariant, predictions equal up to
    ties.  The SHRINK counters are not held equal: each package's own
    arithmetic decides which rows change (ROADMAP.md Queue 3 item 4)."""
    key = ranks["tdr"].case_key(mode, name, "2x2")
    port = ranks["port"][key]
    assert port["witnesses_ok"]
    assert port["oracle_err"] < ranks["tdr"].ORACLE_ATOL
    assert all(len(c) == 6 for c in port["comm"])
    for l in range(3):
        np.testing.assert_allclose(_final(ranks, "port", key, f"H{l}"),
                                   _final(ranks, "ref", key, f"H{l}"),
                                   atol=ATOL, rtol=RTOL)
    h_ref = _final(ranks, "ref", key, "H2")
    pred, ref_pred = _final(ranks, "port", key, "H2").argmax(1), \
        h_ref.argmax(1)
    bad = np.nonzero(pred != ref_pred)[0]
    gap = np.abs(h_ref[bad, ref_pred[bad]] - h_ref[bad, pred[bad]])
    assert (gap <= ATOL * (1 + np.abs(h_ref[bad]).max(axis=1))).all()


def test_ranks_rc_communicates_more_than_ripple(ranks):
    """The paper's headline: ripple ships far less than the pull-based
    recompute baseline."""
    comm = {mode: sum(sum(c) for c in ranks["port"][
        ranks["tdr"].case_key(mode, "gc-s", "2x2")]["comm"])
        for mode in ("ripple", "rc")}
    assert comm["rc"] > 3 * comm["ripple"] > 0


def test_ranks_multipod_xpod_matches_reference(ranks):
    key = ranks["tdr"].case_key("ripple", "gc-m", "pod")
    ref, port = ranks["ref"][key], ranks["port"][key]
    assert port["xpod"] == ref["xpod"] and port["xpod"][1] <= port["xpod"][0]
    assert port["comm"] == ref["comm"]
    assert port["affected"] == ref["affected"]
    assert port["oracle_err"] < ranks["tdr"].ORACLE_ATOL


def test_ranks_overflow_commits_nothing(ranks):
    ovf = ranks["port"]["overflow"]
    assert ovf["overflowed"] and ovf["unchanged"]


def test_ranks_donate_and_async_are_bit_exact(ranks):
    assert ranks["port"]["warm_equiv"] == {"gc-s": True, "gs-max": True}


def test_ranks_checkpoint_across_geometries(ranks):
    """Taken on (2, 2) with one file per data shard, restored onto
    (4, 1)."""
    ck = ranks["port"]["ckpt"]
    assert ck["n_shards"] == 2 and ck["files"] == 2
    assert ck["step"] == 3 and ck["n_parts"] == 4
    assert ck["restore_err"] < 1e-6
    assert ck["oracle_err"] < ranks["tdr"].ORACLE_ATOL


def test_ranks_elastic_resize(ranks):
    el = ranks["port"]["elastic"]
    assert el["n_parts"] == 2 and el["M"] == 2
    assert el["max_err"] < 1e-6
    assert el["oracle_err"] < ranks["tdr"].ORACLE_ATOL
