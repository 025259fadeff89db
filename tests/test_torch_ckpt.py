"""The port's checkpoints and update journal (``repro_torch.ckpt``) and the
session's checkpoint half: the reference's format cases, the leaf order
against ``jax.tree_util.tree_flatten``, snapshots and journals written by
either package restored and replayed by the other (invertible, monotonic
and bounded), and the reference's session checkpoint cases on the port's
``ripple`` and ``device`` engines (CPU)."""
import json
import os

import numpy as np
import pytest

import jax
import torch

from repro.api import InferenceSession as RefSession
from repro.ckpt import UpdateJournal as RefJournal
from repro.ckpt import restore_pytree as ref_restore_pytree
from repro.ckpt import save_pytree as ref_save_pytree
from repro.core import DynamicGraph as RefGraph
from repro.core import erdos_renyi, make_workload, params_to_numpy
from repro.data.streams import snapshot_split

import repro_torch.core.graph as tgraph
from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.ckpt import (CheckpointManager, UpdateJournal,
                              restore_pytree, save_pytree)
from repro_torch.ckpt.checkpoint import (latest_step, tree_flatten,
                                         tree_unflatten)
from repro_torch.core.engine import RippleEngine
from repro_torch.core.full import full_inference
from repro_torch.core.state import InferenceState
from repro_torch.core.state import params_to_numpy as t_params_to_numpy
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy
from repro_torch.data.streams import make_stream as t_make_stream
from repro_torch.data.streams import snapshot_split as t_snapshot_split

ATOL = RTOL = 2e-3
ENGINES = ("ripple", "device")
FAMILIES = ("gc-s", "gs-max", "gp-m")   # invertible, monotonic, bounded


# -- the reference's format cases (tests/test_fault_tolerance.py) ----------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": [np.ones(5), {"c": np.zeros((2, 2))}]}
    save_pytree(tree, str(tmp_path), 7)
    got, step = restore_pytree(tree, str(tmp_path))
    assert step == 7
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"][1]["c"], tree["b"][1]["c"])


def test_sharded_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(28, dtype=np.float32).reshape(7, 4),
            "b": np.arange(9, dtype=np.int64), "step": np.int64(3)}
    d = save_pytree(tree, str(tmp_path), 3, n_shards=4)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["n_shards"] == 4
    sharded = [e for e in man["leaves"] if isinstance(e, dict)]
    assert sharded and all(len(e["files"]) == 4 and e["axis"] == 0
                           for e in sharded)
    assert any(isinstance(e, str) for e in man["leaves"])   # the scalar
    got, step = restore_pytree(tree, str(tmp_path))
    assert step == 3
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"], tree["b"])
    # and the reference reassembles the port's shards, and the port the
    # reference's
    got, _ = ref_restore_pytree(tree, str(tmp_path))
    np.testing.assert_array_equal(got["a"], tree["a"])
    ref_save_pytree(tree, str(tmp_path / "ref"), 5, n_shards=3)
    got, step = restore_pytree(tree, str(tmp_path / "ref"))
    assert step == 5
    np.testing.assert_array_equal(got["a"], tree["a"])


def test_bf16_leaves_save_as_the_reference_saves_them(tmp_path):
    """A bf16 tree (an LM's parameters) saves through the port's
    CheckpointManager, each leaf the same 2-byte words as the reference's
    file of the same values."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    vals = {"w": rng.normal(size=(4, 3)), "b": [rng.normal(size=5)]}
    ref_save_pytree(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 vals), str(tmp_path / "ref"), 0)
    ours = jax.tree.map(lambda a: torch.as_tensor(a).to(torch.bfloat16),
                        vals)
    assert CheckpointManager(str(tmp_path / "port")).maybe_save(ours, 0)
    got, _ = restore_pytree(ours, str(tmp_path / "port"))
    want, _ = ref_restore_pytree(ours, str(tmp_path / "ref"))
    for g, w, t in zip(tree_flatten(got), tree_flatten(want),
                       tree_flatten(ours)):
        assert g.dtype.itemsize == w.dtype.itemsize == 2
        assert np.array_equal(g.view(np.int16), w.view(np.int16))
        assert np.array_equal(g.view(np.int16), t.view(torch.int16).numpy())


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    for i in range(5):
        mgr.maybe_save({"x": np.full(3, i)}, i)
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    got, step = mgr.restore({"x": np.zeros(3)})
    assert step == 4 and got["x"][0] == 4
    assert not CheckpointManager(str(tmp_path), every=3).maybe_save(
        {"x": np.zeros(3)}, 4)


def test_uncommitted_snapshot_is_invisible(tmp_path):
    """A crash mid-save leaves a directory without _COMMITTED (or a .tmp):
    neither is restored, and the manifest layout is the reference's."""
    save_pytree({"x": np.arange(3)}, str(tmp_path), 1)
    d = save_pytree({"x": np.arange(3) + 1}, str(tmp_path), 2)
    os.remove(os.path.join(d, "_COMMITTED"))
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1
    got, step = restore_pytree({"x": np.zeros(3)}, str(tmp_path))
    assert step == 1 and got["x"].tolist() == [0, 1, 2]
    assert restore_pytree({"x": 0}, str(tmp_path), step=2) == (None, -1)
    assert restore_pytree({"x": 0}, str(tmp_path / "none")) == (None, -1)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        man = json.load(f)
    assert set(man) == {"step", "treedef", "n_shards", "leaves"}
    assert man["leaves"] == ["leaf_00000.npy"]
    with pytest.raises(ValueError, match="structure changed"):
        restore_pytree({"x": 0, "y": 0}, str(tmp_path))


def _t_engine(seed=0):
    wl = t_make_workload("gc-s", n_layers=2, d_in=8, d_hidden=12,
                         n_classes=4)
    src, dst, w = erdos_renyi(50, 200, seed=seed)
    g = tgraph.DynamicGraph(50, src, dst, w)
    x = np.random.default_rng(seed).normal(size=(50, 8)).astype(np.float32)
    params = wl.init_params(torch.Generator().manual_seed(seed),
                            device="cpu")
    state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
    return wl, g, params, state


def test_journal_replay_recovers_exact_state(tmp_path):
    """Crash after the last batch: restore the snapshot of batch 3 and
    replay the journal from 4 == no crash."""
    wl, g, params, state = _t_engine()
    p_np = t_params_to_numpy(params)
    eng = RippleEngine(wl, p_np, g, state)
    journal = UpdateJournal(str(tmp_path / "updates.jsonl"))
    snap_dir = str(tmp_path / "snaps")
    _, holdout = t_snapshot_split(*g.coo(), 0.0)
    batches = list(t_make_stream(g, holdout, 30, 8, seed=3).batches(5))

    def tree(st, graph):
        return {"H": st.H, "S": st.S, "k": st.k,
                "edges": np.stack(graph.coo()[:2]), "w": graph.coo()[2]}

    snapshot_at = 3
    for i, b in enumerate(batches):
        assert journal.append(b) == i
        eng.apply_batch(b)
        if i == snapshot_at:
            save_pytree(tree(state, g), snap_dir, i)
    final_H = [h.copy() for h in state.H]
    snap, step = restore_pytree(tree(state, g), snap_dir)
    assert step == snapshot_at
    g2 = tgraph.DynamicGraph(50, snap["edges"][0], snap["edges"][1],
                             snap["w"])
    state2 = InferenceState(H=[h.copy() for h in snap["H"]],
                            S=[s.copy() for s in snap["S"]],
                            k=snap["k"].copy())
    eng2 = RippleEngine(wl, p_np, g2, state2)
    for _jid, batch in journal.replay(snapshot_at + 1):
        eng2.apply_batch(batch)
    for h1, h2 in zip(final_H, state2.H):
        np.testing.assert_array_equal(h1, h2)
    journal.close()


def test_journal_truncate_and_float_bits(tmp_path):
    """float32 features survive the JSON text bit for bit; truncate keeps
    ids < n and the next append gets id n; a reopened journal counts its
    lines."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(4, 6)).astype(np.float32) * np.float32(1e-3)
    vals[0, 0] = np.float32(np.pi)
    vals[0, 1] = np.nextafter(np.float32(1), np.float32(2))
    path = str(tmp_path / "j" / "updates.jsonl")
    j = UpdateJournal(path)
    for v in vals:
        j.append(tgraph.UpdateBatch(
            edges=[tgraph.EdgeUpdate(1, 2, True, 0.1)],
            features=[tgraph.FeatureUpdate(3, v)]))
    got = [b.features[0].value for _i, b in j.replay(0)]
    np.testing.assert_array_equal(np.stack(got).view(np.uint32),
                                  vals.view(np.uint32))
    j.truncate(2)
    assert j.next_id == 2 and [i for i, _ in j.replay(0)] == [0, 1]
    assert j.append(tgraph.UpdateBatch()) == 2
    j.close()
    assert UpdateJournal(path).next_id == 3
    assert not os.path.exists(path + ".tmp")


# -- the leaf order: jax.tree_util.tree_flatten without JAX ----------------
def _pair(name, tmp_path=None, n=40, m=170, t_engine="ripple"):
    """A reference session and a port session over the same graph, split,
    features and weights; with ``tmp_path`` both journal and snapshot
    into ``tmp_path/ref`` and ``tmp_path/port``."""
    wl = make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    params = wl.init_params(jax.random.PRNGKey(0))
    src, dst, w = erdos_renyi(n, m, seed=0, weighted=wl.spec.weighted)
    snap, hold = snapshot_split(src, dst, w, 0.1, seed=0)
    x = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    ck = {} if tmp_path is None else dict(ckpt_every=10_000)
    ref = RefSession.bootstrap(
        wl, params, x, RefGraph(n, *snap), "ripple", holdout=hold,
        ckpt_dir="" if tmp_path is None else str(tmp_path / "ref"), **ck)
    twl = t_make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    port = InferenceSession.bootstrap(
        twl, params_from_numpy(twl, params_to_numpy(params), "cpu"), x,
        tgraph.DynamicGraph(n, *snap), t_engine, device="cpu", holdout=hold,
        ckpt_dir="" if tmp_path is None else str(tmp_path / "port"), **ck)
    return ref, port


def test_flatten_matches_jax_on_nested_trees():
    leaf = [np.float32(i) for i in range(9)]
    tree = {"w": leaf[0], "C": [None, leaf[1]], "A": [{}, {"s1": leaf[2],
            "mx": leaf[3]}], "H": (leaf[4], [leaf[5], []]), "dst": None,
            "k": {"b": leaf[6], "a": {"z": leaf[7], "Y": leaf[8]}},
            "eps": [{}, [], None]}
    want, treedef = jax.tree_util.tree_flatten(tree)
    got = tree_flatten(tree)
    assert len(got) == len(want) and all(a is b for a, b in zip(got, want))
    new = [np.float32(100 + i) for i in range(len(got))]
    assert tree_unflatten(tree, new) == jax.tree_util.tree_unflatten(treedef,
                                                                     new)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, new + [0])


@pytest.mark.parametrize("name", ["gc-s", "gs-max", "gp-m", "ga-s"])
def test_flatten_matches_jax_on_session_trees(name):
    """The session trees (C for gs-max; A with its {} placeholder and eps
    for gp-m and ga-s): the port's flattening gives jax's leaves in jax's
    order, on either package's tree, and the key sets are equal."""
    ref, port = _pair(name)
    t_ref, t_port = ref._ckpt_tree(), port._ckpt_tree()
    assert set(t_ref) == set(t_port)
    assert ("C" in t_port) == (name == "gs-max")
    assert ("A" in t_port) == (name in ("gp-m", "ga-s"))
    for tree in (t_ref, t_port):
        want = jax.tree_util.tree_leaves(tree)
        got = tree_flatten(tree)
        assert len(got) == len(want)
        assert all(a is b for a, b in zip(got, want))
    for a, b in zip(tree_flatten(t_ref), tree_flatten(t_port)):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


# -- either package's snapshot + journal in the other ---------------------
def _assert_close_states(got, want, label):
    for l, (h, href) in enumerate(zip(got.H, want.H)):
        np.testing.assert_allclose(h, href, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label} H[{l}]")


@pytest.mark.parametrize("t_engine", ENGINES)
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cross_package_restore_and_replay(tmp_path, name, writer, t_engine):
    """One package snapshots at step 3 and journals 3 more batches; a
    session of the other package attaches to the same directory (its step
    is the journal's length), restores with replay to step 6, then rewinds
    to the snapshot without replay."""
    ref, port = _pair(name, tmp_path, t_engine=t_engine)
    w, r = (ref, port) if writer == "ref" else (port, ref)
    updates = list(w.make_stream(30, seed=1).updates)
    w.ingest(updates[:15], batch_size=5)
    w.checkpoint()
    snap_H = [h.copy() for h in w.sync().H]
    snap_S = [s.copy() for s in w.state.S]
    snap_coo = [a.copy() for a in w.graph.coo()]
    w.ingest(updates[15:], batch_size=5)
    tip = w.sync()
    # the reader is a fresh session over the writer's directory
    src_dir = w.ckpt_dir
    r = (RefSession if writer == "port" else InferenceSession)(
        r.workload, r.params, r.graph, r.state, r.engine_name,
        ckpt_dir=src_dir, ckpt_every=10_000,
        **({"device": "cpu"} if writer == "ref" else {}))
    assert r.step == 6
    assert r.restore(replay=True) == 3 and r.step == 6
    _assert_close_states(r.sync(), tip, f"{writer}->replay")
    np.testing.assert_allclose(r.query(), w.query(), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(r.predict(), w.predict())
    assert r.restore(step=3) == 3 and r.step == 3 == r.journal.next_id
    st = r.sync()
    for h, href in zip(st.H, snap_H):
        np.testing.assert_array_equal(h, href)
    for s, sref in zip(st.S[1:], snap_S[1:]):
        np.testing.assert_array_equal(s, sref)
    for a, b in zip(r.graph.coo(), snap_coo):   # the graph rewound too
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r.graph.in_degree, st.k)
    assert sorted(os.listdir(src_dir)) == ["step_00000003", "updates.jsonl"]


def test_journals_decode_identically_across_packages(tmp_path):
    ref, port = _pair("gc-w", tmp_path)
    stream = port.make_stream(40, seed=1)
    batches = list(stream.batches(8))
    tj = UpdateJournal(str(tmp_path / "t.jsonl"))
    rj = RefJournal(str(tmp_path / "r.jsonl"))
    for b in batches:
        tj.append(b)
        rj.append(b)
    with open(tmp_path / "t.jsonl") as f1, open(tmp_path / "r.jsonl") as f2:
        assert f1.read() == f2.read()
    for (i, a), (j, b) in zip(UpdateJournal(str(tmp_path / "r.jsonl"))
                              .replay(0), RefJournal(str(tmp_path /
                                                         "t.jsonl"))
                              .replay(0)):
        assert i == j
        assert [(e.src, e.dst, e.add, e.weight) for e in a.edges] \
            == [(e.src, e.dst, e.add, e.weight) for e in b.edges]
        for fa, fb in zip(a.features, b.features):
            assert fa.vertex == fb.vertex
            np.testing.assert_array_equal(fa.value.view(np.uint32),
                                          fb.value.view(np.uint32))


# -- the reference's session cases on the port's engines -------------------
def _session(workload, engine, tmp_path, **over):
    cfg = dict(workload=workload, engine=engine, graph="er", n=40, m=160,
               d_in=8, d_hidden=12, n_classes=5, seed=0, device="cpu",
               ckpt_dir=str(tmp_path), ckpt_every=10_000)
    cfg.update(over)
    return InferenceSession.build(SessionConfig(**cfg))


def _assert_session_exact(s, label=""):
    st = s.sync()
    H, _ = full_inference(s.workload, s.params, torch.as_tensor(st.H[0]),
                          *s.graph.coo(), s.graph.in_degree)
    for l, (h, href) in enumerate(zip(st.H, H)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label} layer {l}")
    np.testing.assert_allclose(s.query(), H[-1].numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_restore_roundtrip(tmp_path, engine):
    s = _session("gs-s", engine, tmp_path)
    updates = list(s.make_stream(40, seed=1))
    s.ingest(updates[:20], batch_size=5)
    s.checkpoint()
    step_at_ckpt = s.step
    H_at_ckpt = [h.copy() for h in s.sync().H]
    coo_at_ckpt = [a.copy() for a in s.graph.coo()]
    s.ingest(updates[20:], batch_size=5)
    assert s.step > step_at_ckpt
    assert s.restore() == step_at_ckpt == s.step
    for h, href in zip(s.sync().H, H_at_ckpt):
        np.testing.assert_array_equal(h, href)
    for a, b in zip(s.graph.coo(), coo_at_ckpt):
        np.testing.assert_array_equal(a, b)
    s.ingest(updates[20:], batch_size=5)
    _assert_session_exact(s)


@pytest.mark.parametrize("engine", ENGINES)
def test_restore_with_journal_replay_reaches_tip(tmp_path, engine):
    s = _session("gc-s", engine, tmp_path)
    updates = list(s.make_stream(30, seed=1))
    s.ingest(updates[:15], batch_size=5)
    s.checkpoint()
    s.ingest(updates[15:], batch_size=5)
    tip_step = s.step
    H_tip = [h.copy() for h in s.sync().H]
    s.restore(replay=True)
    assert s.step == tip_step
    for h, href in zip(s.sync().H, H_tip):
        np.testing.assert_allclose(h, href, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_restore_without_replay_rolls_back_journal(tmp_path, engine):
    s = _session("gc-s", engine, tmp_path)
    updates = list(s.make_stream(30, seed=1))
    s.ingest(updates[:10], batch_size=5)
    s.checkpoint()
    s.ingest(updates[10:20], batch_size=5)   # journaled, then rolled back
    s.restore()                              # no replay: timeline rewinds
    assert s.journal.next_id == s.step == 2
    s.ingest(updates[20:], batch_size=5)     # new timeline, ids 2..3
    tip = [h.copy() for h in s.sync().H]
    assert s.restore(replay=True) == 2 and s.step == 4
    for h, href in zip(s.sync().H, tip):
        np.testing.assert_allclose(h, href, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_restore_older_step_prunes_newer_snapshots(tmp_path, engine):
    s = _session("gc-s", engine, tmp_path)
    updates = list(s.make_stream(20, seed=1))
    s.ingest(updates[:10], batch_size=5)
    s.checkpoint()                            # snapshot at step 2
    s.ingest(updates[10:], batch_size=5)
    s.checkpoint()                            # snapshot at step 4
    assert s.restore(step=2) == 2
    assert s.journal.next_id == s.step == 2
    assert not (tmp_path / "step_00000004").exists()
    assert s.restore() == 2                   # latest is the rewound step
    assert s.step == 2


@pytest.mark.parametrize("engine", ENGINES)
def test_ckpt_every_and_attach_to_existing_journal(tmp_path, engine):
    """apply_one checkpoints every ckpt_every steps (keeping ckpt_keep); a
    session attached to the directory starts at the journal's length and
    recovers the first one's state from snapshot + replay."""
    s = _session("gc-s", engine, tmp_path, ckpt_every=2, ckpt_keep=2)
    s.ingest(list(s.make_stream(35, seed=1)), batch_size=5)
    assert s.step == 7
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) \
        == ["step_00000004", "step_00000006"]
    tip = s.query()
    s2 = _session("gc-s", engine, tmp_path)
    assert s2.step == 7
    assert s2.restore(replay=True) == 6 and s2.step == 7
    np.testing.assert_allclose(s2.query(), tip, atol=1e-6, rtol=1e-6)
    s.journal.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_roundtrips_contributors(tmp_path, engine):
    s = _session("gc-min", engine, tmp_path, m=170)
    updates = list(s.make_stream(30, seed=1))
    s.ingest(updates[:15], batch_size=5)
    s.checkpoint()
    C_at_ckpt = [c.copy() for c in s.sync().C]
    s.ingest(updates[15:], batch_size=5)
    assert s.restore() >= 0
    for c, cref in zip(s.sync().C, C_at_ckpt):
        np.testing.assert_array_equal(c, cref)
    s.ingest(updates[15:], batch_size=5)
    _assert_session_exact(s, "post-restore")


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_restore_roundtrips_bounded_aux(tmp_path, engine):
    s = _session("ga-s", engine, tmp_path, m=170)
    updates = list(s.make_stream(30, seed=1))
    s.ingest(updates[:15], batch_size=5)
    s.checkpoint()
    st = s.sync()
    aux_at_ckpt = [{nm: a.copy() for nm, a in layer.items()}
                   for layer in st.A]
    eps_at_ckpt = st.eps.copy()
    s.ingest(updates[15:], batch_size=5)
    assert s.restore() >= 0
    st = s.sync()
    assert st.A is not None and st.A[0] == {}
    for layer, ref in zip(st.A, aux_at_ckpt):
        assert set(layer) == set(ref)
        for nm in layer:
            np.testing.assert_array_equal(layer[nm], ref[nm])
            assert layer[nm].dtype == ref[nm].dtype
    np.testing.assert_array_equal(st.eps, eps_at_ckpt)
    s.ingest(updates[15:], batch_size=5)
    _assert_session_exact(s, "post-restore serving")


@pytest.mark.parametrize("engine", ENGINES)
def test_restore_then_replay_rebuilds_cache(tmp_path, engine):
    s = _session("gp-m", engine, tmp_path, m=170)
    updates = list(s.make_stream(30, seed=2))
    s.ingest(updates[:12], batch_size=4)
    s.checkpoint()
    s.ingest(updates[12:24], batch_size=4)
    tip_step = s.step
    H_tip = [h.copy() for h in s.sync().H]
    s.restore(replay=True)
    assert s.step == tip_step
    for h, href in zip(s.sync().H, H_tip):
        np.testing.assert_allclose(h, href, atol=1e-6, rtol=1e-6)
    s.ingest(updates[24:], batch_size=4)
    _assert_session_exact(s, f"{engine} post-replay")


def test_session_without_ckpt_dir_refuses():
    s = InferenceSession.build(SessionConfig(
        n=30, m=100, d_in=4, d_hidden=4, n_classes=2, device="cpu"))
    assert s.journal is None
    with pytest.raises(RuntimeError, match="ckpt_dir"):
        s.checkpoint()
    with pytest.raises(RuntimeError, match="ckpt_dir"):
        s.restore()


def test_stream_cli_writes_snapshots(tmp_path, capsys):
    from repro_torch.launch.stream import main
    main(["--device", "cpu", "--workload", "gs-max", "--n", "80", "--m",
          "320", "--updates", "60", "--batch-size", "10", "--ckpt-dir",
          str(tmp_path), "--ckpt-every", "3"])
    assert "updates=60" in capsys.readouterr().out
    assert sorted(n for n in os.listdir(tmp_path)) \
        == ["step_00000003", "step_00000006", "updates.jsonl"]
    with open(tmp_path / "updates.jsonl") as f:
        assert sum(1 for _ in f) == 6
