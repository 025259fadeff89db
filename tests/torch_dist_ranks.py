"""The distributed engines on several ranks, for tests/test_torch_distributed.py.

Two roles, one per process, over the same inputs (``inputs.npz`` in the
run directory: each workload's NumPy weights; the graph, features and
stream come from the seeded NumPy generators both packages share):

    python tests/torch_dist_ranks.py rank R 4 DIR   # the port, rank R of 4
    python tests/torch_dist_ranks.py ref I K DIR    # the JAX package, cases
                                                    # I, I+K, I+2K, ...

A rank process imports ``torch`` and ``repro_torch`` only and joins a gloo
process group of 4 CPU ranks; the JAX process runs the reference's
``shard_map`` over 4 virtual CPU devices (it sets its own XLA_FLAGS before
JAX starts).  Both run the same sessions on the same meshes and write, per
case, each batch's ``messages_per_hop``, affected ids and ``last_xpod``,
and the final state; the ranks also run the port-only checks (overflow,
donation and async, checkpoint across geometries, elastic_resize).  Rank 0
writes ``port.json`` / ``port.npz`` into DIR, JAX process I ``refI.json`` /
``refI.npz`` (the cases split over K processes, to run side by side).
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

N, M_EDGES, D_IN, D_HID, N_CLS = 60, 260, 8, 12, 4
N_UPDATES, BATCH = 15, 5
INVERTIBLE = ("gc-s", "gs-s", "gc-m", "gi-s", "gc-w")
MONOTONIC = ("gs-max", "gc-min")
# (mode, workload, mesh) -- mesh "2x2" is (data 2, model 2); "pod" is
# (pod 2, data 2, model 1) with the partition over ("pod", "data")
CASES = [(mode, wl, "2x2") for mode in ("ripple", "rc")
         for wl in INVERTIBLE + MONOTONIC] + [("ripple", "gc-m", "pod")]
ORACLE_ATOL = 3e-3     # tests/dist_runner.py's bar against the oracle


def case_key(mode: str, wl: str, mesh: str) -> str:
    return f"{mode}/{wl}/{mesh}"


def inputs(pkg, wl_name: str):
    """(snapshot (src, dst, w), holdout, features) from the seeded NumPy
    generators, through package ``pkg``'s own copies of them."""
    graph_mod, streams = pkg
    weighted = wl_name == "gc-w"
    src, dst, w = graph_mod.erdos_renyi(N, M_EDGES, seed=0,
                                        weighted=weighted)
    snap, hold = streams.snapshot_split(src, dst, w, 0.1, seed=0)
    x = np.random.default_rng(0).normal(size=(N, D_IN)).astype(np.float32)
    return snap, hold, x


def record(session, report) -> dict:
    """Each batch's messages_per_hop and affected ids, the last xpod."""
    xp = session.engine.impl.last_xpod
    return dict(comm=[[int(c) for c in r.messages_per_hop]
                      for r in report.results],
                affected=[[int(v) for v in r.affected]
                          for r in report.results],
                xpod=None if xp is None else [int(v) for v in xp])


def final_state(session) -> dict:
    st = session.sync()
    arrs = {f"H{l}": np.asarray(h) for l, h in enumerate(st.H)}
    arrs.update({f"S{l}": np.asarray(s) for l, s in enumerate(st.S) if l})
    if st.C is not None:
        arrs.update({f"C{l}": np.asarray(c) for l, c in enumerate(st.C)
                     if l})
    return arrs


# ---------------------------------------------------------------------------
# The JAX reference on 4 virtual devices
# ---------------------------------------------------------------------------
def run_reference(shard: int, n_shards: int, run_dir: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from repro.api import InferenceSession
    from repro.core import graph as rgraph
    from repro.core import make_workload
    from repro.data import streams as rstreams
    from repro.utils import make_mesh_compat

    assert jax.device_count() == 4, jax.devices()
    params = np.load(os.path.join(run_dir, "inputs.npz"))
    meshes = {"2x2": (make_mesh_compat((2, 2), ("data", "model")),
                      ("data",)),
              "pod": (make_mesh_compat((2, 2, 1), ("pod", "data", "model")),
                      ("pod", "data"))}
    results, arrays = {}, {}
    for mode, wl_name, mesh_name in CASES[shard::n_shards]:
        key = case_key(mode, wl_name, mesh_name)
        wl = make_workload(wl_name, n_layers=2, d_in=D_IN, d_hidden=D_HID,
                           n_classes=N_CLS)
        p = [{k.split(".", 2)[2]: params[k] for k in params.files
              if k.startswith(f"{wl_name}.{l}.")}
             for l in range(wl.spec.n_layers)]
        snap, hold, x = inputs((rgraph, rstreams), wl_name)
        mesh, axes = meshes[mesh_name]
        s = InferenceSession.bootstrap(
            wl, p, x, rgraph.DynamicGraph(N, *snap),
            "dist" if mode == "ripple" else "dist-rc", holdout=hold,
            engine_options={"mesh": mesh, "data_axes": axes})
        ups = list(s.make_stream(N_UPDATES, seed=1).updates)
        results[key] = record(s, s.ingest(ups, batch_size=BATCH))
        for k, v in final_state(s).items():
            arrays[f"{key}/{k}"] = v
        print("ref", key, flush=True)
    np.savez(os.path.join(run_dir, f"ref{shard}.npz"), **arrays)
    with open(os.path.join(run_dir, f"ref{shard}.json"), "w") as f:
        json.dump(results, f)


# ---------------------------------------------------------------------------
# The port on 4 gloo ranks
# ---------------------------------------------------------------------------
def run_rank(rank: int, world: int, run_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(run_dir, "store"),
        rank=rank, world_size=world)
    from repro_torch.api import InferenceSession
    from repro_torch.core import graph as tgraph
    from repro_torch.core.full import full_inference
    from repro_torch.core.workloads import make_workload, params_from_numpy
    from repro_torch.data import streams as tstreams

    params = np.load(os.path.join(run_dir, "inputs.npz"))
    meshes = {
        "2x2": (init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("data", "model")),
                ("data",)),
        "pod": (init_device_mesh("cpu", (2, 2, 1),
                                 mesh_dim_names=("pod", "data", "model")),
                ("pod", "data")),
        "4x1": (init_device_mesh("cpu", (4, 1),
                                 mesh_dim_names=("data", "model")),
                ("data",)),
    }

    def session(wl_name, engine, mesh_name, **opts):
        wl = make_workload(wl_name, n_layers=2, d_in=D_IN, d_hidden=D_HID,
                           n_classes=N_CLS)
        p = [{k.split(".", 2)[2]: params[k] for k in params.files
              if k.startswith(f"{wl_name}.{l}.")}
             for l in range(wl.spec.n_layers)]
        snap, hold, x = inputs((tgraph, tstreams), wl_name)
        mesh, axes = meshes[mesh_name]
        return InferenceSession.bootstrap(
            wl, params_from_numpy(wl, p, "cpu"), x,
            tgraph.DynamicGraph(N, *snap), engine, device="cpu",
            holdout=hold, engine_options={"mesh": mesh, "data_axes": axes},
            **opts)

    def oracle_err(s) -> float:
        st = s.sync()
        H, _ = full_inference(s.workload, s.params, torch.as_tensor(st.H[0]),
                              *s.graph.coo(), s.graph.in_degree)
        errs = [float(np.abs(h - href.numpy()).max())
                for h, href in zip(st.H, H)]
        errs.append(float(np.abs(s.query() - H[-1].numpy()).max()))
        return max(errs)

    results, arrays = {}, {}
    for mode, wl_name, mesh_name in CASES:
        key = case_key(mode, wl_name, mesh_name)
        s = session(wl_name, "dist" if mode == "ripple" else "dist-rc",
                    mesh_name)
        ups = list(s.make_stream(N_UPDATES, seed=1).updates)
        res = record(s, s.ingest(ups, batch_size=BATCH))
        res["oracle_err"] = oracle_err(s)
        st = final_state(s)
        if "C1" in st:
            res["witnesses_ok"] = all(
                np.array_equal(np.take_along_axis(
                    st[f"H{l - 1}"], np.maximum(st[f"C{l}"], 0), 0)
                    [st[f"C{l}"] >= 0], st[f"S{l}"][st[f"C{l}"] >= 0])
                for l in (1, 2))
        results[key] = res
        for k, v in st.items():
            arrays[f"{key}/{k}"] = v

    results["overflow"] = check_overflow(session)
    results["warm_equiv"] = check_warm_equiv(session)
    results["ckpt"] = check_ckpt(session, oracle_err, meshes, run_dir)
    results["elastic"] = check_elastic(session, oracle_err, meshes)
    if rank == 0:
        np.savez(os.path.join(run_dir, "port.npz"), **arrays)
        with open(os.path.join(run_dir, "port.json"), "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def check_overflow(session) -> dict:
    """An attempt at caps too small for the batch commits nothing, bit for
    bit, on the donated path; the ladder then lands the batch."""
    from repro_torch.core.graph import UpdateBatch

    s = session("gs-max", "dist", "2x2")
    ups = list(s.make_stream(12, seed=3).updates)
    s.ingest(ups[:6])
    eng = s.engine.impl
    before = eng.gather_H()
    batch = UpdateBatch(edges=[u for u in ups[6:] if hasattr(u, "src")],
                        features=[u for u in ups[6:]
                                  if not hasattr(u, "src")])
    np_b, out_rows, in_rows = eng._route(batch)
    eng.out_csr.refresh_rows(out_rows)
    eng.in_csr.refresh_rows(in_rows)
    db, k = eng._upload_batch(np_b)
    L = s.workload.spec.n_layers
    tiny = (((2, 4),) * L, 4, 4, 4)    # deliberately too small
    st, report = eng._run(db, k, tiny)
    eng._commit_state(st)
    overflowed = eng._read(report, tiny)[0]
    unchanged = all(np.array_equal(a, b)
                    for a, b in zip(before, eng.gather_H()))
    eng._dispatch(db, k)
    eng._resolve()
    return dict(overflowed=bool(overflowed), unchanged=bool(unchanged),
                retries=eng.retries)


def check_warm_equiv(session) -> dict:
    """Donated and asynchronous propagation on (2, 2) give the bits of the
    copying, synchronous path."""
    out = {}
    for name in ("gc-s", "gs-max"):
        Hs = []
        for opts in ({"donate": False, "warm": False},
                     {"donate": True, "warm": False},
                     {"donate": True, "async_dispatch": True,
                      "warm": False}):
            s = session(name, "dist", "2x2")
            s.swap_engine("dist", mesh=s.engine.impl.mesh, **opts)
            s.ingest(s.make_stream(12, seed=2), batch_size=4)
            Hs.append(s.engine.impl.gather_H())
        out[name] = all(np.array_equal(a, b) for hs in Hs[1:]
                        for a, b in zip(Hs[0], hs))
    return out


def check_ckpt(session, oracle_err, meshes, run_dir: str) -> dict:
    """A sharded checkpoint taken on (2, 2) restores onto (4, 1) and keeps
    serving exactly there."""
    s = session("gc-s", "dist", "2x2", ckpt_dir=os.path.join(run_dir, "ckpt"),
                ckpt_every=10_000)
    ups = list(s.make_stream(30, seed=1).updates)
    s.ingest(ups[:15], batch_size=5)
    path = s.checkpoint()
    H_ckpt = [h.copy() for h in s.sync().H]
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    s.ingest(ups[15:], batch_size=5)     # diverge past the snapshot
    # "worker loss": come back up on 4 partitions of one model rank
    s.engine_options = {"mesh": meshes["4x1"][0]}
    step = s.restore()
    restore_err = max(float(np.abs(h - href).max())
                      for h, href in zip(s.sync().H, H_ckpt))
    n_parts = s.engine.impl.n_parts
    s.ingest(ups[15:], batch_size=5)
    return dict(n_shards=man["n_shards"],
                files=len(man["leaves"][0]["files"]), step=step,
                restore_err=restore_err, n_parts=n_parts,
                oracle_err=oracle_err(s))


def check_elastic(session, oracle_err, meshes) -> dict:
    """elastic_resize 4 -> 2 partitions: the same embeddings, and the
    resized engine keeps serving exactly."""
    from repro_torch.core.elastic import elastic_resize

    s = session("gs-s", "dist", "4x1")
    ups = list(s.make_stream(20, seed=1).updates)
    s.ingest(ups[:10], batch_size=5)
    before = s.engine.impl.gather_H()
    resized = elastic_resize(s.engine.impl, meshes["2x2"][0])
    after = resized.gather_H()
    s.engine._impl = resized     # the session serves on through it
    s.ingest(ups[10:], batch_size=5)
    return dict(n_parts=resized.n_parts, M=resized.M,
                max_err=max(float(np.abs(a - b).max())
                            for a, b in zip(before, after)),
                oracle_err=oracle_err(s))


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_reference(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        run_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
