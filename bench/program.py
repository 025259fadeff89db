"""The system under test as the benchmark drives it: ``repro_torch``'s
``InferenceSession`` over the engine a configuration names.

Everything the benchmark hands the program (graph, features, weights,
batches) it made itself; everything it reads back (embeddings, answers,
counters) goes through this file.
"""
from __future__ import annotations

import importlib

import numpy as np


def load() -> None:
    """Import the program (and load its built kernels)."""
    importlib.import_module("repro_torch.api")
    importlib.import_module("repro_torch.core.device_engine")


def build_session(cfg: dict, weights: list[dict], x: np.ndarray,
                  src: np.ndarray, dst: np.ndarray, device: str,
                  engine_options: dict | None = None):
    """A session bootstrapped on ``device`` over the snapshot ``(src,
    dst)`` with features ``x`` and the benchmark's ``weights`` (tensors
    under the layer equations' names); the engine runs with its default
    options unless ``engine_options`` (tests) names others."""
    from repro_torch.api import InferenceSession
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.workloads import make_workload, params_from_numpy
    wl = make_workload(cfg["workload"], n_layers=cfg["n_layers"],
                       d_in=cfg["d_in"], d_hidden=cfg["d_hidden"],
                       n_classes=cfg["n_classes"])
    params = params_from_numpy(
        wl, [{k: v.detach().cpu().numpy() for k, v in layer.items()}
             for layer in weights], device=device)
    graph = DynamicGraph(cfg["n_vertices"], src, dst)
    return InferenceSession.bootstrap(
        wl, params, x, graph, engine=cfg["engine"], device=device,
        engine_options=dict(engine_options or {}))


def to_update_batch(b):
    """A ``gen.stream.Batch`` as the program's ``UpdateBatch``."""
    from repro_torch.core.graph import EdgeUpdate, FeatureUpdate, UpdateBatch
    edges = [EdgeUpdate(u, v, True) for u, v in
             zip(b.add_src.tolist(), b.add_dst.tolist())]
    edges += [EdgeUpdate(u, v, False) for u, v in
              zip(b.del_src.tolist(), b.del_dst.tolist())]
    feats = [FeatureUpdate(v, b.feat_val[i])
             for i, v in enumerate(b.feat_idx.tolist())]
    return UpdateBatch(edges=edges, features=feats)


def outputs(session) -> tuple[list[np.ndarray], np.ndarray]:
    """Every layer's embeddings and the answers of ``query()`` for every
    vertex, on the host."""
    state = session.sync()
    return [np.array(h) for h in state.H], np.asarray(session.query())


def counters(session) -> dict:
    """The program's counters that per-layer metrics read: the engine's
    overflow retries, its per-hop needed sizes summed over committed
    batches (recipients, edges, pulled lanes, last channel), and each
    kernel's launches.  A counter the program lacks reads None."""
    eng = getattr(session.engine, "impl", None)
    sizes = getattr(eng, "sizes_total", None)
    out = {"retries": getattr(eng, "retries", None),
           "sizes_total": None if sizes is None else np.array(sizes),
           "launches": {}}
    for name in ("extremum_apply", "embedding_bag"):
        try:
            mod = importlib.import_module(f"repro_torch.kernels.{name}")
            out["launches"][name] = getattr(mod, name).launches
        except (ImportError, AttributeError):
            out["launches"][name] = None
    return out


def counter_delta(before: dict, after: dict) -> dict:
    """``after - before`` counter by counter (None where either is)."""
    def diff(a, b):
        return None if a is None or b is None else b - a
    return {"retries": diff(before["retries"], after["retries"]),
            "sizes_total": diff(before["sizes_total"], after["sizes_total"]),
            "launches": {k: diff(before["launches"].get(k), v)
                         for k, v in after["launches"].items()}}
