"""Quickstart: streaming GNN inference with RIPPLE on one device.

Builds a graph, bootstraps embeddings with a 2-layer GraphSAGE through the
unified ``InferenceSession`` API, streams edge/feature updates through the
incremental engine and shows which vertex labels changed -- the paper's
trigger-based serving loop.  Then it checkpoints, applies one more batch,
and recovers from the snapshot plus the update journal.

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import InferenceSession
from repro_torch.core.graph import (DynamicGraph, EdgeUpdate, FeatureUpdate,
                                    UpdateBatch, erdos_renyi)
from repro_torch.core.workloads import make_workload


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no card is present")
    args = ap.parse_args(argv)

    # 1. a graph + a "trained" model (random weights stand in for one)
    n = 500
    workload = make_workload("gs-s", n_layers=2, d_in=16, d_hidden=32,
                             n_classes=6)
    src, dst, w = erdos_renyi(n, 2500, seed=0)
    graph = DynamicGraph(n, src, dst, w)
    features = np.random.default_rng(0).normal(size=(n, 16)) \
        .astype(np.float32)
    params = workload.init_params(torch.Generator().manual_seed(0),
                                  device=args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # 2. bootstrap: one full layer-wise pass precomputes ALL per-layer
        #    embeddings; every batch is journaled under ckpt_dir
        session = InferenceSession.bootstrap(
            workload, params, features, graph, engine="device",
            device=args.device, ckpt_dir=ckpt_dir, ckpt_every=1000)
        labels_before = session.predict()
        print(f"bootstrapped {n} vertices on {session.device}; initial "
              f"label histogram:", np.bincount(labels_before, minlength=6))

        # 3. stream updates: the engine applies exact delta messages
        batch = UpdateBatch(
            edges=[EdgeUpdate(3, 77, add=True), EdgeUpdate(10, 20, add=False)],
            features=[FeatureUpdate(42, np.ones(16, dtype=np.float32))])
        report = session.ingest(batch)
        stats = report.results[0]
        changed = np.nonzero(labels_before != session.predict())[0]
        print(f"batch of {report.n_updates} updates -> "
              f"{stats.total_affected} vertices touched across hops "
              f"{stats.affected_per_hop}, {stats.wall_seconds * 1e3:.2f} ms")
        print(f"labels changed for vertices: {changed[:20].tolist()}")

        # 4. fault tolerance: snapshot, one more batch, then recover
        session.checkpoint()
        session.ingest(UpdateBatch(edges=[EdgeUpdate(5, 6, add=True)]))
        tip = session.query()
        got = session.restore(replay=True)
        err = float(np.abs(session.query() - tip).max())
        print(f"restored snapshot {got} and replayed the journal to step "
              f"{session.step}: max difference {err:.3g} from the tip")


if __name__ == "__main__":
    main()
