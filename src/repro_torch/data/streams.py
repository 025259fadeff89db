"""Streaming update generation, mirroring the paper's protocol (§7.1.2).

The paper removes a random 10% of edges from each graph to form the initial
snapshot and streams them back as additions; deletions pick random snapshot
edges; feature updates pick random vertices; all three kinds are interleaved
in equal proportion in random order.  Beyond the paper's protocol,
``make_stream`` takes an update-``mix`` ratio (e.g. deletion-heavy streams
that stress the monotonic aggregators' SHRINK path) and a power-law
hot-vertex ``skew`` that concentrates deletions/feature updates on
high-rank vertices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.graph import DynamicGraph, EdgeUpdate, FeatureUpdate, UpdateBatch


@dataclass
class UpdateStream:
    """A pre-generated sequence of updates, sliceable into batches."""

    updates: list  # EdgeUpdate | FeatureUpdate

    def batches(self, batch_size: int):
        for i in range(0, len(self.updates), batch_size):
            chunk = self.updates[i : i + batch_size]
            b = UpdateBatch()
            for u in chunk:
                (b.edges if isinstance(u, EdgeUpdate) else b.features).append(u)
            yield b

    def __len__(self) -> int:
        return len(self.updates)

    def __iter__(self):
        return iter(self.updates)


def snapshot_split(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   holdout_frac: float = 0.1, seed: int = 0):
    """Split edges into (snapshot, holdout) per the paper's 90/10 protocol."""
    rng = np.random.default_rng(seed)
    m = src.shape[0]
    holdout = rng.random(m) < holdout_frac
    keep = ~holdout
    return ((src[keep], dst[keep], w[keep]),
            (src[holdout], dst[holdout], w[holdout]))


def make_stream(graph: DynamicGraph, holdout: tuple[np.ndarray, np.ndarray, np.ndarray],
                n_updates: int, d_feat: int, seed: int = 0,
                feature_scale: float = 1.0,
                mix: tuple[float, float, float] = (1.0, 1.0, 1.0),
                skew: float = 0.0,
                feature_target: str = "rank") -> UpdateStream:
    """Interleaved stream of edge adds / edge deletes / feature updates.

    ``mix`` gives the relative weights of (additions, deletions, feature
    updates) — the paper's protocol is the equal-proportion default; e.g.
    ``mix=(1, 4, 1)`` produces the deletion-heavy streams that exercise the
    monotonic aggregators' SHRINK path.  ``skew > 0`` concentrates deletions
    and feature updates on hot vertices with probability ~ rank^-skew
    (deletions by their destination's hotness), mimicking the head-heavy
    update locality of social graphs instead of the paper's uniform pick.

    ``feature_target`` picks what "hot" means for feature updates when
    ``skew > 0``: ``"rank"`` (default) uses vertex id as rank like
    ``powerlaw_graph``; ``"in_degree"`` draws feature targets with
    probability ~ (in_degree+1)^skew on the *current* graph, which slams
    feature churn into exactly the high-fan-in rows whose cached bounded
    aggregates (softmax normalizers, top-k thresholds, PNA moments) are
    most expensive to refresh — the adversarial workload for the
    bounded-recompute family.

    Feature updates absorb any shortfall when the holdout/snapshot supply
    caps the edge kinds (the paper-protocol behavior) — unless the feature
    weight is exactly 0, in which case the stream honors the zero and may
    hold fewer than ``n_updates`` updates (there is nothing left to
    stream); callers should trust ``len(stream)``, not ``n_updates``.
    """
    rng = np.random.default_rng(seed)
    h_src, h_dst, h_w = holdout
    w = np.asarray(mix, dtype=np.float64)
    if w.min() < 0 or w.sum() <= 0:
        raise ValueError(f"mix must be non-negative with a positive sum: {mix}")
    w = w / w.sum()
    updates: list = []

    if feature_target not in ("rank", "in_degree"):
        raise ValueError(
            f"feature_target must be 'rank' or 'in_degree': {feature_target!r}")

    # hot-vertex distribution (vertex id = rank, like powerlaw_graph)
    p_hot = None
    p_feat = None
    if skew > 0:
        p_hot = np.arange(1, graph.n + 1, dtype=np.float64) ** (-skew)
        p_hot /= p_hot.sum()
        if feature_target == "in_degree":
            p_feat = (graph.in_degree.astype(np.float64) + 1.0) ** skew
            p_feat /= p_feat.sum()
        else:
            p_feat = p_hot

    # targets honor the ratios exactly; rounding overshoot trims deletions
    n_add_t = int(round(n_updates * w[0]))
    n_del_t = max(min(int(round(n_updates * w[1])), n_updates - n_add_t), 0)

    # additions: stream back held-out edges
    n_add = min(n_add_t, h_src.shape[0])
    for i in range(n_add):
        updates.append(EdgeUpdate(int(h_src[i]), int(h_dst[i]), True, float(h_w[i])))

    # deletions: existing snapshot edges, optionally biased to hot dsts
    s_src, s_dst, _ = graph.coo()
    n_del = min(n_del_t, s_src.shape[0])
    if n_del:
        p_edge = None
        if p_hot is not None:
            p_edge = p_hot[s_dst]
            p_edge = p_edge / p_edge.sum()
        idx = rng.choice(s_src.shape[0], size=n_del, replace=False, p=p_edge)
        for i in idx:
            updates.append(EdgeUpdate(int(s_src[i]), int(s_dst[i]), False))

    # vertex feature updates soak up any supply-capped shortfall from the
    # edge kinds (the paper-protocol behavior) — but never when the caller
    # explicitly zeroed the feature weight
    n_feat = max(n_updates - n_add - n_del, 0) if w[2] > 0 else 0
    vs = rng.choice(graph.n, size=n_feat, p=p_feat)
    for v in vs:
        updates.append(FeatureUpdate(int(v),
                                     rng.normal(0, feature_scale, size=d_feat).astype(np.float32)))

    rng.shuffle(updates)
    return UpdateStream(updates=updates)
