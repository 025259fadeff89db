"""Full layer-wise GNN inference (bootstrap + correctness oracle).

The static-graph baseline (paper §2.1): each layer aggregates over *all*
edges with one segment reduction and applies the UPDATE to *all* vertices.
It bootstraps the engine state (H^0..H^L, S^1..S^L) before streaming
updates arrive, and serves as the exact oracle for the incremental
engines.  It runs on the device that ``x`` lies on.
"""
from __future__ import annotations

import numpy as np
import torch

from .workloads import Workload


def aggregate_all(workload: Workload, h: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """One segment reduction over all edges, per the workload's aggregator:
    segment-sum of w_uv * h[u] for the invertible family, segment-max/min
    of h[u] for the monotonic family (empty rows hold the aggregator
    identity, +/-inf)."""
    agg = workload.agg
    if agg.algebra == "monotonic":
        out = torch.full((n, h.shape[1]), agg.identity, dtype=h.dtype,
                         device=h.device)
        lanes = dst[:, None].expand(-1, h.shape[1])
        return out.scatter_reduce_(0, lanes, h[src],
                                   "amax" if agg.sign > 0 else "amin")
    msgs = h[src] * w[:, None]
    return torch.zeros((n, h.shape[1]), dtype=h.dtype,
                       device=h.device).index_add_(0, dst, msgs)


@torch.no_grad()
def full_inference(workload: Workload, params: list, x: torch.Tensor,
                   src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   in_degree: np.ndarray
                   ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Run layer-wise inference over the whole graph.

    ``params`` are the workload's layer modules, on ``x``'s device.
    Returns (H, S): H[l] for l=0..L embeddings, S[l] for l=1..L
    unnormalized aggregates (S[0] is an empty placeholder for index
    alignment).
    """
    dev = x.device
    n = x.shape[0]
    src_t = torch.as_tensor(np.asarray(src, dtype=np.int64), device=dev)
    dst_t = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=dev)
    if workload.spec.weighted:
        w_t = torch.as_tensor(np.asarray(w, dtype=np.float32), device=dev)
    else:
        # edge weights are an edge *property*; only the weighted-sum
        # aggregator consumes them (sum/mean treat every edge as 1)
        w_t = torch.ones(src_t.shape[0], dtype=x.dtype, device=dev)
    k = torch.as_tensor(np.asarray(in_degree, dtype=np.float32), device=dev)
    H = [x]
    S = [torch.zeros((0,), dtype=x.dtype, device=dev)]
    for l in range(workload.spec.n_layers):
        s_l = aggregate_all(workload, H[l], src_t, dst_t, w_t, n)
        H.append(params[l](H[l], workload.normalize(s_l, k)))
        S.append(s_l)
    return H, S
