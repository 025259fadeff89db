"""Vertex-wise inference baseline (paper Fig. 1 center / Fig. 8 "DNC").

For each target vertex the full L-hop in-neighborhood computation graph is
expanded and evaluated per target — embeddings of shared neighbors are
recomputed for every target (no cross-target memoization), which is exactly
the redundancy the paper's layer-wise approaches eliminate.
"""
from __future__ import annotations

import numpy as np

from .engine import _np_normalize, _np_update
from .graph import DynamicGraph
from .workloads import Workload


class VertexWiseEngine:
    """Computes exact embeddings per target via recursive expansion."""

    def __init__(self, workload: Workload, params_np: list[dict],
                 graph: DynamicGraph, x: np.ndarray):
        self.wl = workload
        self.params = params_np
        self.g = graph
        self.x = x
        self.ops = 0

    def _h(self, v: int, layer: int) -> np.ndarray:
        if layer == 0:
            return self.x[v]
        nbrs, w = self.g.in_nbrs(v)
        agg = self.wl.agg
        if nbrs.size:
            stack = np.stack([self._h(int(u), layer - 1) for u in nbrs])
            if self.wl.spec.weighted:
                stack = stack * w[:, None]
            if agg.algebra == "invertible":
                S = stack.sum(axis=0)
            elif agg.algebra == "bounded":
                S = agg.aggregate_dense(stack, nbrs.size)
            else:
                S = agg.ufunc.reduce(stack, axis=0)
            self.ops += nbrs.size
        else:
            d_prev = self._h(v, layer - 1).shape[-1]
            if agg.algebra == "bounded":
                # bounded S is the normalized aggregate (x_multiplier wide);
                # empty rows read as zero across the whole tower
                S = np.zeros(d_prev * agg.x_multiplier, dtype=np.float32)
            else:
                S = np.full(d_prev,
                            0.0 if agg.algebra == "invertible"
                            else agg.identity,
                            dtype=np.float32)
        h_prev = self._h(v, layer - 1)
        xagg = _np_normalize(self.wl, S[None, :],
                             np.array([self.g.in_degree[v]]))[0]
        return _np_update(self.wl, self.params, layer - 1, h_prev[None, :],
                          xagg[None, :])[0]

    def infer(self, targets: np.ndarray) -> np.ndarray:
        L = self.wl.spec.n_layers
        return np.stack([self._h(int(v), L) for v in targets])
