"""Neighbour sampler for minibatch training (GraphSAGE-style fanout), the
port of ``repro``'s ``models/gnn/sampler.py``: NumPy on the host, the same
draws from the same seed, so a seed and an in-CSR give the reference's
block.  The tensors for the device are made by the caller.

The ``minibatch_lg`` shape's "fanout 15-10" is a 2-layer sample: 1,024
seeds, <=15 in-neighbours each, then <=10 for the next hop.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SampledBlock(NamedTuple):
    node_ids: np.ndarray    # [n_cap] global ids (padded with -1)
    n_nodes: int            # static capacity
    src: np.ndarray         # [m_cap] local ids into node_ids
    dst: np.ndarray         # [m_cap]
    edge_mask: np.ndarray   # [m_cap]
    seeds: int              # first `seeds` node slots are the targets


class NeighborSampler:
    """Uniform fanout sampling over an in-CSR (host-side, NumPy)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]) -> SampledBlock:
        layers = [seeds.astype(np.int64)]
        edges_src, edges_dst = [], []
        frontier = seeds.astype(np.int64)
        for f in fanouts:
            nbrs_all, dsts_all = [], []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                nbrs = self.indices[lo:hi]
                if nbrs.size > f:
                    nbrs = self.rng.choice(nbrs, size=f, replace=False)
                nbrs_all.append(nbrs)
                dsts_all.append(np.full(nbrs.size, v))
            nbrs_cat = (np.concatenate(nbrs_all) if nbrs_all
                        else np.empty(0, np.int64))
            dst_cat = (np.concatenate(dsts_all) if dsts_all
                       else np.empty(0, np.int64))
            edges_src.append(nbrs_cat)
            edges_dst.append(dst_cat)
            frontier = np.unique(nbrs_cat)
            layers.append(frontier)

        node_ids = np.unique(np.concatenate(layers))
        # seeds must occupy the first slots: stable relabel
        rest = np.setdiff1d(node_ids, seeds, assume_unique=False)
        node_ids = np.concatenate([seeds, rest])
        lookup = {int(g): i for i, g in enumerate(node_ids)}
        src = np.array([lookup[int(u)] for u in np.concatenate(edges_src)],
                       dtype=np.int32)
        dst = np.array([lookup[int(v)] for v in np.concatenate(edges_dst)],
                       dtype=np.int32)
        return SampledBlock(node_ids=node_ids, n_nodes=node_ids.shape[0],
                            src=src, dst=dst,
                            edge_mask=np.ones(src.shape[0], np.float32),
                            seeds=seeds.shape[0])

    def sample_padded(self, seeds: np.ndarray, fanouts: tuple[int, ...],
                      n_cap: int, m_cap: int) -> SampledBlock:
        """Static-shape variant: padded nodes get id -1, padded edges
        ``src = dst = n_cap - 1`` and mask 0 (in range for a gather and
        an ``index_add_``)."""
        b = self.sample(seeds, fanouts)
        if b.n_nodes > n_cap or b.src.shape[0] > m_cap:
            raise ValueError(f"sample overflow {b.n_nodes}/{n_cap} nodes "
                             f"{b.src.shape[0]}/{m_cap} edges")
        pad_n = n_cap - b.n_nodes
        pad_m = m_cap - b.src.shape[0]
        return SampledBlock(
            node_ids=np.pad(b.node_ids, (0, pad_n), constant_values=-1),
            n_nodes=n_cap,
            src=np.pad(b.src, (0, pad_m), constant_values=n_cap - 1),
            dst=np.pad(b.dst, (0, pad_m), constant_values=n_cap - 1),
            edge_mask=np.pad(b.edge_mask, (0, pad_m)),
            seeds=b.seeds)


def sampled_shape_caps(batch_nodes: int, fanouts: tuple[int, ...]
                       ) -> tuple[int, int]:
    """Worst-case (n_cap, m_cap) for a fanout spec."""
    n_cap, m_cap, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        m_cap += layer * f
        layer = layer * f
        n_cap += layer
    return n_cap, m_cap
