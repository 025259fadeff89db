"""Dynamic directed graph store for streaming updates.

The paper (RIPPLE §6) uses "lightweight edge list structures designed to
efficiently handle streaming updates" on the host, in contrast to DGL's
heavyweight graph mutation.  We mirror that: a host-side NumPy CSR with
per-row slack capacity, supporting O(1) amortized edge add/delete, plus
mirrored in-adjacency (needed by the layer-wise recompute baseline to pull
*all* in-neighbors) and an incrementally maintained in-degree vector (needed
for exact ``mean`` aggregation under topology change).

Vertex set is fixed (vertex add/delete is future work in the paper, §8).
Edges are unique (u, v) pairs; each carries a float weight (the static
per-edge weight alpha used by the weighted-sum aggregator; 1.0 otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

_GROW = 1.5  # row slack growth factor
_MIN_SLACK = 4


def flat_row_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized ragged expansion: for each row i, emit
    ``starts[i] + [0..lengths[i])`` concatenated.  O(total) without a
    Python loop — the hot primitive for frontier edge gathering."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    csum = np.cumsum(lengths)
    # within-row offsets: arange(total) minus each row's starting position
    offs = np.arange(total, dtype=np.int64) - np.repeat(csum - lengths, lengths)
    return np.repeat(starts, lengths) + offs


class _AdjHalf:
    """One direction of adjacency (out- or in-) as slacked CSR.

    Rows are stored in a flat ``col``/``w`` pool; ``start[v]`` and ``length[v]``
    delimit vertex v's row; rows have slack so appends are O(1) amortized.
    """

    def __init__(self, n: int, col: np.ndarray, offsets: np.ndarray, w: np.ndarray):
        self.n = n
        deg = np.diff(offsets).astype(np.int64)
        cap = np.maximum((deg * _GROW).astype(np.int64) + _MIN_SLACK, deg)
        start = np.zeros(n, dtype=np.int64)
        np.cumsum(cap[:-1], out=start[1:])
        pool = int(start[-1] + cap[-1]) if n else 0
        self.col = np.full(pool, -1, dtype=np.int64)
        self.w = np.zeros(pool, dtype=np.float32)
        self.start = start
        self.length = deg.copy()
        self.cap = cap
        if deg.sum():
            flat = flat_row_indices(start, deg)
            srcidx = flat_row_indices(offsets[:-1], deg)
            self.col[flat] = col[srcidx]
            self.w[flat] = w[srcidx]

    def row(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, d = self.start[v], self.length[v]
        return self.col[s : s + d], self.w[s : s + d]

    def append(self, v: int, u: int, weight: float) -> None:
        if self.length[v] == self.cap[v]:
            self._grow_row(v)
        s = self.start[v] + self.length[v]
        self.col[s] = u
        self.w[s] = weight
        self.length[v] += 1

    def remove(self, v: int, u: int) -> float:
        s, d = self.start[v], self.length[v]
        row = self.col[s : s + d]
        hits = np.nonzero(row == u)[0]
        if hits.size == 0:
            raise KeyError(f"edge endpoint {u} not in row {v}")
        i = int(hits[0])
        weight = float(self.w[s + i])
        # swap-with-last delete
        self.col[s + i] = self.col[s + d - 1]
        self.w[s + i] = self.w[s + d - 1]
        self.col[s + d - 1] = -1
        self.length[v] -= 1
        return weight

    def _grow_row(self, v: int) -> None:
        old_cap = int(self.cap[v])
        new_cap = int(old_cap * _GROW) + _MIN_SLACK
        # append the grown row at the end of the pool (old slot leaks; pools
        # are compacted wholesale on snapshot() which bounds fragmentation)
        s, d = self.start[v], self.length[v]
        new_start = self.col.shape[0]
        self.col = np.concatenate([self.col, np.full(new_cap, -1, dtype=np.int64)])
        self.w = np.concatenate([self.w, np.zeros(new_cap, dtype=np.float32)])
        self.col[new_start : new_start + d] = self.col[s : s + d].copy()
        self.w[new_start : new_start + d] = self.w[s : s + d].copy()
        self.start[v] = new_start
        self.cap[v] = new_cap

    def to_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compact to (indptr, col, w)."""
        deg = self.length
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        flat = flat_row_indices(self.start, deg)
        return indptr, self.col[flat].copy(), self.w[flat].copy()


@dataclass
class EdgeUpdate:
    """One streaming topology update."""

    src: int
    dst: int
    add: bool  # True = addition, False = deletion
    weight: float = 1.0


@dataclass
class FeatureUpdate:
    """One streaming vertex-feature update."""

    vertex: int
    value: np.ndarray  # new feature vector, shape [d0]


@dataclass
class UpdateBatch:
    """A batch of updates, as routed to the engine by the streaming loop."""

    edges: list[EdgeUpdate] = field(default_factory=list)
    features: list[FeatureUpdate] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.edges) + len(self.features)


class DynamicGraph:
    """Streaming directed graph with O(1) amortized edge add/delete.

    Maintains out- and in-adjacency (both needed: out- for RIPPLE's
    look-forward propagation, in- for the recompute baseline and for full
    layer-wise inference) and the in-degree vector.
    """

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 weight: np.ndarray | None = None):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float32)
        weight = np.asarray(weight, dtype=np.float32)
        self.n = n
        # build CSR out (rows keyed by src) and in (rows keyed by dst)
        order = np.argsort(src, kind="stable")
        out_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=out_off[1:])
        self.out = _AdjHalf(n, dst[order], out_off, weight[order])
        order_in = np.argsort(dst, kind="stable")
        in_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=in_off[1:])
        self.inn = _AdjHalf(n, src[order_in], in_off, weight[order_in])
        self.in_degree = np.bincount(dst, minlength=n).astype(np.float32)
        self._edge_set = set(zip(src.tolist(), dst.tolist()))
        self.num_edges = int(src.shape[0])

    # -- queries ---------------------------------------------------------
    def has_edge(self, u: int, v: int) -> bool:
        return (u, v) in self._edge_set

    def out_nbrs(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        return self.out.row(u)

    def in_nbrs(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        return self.inn.row(v)

    # -- mutation --------------------------------------------------------
    def add_edge(self, u: int, v: int, weight: float = 1.0) -> bool:
        """Returns False (no-op) if the edge already exists."""
        if (u, v) in self._edge_set:
            return False
        self._edge_set.add((u, v))
        self.out.append(u, v, weight)
        self.inn.append(v, u, weight)
        self.in_degree[v] += 1.0
        self.num_edges += 1
        return True

    def delete_edge(self, u: int, v: int) -> float | None:
        """Returns the removed edge's weight, or None if absent (no-op)."""
        if (u, v) not in self._edge_set:
            return None
        self._edge_set.discard((u, v))
        weight = self.out.remove(u, v)
        self.inn.remove(v, u)
        self.in_degree[v] -= 1.0
        self.num_edges -= 1
        return weight

    def apply_topology(self, edges: Sequence[EdgeUpdate]) -> tuple[list[EdgeUpdate], list[EdgeUpdate]]:
        """Apply edge updates; returns (effective_adds, effective_deletes).

        Deletions are returned with the weight the edge had in the store,
        which the engine needs to retract the old contribution exactly.
        No-ops (duplicate adds, missing deletes) are dropped, matching the
        idempotent semantics a production ingest layer provides.
        """
        adds: list[EdgeUpdate] = []
        dels: list[EdgeUpdate] = []
        for e in edges:
            if e.add:
                if self.add_edge(e.src, e.dst, e.weight):
                    adds.append(e)
            else:
                w = self.delete_edge(e.src, e.dst)
                if w is not None:
                    dels.append(EdgeUpdate(e.src, e.dst, False, w))
        return adds, dels

    # -- export ----------------------------------------------------------
    def csr_out(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.out.to_csr()

    def csr_in(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.inn.to_csr()

    def coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) with edges grouped by src."""
        indptr, col, w = self.csr_out()
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
        return src, col, w


def erdos_renyi(n: int, m: int, seed: int = 0, weighted: bool = False
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random simple directed graph with ~m edges (host-side generator)."""
    rng = np.random.default_rng(seed)
    # oversample then dedupe to get close to m unique non-self edges
    k = int(m * 1.3) + 16
    src = rng.integers(0, n, size=k)
    dst = rng.integers(0, n, size=k)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    packed = src * n + dst
    _, idx = np.unique(packed, return_index=True)
    idx = np.sort(idx)[:m]
    src, dst = src[idx].astype(np.int64), dst[idx].astype(np.int64)
    if weighted:
        w = rng.uniform(0.1, 1.0, size=src.shape[0]).astype(np.float32)
    else:
        w = np.ones(src.shape[0], dtype=np.float32)
    return src, dst, w


def powerlaw_graph(n: int, m: int, seed: int = 0, exponent: float = 1.2,
                   weighted: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Preferential-attachment-ish generator: in-degree follows a power law.

    Mimics the skew of social graphs like Reddit (avg in-degree 492, heavy
    tail) at configurable scale for benchmarks.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    k = int(m * 1.3) + 16
    dst = rng.choice(n, size=k, p=p)
    src = rng.integers(0, n, size=k)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    packed = src * n + dst
    _, idx = np.unique(packed, return_index=True)
    idx = np.sort(idx)[:m]
    src, dst = src[idx].astype(np.int64), dst[idx].astype(np.int64)
    if weighted:
        w = rng.uniform(0.1, 1.0, size=src.shape[0]).astype(np.float32)
    else:
        w = np.ones(src.shape[0], dtype=np.float32)
    return src, dst, w
