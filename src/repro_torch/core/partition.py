"""Balanced edge-cut-minimizing graph partitioning (paper §5.1).

The paper uses METIS.  METIS is not available offline, so this is LDG
(Linear Deterministic Greedy, Stanton & Kliot KDD'12) streaming partitioning
in BFS order: each vertex goes to the partition holding most of its already-
placed neighbors, penalized by fullness -- the same objective METIS optimizes
(balanced vertex counts, minimized edge cuts).  The interface is
partitioner-agnostic so a real METIS can be dropped in on a cluster.

The partition comes out bit-identical to the JAX package's for the same
graph and seed: the generator is drawn in the same order (one
``permutation`` for the BFS roots, then ``n_parts`` uniforms per visited
vertex), because the distributed engine's per-hop communication counts
depend on which vertex lands where.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Partitioning:
    """Vertex partition + relabeling to partition-contiguous global ids."""

    n: int
    n_parts: int
    n_local: int                 # padded per-partition capacity
    part_of: np.ndarray          # [n] partition id per ORIGINAL vertex
    new_of_old: np.ndarray       # [n] relabeled global id (= part*n_local+local)
    old_of_new: np.ndarray       # [n_parts*n_local] inverse; -1 for pad slots

    @property
    def n_pad(self) -> int:
        return self.n_parts * self.n_local

    def local_counts(self) -> np.ndarray:
        return np.bincount(self.part_of, minlength=self.n_parts)


def ldg_partition(n: int, src: np.ndarray, dst: np.ndarray, n_parts: int,
                  seed: int = 0, slack: float = 1.05) -> Partitioning:
    """Greedy streaming partition in BFS order over the undirected view."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])

    capacity = int(np.ceil(n / n_parts * slack))
    part_of = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(n_parts, dtype=np.int64)

    rng = np.random.default_rng(seed)
    visit = _bfs_order(n, indptr, v, rng)
    # the per-vertex tie-break noise: n successive draws of n_parts
    # uniforms each are these rows, in this order
    noise = rng.uniform(0, 1e-6, (n, n_parts))
    for i, x in enumerate(visit):
        placed = part_of[v[indptr[x]: indptr[x + 1]]]
        placed = placed[placed >= 0]
        score = np.zeros(n_parts, dtype=np.float64)
        if placed.size:
            score += np.bincount(placed, minlength=n_parts)
        score *= 1.0 - sizes / capacity  # LDG fullness penalty
        score[sizes >= capacity] = -np.inf
        best = int(np.argmax(score + noise[i]))
        part_of[x] = best
        sizes[best] += 1

    n_local = int(sizes.max())
    # partition-contiguous relabel: the vertices of each part in id order
    fill = np.zeros(n, dtype=np.int64)
    for p in range(n_parts):
        members = part_of == p
        fill[members] = np.arange(int(members.sum()))
    new_of_old = part_of * n_local + fill
    old_of_new = np.full(n_parts * n_local, -1, dtype=np.int64)
    old_of_new[new_of_old] = np.arange(n)
    return Partitioning(n=n, n_parts=n_parts, n_local=n_local,
                        part_of=part_of, new_of_old=new_of_old,
                        old_of_new=old_of_new)


def _bfs_order(n: int, indptr: np.ndarray, adj: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    starts, nbrs = indptr.tolist(), adj.tolist()
    k = 0
    for root in rng.permutation(n).tolist():
        if seen[root]:
            continue
        q = deque([root])
        seen[root] = True
        while q:
            x = q.popleft()
            order[k] = x
            k += 1
            for y in nbrs[starts[x]: starts[x + 1]]:
                if not seen[y]:
                    seen[y] = True
                    q.append(y)
    return order


def edge_cut(part_of: np.ndarray, src: np.ndarray, dst: np.ndarray) -> float:
    """Fraction of edges whose endpoints live in different partitions."""
    if src.size == 0:
        return 0.0
    return float(np.mean(part_of[src] != part_of[dst]))
