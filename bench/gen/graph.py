"""The benchmark's synthetic graph: a power-law in-degree graph and the
paper's 90/10 snapshot split (Ripple §7.1.2).

This is the benchmark's own copy of the generator, so that a change to the
program cannot change the inputs it is measured on.  Vertex ids are ranks:
vertex 0 is the most likely destination, as in the program's generator.
"""
from __future__ import annotations

import numpy as np


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """The root of every random stream of a run.  Any whole number is a
    seed: negative ones are taken modulo 2**64."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


def powerlaw_graph(n: int, m: int, rng: np.random.Generator,
                   exponent: float = 1.2) -> tuple[np.ndarray, np.ndarray]:
    """``(src, dst)``: ``m`` distinct directed edges without self-loops.
    Destinations are drawn with probability ~ (rank + 1)^-exponent, sources
    uniformly; 1.3 m + 16 pairs are drawn, duplicates and loops dropped,
    and the first ``m`` in draw order kept."""
    p = np.arange(1, n + 1, dtype=np.float64) ** (-exponent)
    p /= p.sum()
    k = int(m * 1.3) + 16
    dst = rng.choice(n, size=k, p=p)
    src = rng.integers(0, n, size=k)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    _, first = np.unique(src * n + dst, return_index=True)
    idx = np.sort(first)[:m]
    if idx.size < m:
        raise ValueError(f"drew only {idx.size} distinct edges of {m}")
    return src[idx].astype(np.int64), dst[idx].astype(np.int64)


def snapshot_split(src: np.ndarray, dst: np.ndarray, holdout_frac: float,
                   rng: np.random.Generator):
    """``((src, dst) snapshot, (src, dst) held out)``: each edge is held
    out with probability ``holdout_frac``; the held-out edges come back as
    the stream's additions."""
    out = rng.random(src.shape[0]) < holdout_frac
    return (src[~out], dst[~out]), (src[out], dst[out])
