"""The steady-churn update stream, driven by a traffic file.

A traffic file (``bench/traffic/<name>.json``) gives:

- ``batch``: updates in a batch;
- ``mix``: relative weights of (edge additions, edge deletions, feature
  updates);
- ``skew``: 0 for uniform targets; above 0 deletions fall on edges whose
  destination has rank r with probability ~ (r + 1)^-skew, and feature
  updates on vertices chosen by ``feature_target``;
- ``feature_target``: ``"rank"`` ((r + 1)^-skew) or ``"in_degree"``
  ((in-degree + 1)^skew on the current graph);
- ``feature_scale``: the standard deviation of the new feature values.

The stream tracks the graph itself, so every addition is of an absent edge
and every deletion of a present one, and no edge appears twice in a batch.
Additions take the held-out edges first and then, in the order they left,
the edges the stream deleted: the mix holds and the edge count stays near
the snapshot's however long the stream runs.  Each batch's counts follow
the mix by cumulative rounding, so every seed sees the same sizes.

``next_batch`` makes a batch without changing the tracked state;
``commit`` applies it once the system has taken it.  The tracked state
(``edges``, ``x``) is what the reference runs on after the window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    """One batch of updates as index arrays."""

    add_src: np.ndarray
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    del_pos: np.ndarray     # positions of the deleted edges in the edge table
    feat_idx: np.ndarray
    feat_val: np.ndarray    # [len(feat_idx), d] float32

    def __len__(self) -> int:
        return int(self.add_src.size + self.del_src.size + self.feat_idx.size)


class ChurnStream:
    """Edge and feature churn over a graph of ``n`` vertices."""

    def __init__(self, n: int, snapshot, holdout, x: np.ndarray,
                 traffic: dict, rng: np.random.Generator):
        self.n = n
        self.batch = int(traffic["batch"])
        mix = np.asarray(traffic["mix"], dtype=np.float64)
        if mix.shape != (3,) or mix.min() < 0 or mix.sum() <= 0:
            raise ValueError(f"mix must be 3 non-negative weights: {mix}")
        self.mix = mix / mix.sum()
        self.skew = float(traffic.get("skew", 0.0))
        self.feature_target = traffic.get("feature_target", "rank")
        if self.feature_target not in ("rank", "in_degree"):
            raise ValueError(f"feature_target: {self.feature_target!r}")
        self.feature_scale = float(traffic.get("feature_scale", 1.0))
        self.rng = rng
        self.x = x                      # tracked features [n, d], float32
        s_src, s_dst = snapshot
        h_src, h_dst = holdout
        total = s_src.size + h_src.size
        # present edges: a table with swap-remove deletes
        self.src = np.empty(total, np.int64)
        self.dst = np.empty(total, np.int64)
        self.m = s_src.size
        self.src[:self.m], self.dst[:self.m] = s_src, s_dst
        # absent edges: a ring that additions pop and deletions push
        self.pool_src = np.empty(total, np.int64)
        self.pool_dst = np.empty(total, np.int64)
        self.pool_head, self.pool_size = 0, h_src.size
        self.pool_src[:h_src.size] = h_src
        self.pool_dst[:h_src.size] = h_dst
        self.in_degree = np.bincount(s_dst, minlength=n).astype(np.int64)
        self.made = 0                   # batches made (committed or not)
        if self.skew > 0 and self.feature_target == "rank":
            p = np.arange(1, n + 1, dtype=np.float64) ** (-self.skew)
            self._rank_cdf = np.cumsum(p / p.sum())

    # -- state -------------------------------------------------------------
    @property
    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """The present edges ``(src, dst)`` (views; copy to keep)."""
        return self.src[:self.m], self.dst[:self.m]

    # -- generation --------------------------------------------------------
    def _counts(self, b: int) -> tuple[int, int, int]:
        def cum(i: int, k: int) -> int:
            return int(np.floor(i * self.batch * self.mix[k] + 0.5))
        n_add = cum(b + 1, 0) - cum(b, 0)
        n_del = cum(b + 1, 1) - cum(b, 1)
        n_add = min(n_add, self.batch)
        n_del = min(n_del, self.batch - n_add)
        # an exhausted pool of absent edges leaves its share to features
        n_add = min(n_add, self.pool_size)
        n_del = min(n_del, self.m)
        n_feat = self.batch - n_add - n_del if self.mix[2] > 0 else 0
        return n_add, n_del, n_feat

    def _distinct(self, draw, k: int) -> np.ndarray:
        """``k`` distinct values from repeated calls of ``draw(size)``."""
        got = np.empty(0, np.int64)
        while got.size < k:
            more = draw(2 * (k - got.size) + 8)
            got = np.concatenate([got, more])
            _, first = np.unique(got, return_index=True)
            got = got[np.sort(first)]
        return got[:k]

    def _delete_positions(self, k: int) -> np.ndarray:
        rng = self.rng
        if self.skew <= 0:
            return self._distinct(lambda s: rng.integers(0, self.m, size=s),
                                  k)

        def draw(size: int) -> np.ndarray:
            # rejection: a uniform edge kept with (rank(dst) + 1)^-skew
            out = np.empty(0, np.int64)
            while out.size < size:
                pos = rng.integers(0, self.m, size=4 * size)
                keep = rng.random(pos.size) < \
                    (self.dst[pos] + 1.0) ** (-self.skew)
                out = np.concatenate([out, pos[keep]])
            return out[:size]
        return self._distinct(draw, k)

    def _feature_targets(self, k: int) -> np.ndarray:
        rng = self.rng
        if self.skew <= 0:
            return rng.integers(0, self.n, size=k)
        if self.feature_target == "rank":
            cdf = self._rank_cdf
        else:
            w = (self.in_degree + 1.0) ** self.skew
            cdf = np.cumsum(w / w.sum())
        return np.minimum(np.searchsorted(cdf, rng.random(k), side="right"),
                          self.n - 1)

    def next_batch(self) -> Batch:
        """The next batch against the tracked state; ``commit`` it once the
        system has applied it."""
        n_add, n_del, n_feat = self._counts(self.made)
        self.made += 1
        ring = (self.pool_head + np.arange(n_add)) % self.pool_src.size
        pos = self._delete_positions(n_del)
        fidx = self._feature_targets(n_feat).astype(np.int64)
        fval = (self.rng.standard_normal((n_feat, self.x.shape[1]),
                                         dtype=np.float32)
                * np.float32(self.feature_scale))
        return Batch(add_src=self.pool_src[ring].copy(),
                     add_dst=self.pool_dst[ring].copy(),
                     del_src=self.src[pos].copy(), del_dst=self.dst[pos].copy(),
                     del_pos=pos, feat_idx=fidx, feat_val=fval)

    def commit(self, b: Batch) -> None:
        """Apply ``b`` to the tracked graph and features."""
        k = b.add_src.size
        self.pool_head = (self.pool_head + k) % self.pool_src.size
        self.pool_size -= k
        # deletions: swap-remove from the highest position down
        for p in np.sort(b.del_pos)[::-1]:
            last = self.m - 1
            self.src[p], self.dst[p] = self.src[last], self.dst[last]
            self.m = last
        tail = (self.pool_head + self.pool_size
                + np.arange(b.del_src.size)) % self.pool_src.size
        self.pool_src[tail], self.pool_dst[tail] = b.del_src, b.del_dst
        self.pool_size += b.del_src.size
        self.src[self.m:self.m + k] = b.add_src
        self.dst[self.m:self.m + k] = b.add_dst
        self.m += k
        np.add.at(self.in_degree, b.add_dst, 1)
        np.add.at(self.in_degree, b.del_dst, -1)
        # feature updates: the last one of a vertex wins
        if b.feat_idx.size:
            uniq, last = np.unique(b.feat_idx[::-1], return_index=True)
            self.x[uniq] = b.feat_val[::-1][last]
