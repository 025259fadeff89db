"""Aggregator algebra behind RIPPLE: the invertible, monotonic and bounded
families.

**Invertible aggregators** (``sum`` / ``mean`` / ``wsum``).  The aggregate
lives in a group: a contribution can be *retracted* by adding its inverse,
so one delta mailbox per affected vertex is enough::

    S' = S + sum(deltas) + sum(added h_old) - sum(deleted h_old)

``mean`` stays exact because the engines track the *unnormalized* (S, k)
pair and normalize on read.

**Monotonic aggregators** (``max`` / ``min``).  Not invertible -- deleting
the extremum cannot be undone by arithmetic -- but *monotone*: a new
contribution can only move the aggregate one way.  Exact incremental
maintenance tracks, per vertex and per feature dimension, the extremum
itself (in ``S``; the aggregator identity, -inf for max / +inf for min, in
empty rows) and a **contributor ref** ``C[v, d]``: the in-neighbor whose
layer-l embedding attains ``S[l+1][v, d]`` (-1 when the row is empty).
Every incoming message is classified per ``(row, dim)``:

    GROW    the candidate ties or beats the stored extremum: fold it in
            with one elementwise max/min and take it as the witness;
    SHRINK  the tracked contributor's edge was deleted or its value moved
            strictly off the extremum: the cell is re-derived over the
            vertex's current in-neighborhood -- unless a candidate of the
            same batch ties or beats the lost extremum (the re-cover
            probe), which re-witnesses it with no gather at all.

The invariant behind the classification: after every batch
``S[l+1][v, d] == H[l][C[l+1][v, d], d]`` for every non-empty cell.

**Bounded-recompute aggregators** (``attn`` / ``topk`` / ``pna``).  Neither
invertible nor monotonic: softmax attention, top-k and PNA towers reweight
or re-rank a whole neighbourhood per update.  Each vertex caches partial
state in ``A`` (a softmax normalizer + max-logit anchor, the k-th-value
threshold, or running moments with a tracked max), ``S`` stores the
*normalized* aggregate directly (``normalize`` is the identity), and the
device engine re-aggregates every affected row over its in-neighbourhood
with :meth:`BoundedRecomputeAgg.reaggregate`, while the host engines
classify each touched row as an O(1) PATCH of its cache or a REFRESH
(:meth:`BoundedRecomputeAgg.np_patch`).  With ``tolerance > 0`` an
interior-layer write within the certified deferral budget may be skipped;
:func:`certified_error_bound` bounds the published error.

Every aggregator has a torch half (``normalize``, ``reaggregate``) for the
device and the full pass, and a NumPy half (``np_normalize``,
``np_reaggregate``, ``np_patch``, ``aggregate_dense``) for the host engines
of ``core/engine.py`` and ``core/vertexwise.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Aggregator:
    """One aggregation function's algebraic contract."""

    name: str

    @property
    def algebra(self) -> str:
        """Which of the three families: invertible | monotonic | bounded."""
        return "invertible"

    @property
    def tracks_aux(self) -> bool:
        """Does state need per-vertex cached partial state (``A``)?"""
        return False

    @property
    def x_multiplier(self) -> int:
        """Width of the normalized aggregate relative to the input dim
        (PNA's tower concatenates several aggregations per dim)."""
        return 1

    @property
    def weighted(self) -> bool:
        return False

    def normalize(self, S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Aggregate -> UPDATE input (x = norm(S, k))."""
        return S

    def np_normalize(self, S: np.ndarray, k: np.ndarray) -> np.ndarray:
        """NumPy half of :meth:`normalize`, for the host engines."""
        return S


@dataclass(frozen=True)
class InvertibleAgg(Aggregator):
    """Group-structured aggregate: delta mailboxes retract exactly."""

    uses_weights: bool = False
    by_degree: bool = False  # mean: normalize the tracked raw sum by k

    @property
    def weighted(self) -> bool:
        return self.uses_weights

    def normalize(self, S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        if self.by_degree:
            return S / torch.clamp(k, min=1.0)[:, None]
        return S

    def np_normalize(self, S, k):
        if self.by_degree:
            return S / np.maximum(k, 1.0)[:, None]
        return S


@dataclass(frozen=True)
class MonotonicAgg(Aggregator):
    """Order-structured aggregate (max/min) with tracked contributors.

    ``sign`` maps the aggregator into max-space: max has sign=+1, min has
    sign=-1, and all comparisons and reductions run on ``sign * value``.
    """

    sign: float = 1.0

    @property
    def algebra(self) -> str:
        return "monotonic"

    @property
    def identity(self) -> float:
        """Empty-row aggregate (never beats any candidate)."""
        return -self.sign * np.inf

    @property
    def ufunc(self):
        """The NumPy combine ufunc (supports ``.at`` scatter-reduce)."""
        return np.maximum if self.sign > 0 else np.minimum

    def improves(self, a, b):
        """True where ``a`` is strictly better than ``b`` (elementwise)."""
        return a > b if self.sign > 0 else a < b

    def normalize(self, S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        # identity rows (no in-neighbors) read as 0, matching segment_sum's
        # empty-row convention for the invertible family
        return torch.where(torch.isfinite(S), S, 0.0)

    def np_normalize(self, S, k):
        return np.where(np.isfinite(S), S, 0.0)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Segment max of ``vals [E]`` or ``[E, d]`` into ``n_rows`` rows
    (-inf in empty rows); ``seg == n_rows`` lanes land in a trash row."""
    lanes = seg if vals.dim() == 1 else seg[:, None].expand_as(vals)
    out = torch.full((n_rows + 1,) + tuple(vals.shape[1:]), -np.inf,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, lanes, vals, "amax")[:n_rows]


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Rows of ``vals`` summed by segment id into ``n_rows`` rows
    (``seg == n_rows`` lanes land in a trash row).  On a card the atomics
    make the order of the sum vary from run to run."""
    out = torch.zeros((n_rows + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)[:n_rows]


def _np_topk_passes(vals: np.ndarray, seg: np.ndarray, n_rows: int,
                    kk: int) -> tuple[np.ndarray, np.ndarray]:
    """k passes of masked segment-max with single-winner deactivation.

    ``vals [E, d]`` grouped by ``seg [E]``.  Pass p finds each (row, dim)'s
    current maximum, deactivates exactly one witnessing edge (segment-min of
    edge index among the ties), and accumulates the value.  Returns
    ``(x [n_rows, d], theta [n_rows, d])`` where x sums the top-min(kk, deg)
    values per dim and theta is the kk-th largest (-inf when deg < kk)."""
    E, d = vals.shape
    active = np.ones((E, d), dtype=bool)
    xsum = np.zeros((n_rows, d), dtype=np.float32)
    theta = np.full((n_rows, d), -np.inf, dtype=np.float32)
    eidx = np.broadcast_to(np.arange(E, dtype=np.int64)[:, None], (E, d))
    for _ in range(kk):
        cur = np.where(active, vals, -np.inf)
        M = np.full((n_rows, d), -np.inf, dtype=np.float32)
        np.maximum.at(M, seg, cur)
        Mrow = M[seg] if E else M[:0]
        cand = active & (cur == Mrow) & np.isfinite(Mrow)
        widx = np.full((n_rows, d), E, dtype=np.int64)
        np.minimum.at(widx, seg, np.where(cand, eidx, E))
        win = cand & (eidx == widx[seg]) if E else cand
        xsum += np.where(np.isfinite(M), M, 0.0)
        theta = M
        active &= ~win
    return xsum, theta


def topk_passes(vals: torch.Tensor, seg: torch.Tensor, n_rows: int,
                kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch half of :func:`_np_topk_passes` on the tensors' device;
    ``seg == n_rows`` marks padding lanes (they never win a pass)."""
    E, d = vals.shape
    dev = vals.device
    active = (seg < n_rows)[:, None].expand(E, d)
    eidx = torch.arange(E, device=dev)[:, None].expand(E, d)
    lanes = seg[:, None].expand(E, d)
    row = seg.clamp(max=n_rows - 1)
    xsum = torch.zeros((n_rows, d), dtype=vals.dtype, device=dev)
    theta = torch.full((n_rows, d), -np.inf, dtype=vals.dtype, device=dev)
    for _ in range(kk):
        cur = torch.where(active, vals, -np.inf)
        M = _segment_max(cur, seg, n_rows)
        Mrow = M[row]
        cand = active & (cur == Mrow) & torch.isfinite(Mrow)
        widx = torch.full((n_rows + 1, d), E, dtype=torch.int64, device=dev)
        widx = widx.scatter_reduce_(0, lanes, torch.where(cand, eidx, E),
                                    "amin")[:n_rows]
        win = cand & (eidx == widx[row])
        xsum = xsum + torch.where(torch.isfinite(M), M, 0.0)
        theta = M
        active = active & ~win
    return xsum, theta


@dataclass(frozen=True)
class BoundedRecomputeAgg(Aggregator):
    """Neither invertible nor monotonic: the third algebra family.

    Softmax attention, top-k and PNA towers reweight or re-rank a whole
    neighbourhood per update.  Incremental cost stays frontier-proportional
    by caching per-vertex partial state (``InferenceState.A``) and
    re-aggregating only the rows an update touches; the device engine
    re-aggregates every such row (refresh-all), the host ripple engine
    classifies each into an O(1) PATCH or a REFRESH (:meth:`np_patch`).

    Contract notes: ``S`` stores the *normalized* aggregate x directly
    (``normalize`` is the identity); ``x_multiplier`` widens the UPDATE's
    neighbour input (PNA's tower is 3 dims per input dim)."""

    @property
    def algebra(self) -> str:
        return "bounded"

    @property
    def tracks_aux(self) -> bool:
        return True

    @property
    def aux_names(self) -> tuple[str, ...]:
        raise NotImplementedError

    def init_aux(self, n: int, d: int) -> dict[str, np.ndarray]:
        """Empty-row aux arrays (the values a row with no in-neighbours
        holds)."""
        raise NotImplementedError

    def np_reaggregate(self, H_prev, nbr, seg, n_rows, k_rows):
        """Re-aggregate rows from scratch on the host: ``nbr [E]``
        in-neighbour ids grouped by ``seg [E]`` into ``n_rows`` rows with
        in-degrees ``k_rows``.  Returns ``(x [n_rows, d * x_multiplier],
        aux dict)``."""
        raise NotImplementedError

    def np_patch(self, x_rows, aux, k_rows, seg, src, val_old, val_new,
                 has_old, has_new):
        """Classify + patch one hop's messages against cached rows on the
        host.

        ``x_rows [R, d * x_multiplier]`` and ``aux`` (dict of ``[R]`` /
        ``[R, d]`` arrays) are the touched rows' cached state; message
        ``j`` targets row ``seg[j]`` from vertex ``src[j]`` and carries the
        contribution transition ``val_old[j] -> val_new[j]``
        (``has_old``/``has_new`` flag pure adds and deletes).  Returns
        ``(x', aux', refresh [R])``: rows in ``refresh`` must be
        re-aggregated instead (their returned patch values are
        unspecified)."""
        raise NotImplementedError

    def aggregate_dense(self, stack: np.ndarray, k: int) -> np.ndarray:
        """Dense per-row form for the vertexwise baseline:
        ``stack [deg, d] -> x [d * x_multiplier]``."""
        raise NotImplementedError

    def reaggregate(self, vals: torch.Tensor, src: torch.Tensor,
                    seg: torch.Tensor, n_rows: int, k_rows: torch.Tensor):
        """Torch half of :meth:`np_reaggregate` on the tensors' device:
        ``vals [E, d]`` are already-gathered source embeddings with ids
        ``src [E]``; ``seg == n_rows`` marks padding lanes.  Returns
        ``(x [n_rows, d * x_multiplier], aux tuple in aux_names order)``."""
        raise NotImplementedError

    def gain(self, D: float, d: int, kmax: float, M: float) -> float:
        """Certified aggregation gain G(D): a bound on ``|x' - x|_inf``
        when every in-neighbour embedding moves by at most D in inf-norm
        (``d`` input dim, ``kmax`` max in-degree, ``M`` max |H| bound)."""
        raise NotImplementedError


@dataclass(frozen=True)
class AttentionAgg(BoundedRecomputeAgg):
    """Softmax attention over in-neighbours (GAT-style, fixed scoring head):
    ``x_v = sum_u softmax_u(logit(h_u)) * h_u`` with
    ``logit(h) = sum(h)/sqrt(d)``.  Cache per row: the max-logit anchor
    ``m`` (a stale-safe upper bound on every in-neighbour's logit) and the
    normalizer ``z = sum exp(logit - m)``.  Patches rescale the cached mass
    by ``exp(m - m')`` and add/subtract message terms; REFRESH fires on
    normalizer collapse (the delete-the-dominant-logit case), where the
    cancellation would destroy float32 precision."""

    rescale_bound: float = 60.0  # exp() underflow horizon for the rescale
    zmin: float = 1e-12          # absolute normalizer floor
    zrel: float = 1e-3           # z' below this fraction of the absolute
    #                              patched mass -> catastrophic cancellation

    @property
    def aux_names(self) -> tuple[str, ...]:
        return ("m", "z")

    def init_aux(self, n, d):
        return {"m": np.full(n, -np.inf, dtype=np.float32),
                "z": np.zeros(n, dtype=np.float32)}

    @staticmethod
    def logits(vals):
        return vals.sum(axis=-1) / np.float32(np.sqrt(vals.shape[-1]))

    def np_reaggregate(self, H_prev, nbr, seg, n_rows, k_rows):
        d = H_prev.shape[1]
        vals = H_prev[nbr].astype(np.float32, copy=False)
        lg = self.logits(vals)
        m = np.full(n_rows, -np.inf, dtype=np.float32)
        np.maximum.at(m, seg, lg)
        x = np.zeros((n_rows, d), dtype=np.float32)
        z = np.zeros(n_rows, dtype=np.float32)
        if nbr.size:
            e = np.exp(lg - m[seg])
            np.add.at(z, seg, e)
            np.add.at(x, seg, e[:, None] * vals)
        nz = z > 0
        x[nz] /= z[nz, None]
        x[~nz] = 0.0
        return x, {"m": m, "z": z}

    def np_patch(self, x_rows, aux, k_rows, seg, src, val_old, val_new,
                 has_old, has_new):
        R, _ = x_rows.shape
        m, z = aux["m"], aux["z"]
        l_new = np.where(has_new, self.logits(val_new), -np.inf)
        l_old = np.where(has_old, self.logits(val_old), -np.inf)
        m2 = m.copy()
        np.maximum.at(m2, seg, l_new)
        mf = np.where(np.isfinite(m2), m2, 0.0)
        # old-mass rescale: m only ever grows, so factor <= 1; below the
        # rescale bound the old mass is < e^-60 of the new and underflow to
        # 0 is exact at float32 (masked subtract: -inf anchors on both
        # sides would make a nan that the where() discards anyway)
        fin = np.isfinite(m2) & np.isfinite(m)
        dm = np.full_like(m2, -np.inf)
        np.subtract(m, m2, out=dm, where=fin)
        factor = np.where(fin,
                          np.exp(np.maximum(dm, -self.rescale_bound)),
                          0.0).astype(np.float32)
        e_new = np.where(has_new, np.exp(np.minimum(l_new - mf[seg], 0.0)),
                         0.0).astype(np.float32)
        e_old = np.where(has_old,
                         np.exp(np.minimum(l_old - mf[seg],
                                           self.rescale_bound)),
                         0.0).astype(np.float32)
        z_base = z * factor
        dz = np.zeros(R, dtype=np.float32)
        np.add.at(dz, seg, e_new - e_old)
        adz = np.zeros(R, dtype=np.float32)
        np.add.at(adz, seg, e_new + e_old)
        z2 = z_base + dz
        N2 = x_rows * z_base[:, None]
        dN = np.zeros_like(x_rows)
        np.add.at(dN, seg,
                  e_new[:, None] * np.where(has_new[:, None], val_new, 0.0)
                  - e_old[:, None] * np.where(has_old[:, None], val_old, 0.0))
        N2 += dN
        touched = np.zeros(R, dtype=bool)
        touched[seg] = True
        refresh = touched & ((z2 <= self.zmin)
                             | (z2 < self.zrel * (z_base + adz)))
        x2 = np.where((z2 > 0)[:, None],
                      N2 / np.maximum(z2, self.zmin)[:, None], 0.0)
        return x2, {"m": m2, "z": z2}, refresh

    def aggregate_dense(self, stack, k):
        lg = self.logits(stack)
        m = lg.max()
        e = np.exp(lg - m)
        return (e[:, None] * stack).sum(axis=0) / e.sum()

    def reaggregate(self, vals, src, seg, n_rows, k_rows):
        d = vals.shape[1]
        valid = seg < n_rows
        row = seg.clamp(max=n_rows - 1)
        lg = torch.where(valid,
                         vals.sum(-1) / float(np.float32(np.sqrt(d))),
                         -np.inf)
        m = _segment_max(lg, seg, n_rows)
        mf = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(valid, torch.exp(lg - mf[row]), 0.0)
        z = segment_sum(e, seg, n_rows)
        vc = torch.where(valid[:, None], vals, 0.0)
        N = segment_sum(e[:, None] * vc, seg, n_rows)
        x = torch.where((z > 0)[:, None],
                        N / z.clamp(min=self.zmin)[:, None], 0.0)
        return x, (m, z)

    def gain(self, D, d, kmax, M):
        if D <= 0:
            return 0.0
        # softmax weight total variation under a logit perturbation of
        # delta = sqrt(d) * D is <= min(2, 2*(e^{2 delta} - 1))
        tv = min(2.0, 2.0 * float(np.expm1(min(2.0 * np.sqrt(d) * D, 60.0))))
        return D + tv * (M + D)


@dataclass(frozen=True)
class TopKAgg(BoundedRecomputeAgg):
    """Per-dim sum of the top-k in-neighbour values.  Cache per (row, dim):
    the admission threshold ``theta`` = current k-th largest value (-inf
    when deg < k).  A message strictly below theta on its new side and
    strictly below it on its old side cannot change the top-k set, so its
    PATCH is a no-op; anything touching the admission boundary is a
    REFRESH."""

    kk: int = 3

    @property
    def aux_names(self) -> tuple[str, ...]:
        return ("theta",)

    def init_aux(self, n, d):
        return {"theta": np.full((n, d), -np.inf, dtype=np.float32)}

    def np_reaggregate(self, H_prev, nbr, seg, n_rows, k_rows):
        vals = H_prev[nbr].astype(np.float32, copy=False)
        x, theta = _np_topk_passes(vals, seg, n_rows, self.kk)
        return x, {"theta": theta}

    def np_patch(self, x_rows, aux, k_rows, seg, src, val_old, val_new,
                 has_old, has_new):
        R = x_rows.shape[0]
        thm = aux["theta"][seg]
        hit = ((has_new[:, None] & (val_new > thm))
               | (has_old[:, None] & (val_old >= thm)))
        refresh = np.zeros(R, dtype=bool)
        if seg.size:
            np.logical_or.at(refresh, seg, hit.any(axis=1))
        return x_rows, aux, refresh

    def aggregate_dense(self, stack, k):
        top = np.sort(stack, axis=0)[::-1][:self.kk]
        return top.sum(axis=0)

    def reaggregate(self, vals, src, seg, n_rows, k_rows):
        x, theta = topk_passes(vals, seg, n_rows, self.kk)
        return x, (theta,)

    def gain(self, D, d, kmax, M):
        # each of the kk order statistics is 1-Lipschitz in inf-norm
        return self.kk * D


@dataclass(frozen=True)
class PNAAgg(BoundedRecomputeAgg):
    """PNA tower (mean/std/max + degree scaler): per input dim the
    normalized aggregate is ``[log1p(k)*mean, std, max]`` -- 3 dims per
    input dim (``x_multiplier = 3``).  Cache per row: the moment sums
    ``s1 = sum h`` and ``s2 = sum h^2`` (invertible patches) and the
    per-dim max ``mx`` with its witness ``mref`` (the largest in-neighbour
    id among ties; GROW folds, a witness loss is a REFRESH, as is
    accumulated variance drift)."""

    var_guard: float = 1e-3

    @property
    def x_multiplier(self) -> int:
        return 3

    @property
    def aux_names(self) -> tuple[str, ...]:
        return ("s1", "s2", "mx", "mref")

    def init_aux(self, n, d):
        return {"s1": np.zeros((n, d), dtype=np.float32),
                "s2": np.zeros((n, d), dtype=np.float32),
                "mx": np.full((n, d), -np.inf, dtype=np.float32),
                "mref": np.full((n, d), -1, dtype=np.int32)}

    @staticmethod
    def np_tower(s1, s2, mx, k):
        kk = np.maximum(k, 1.0)[:, None]
        mean = s1 / kk
        std = np.sqrt(np.maximum(s2 / kk - mean * mean, 0.0))
        mxf = np.where(np.isfinite(mx), mx, 0.0)
        scale = np.log1p(np.maximum(k, 0.0))[:, None]
        return np.concatenate([scale * mean, std, mxf], axis=1)

    @staticmethod
    def tower(s1: torch.Tensor, s2: torch.Tensor, mx: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
        """``[log1p(k) * mean, std, max]`` from the cached moments."""
        kk = k.clamp(min=1.0)[:, None]
        mean = s1 / kk
        std = torch.sqrt((s2 / kk - mean * mean).clamp(min=0.0))
        mxf = torch.where(torch.isfinite(mx), mx, 0.0)
        scale = torch.log1p(k.clamp(min=0.0))[:, None]
        return torch.cat([scale * mean, std, mxf], dim=1)

    def np_reaggregate(self, H_prev, nbr, seg, n_rows, k_rows):
        d = H_prev.shape[1]
        vals = H_prev[nbr].astype(np.float32, copy=False)
        s1 = np.zeros((n_rows, d), dtype=np.float32)
        s2 = np.zeros((n_rows, d), dtype=np.float32)
        np.add.at(s1, seg, vals)
        np.add.at(s2, seg, vals * vals)
        mx, mref = np_segment_extremum(MAX, vals, seg, n_rows, nbr)
        x = self.np_tower(s1, s2, mx, np.asarray(k_rows, dtype=np.float32))
        return x, {"s1": s1, "s2": s2, "mx": mx, "mref": mref}

    def np_patch(self, x_rows, aux, k_rows, seg, src, val_old, val_new,
                 has_old, has_new):
        R = x_rows.shape[0]
        s1, s2 = aux["s1"].copy(), aux["s2"].copy()
        mx, mref = aux["mx"], aux["mref"]
        vn = np.where(has_new[:, None], val_new, 0.0)
        vo = np.where(has_old[:, None], val_old, 0.0)
        np.add.at(s1, seg, vn - vo)
        np.add.at(s2, seg, vn * vn - vo * vo)
        # SHRINK classification against the pre-fold max (the monotonic
        # family's invariant, resolved here by a whole-row refresh)
        shrink = (mref[seg] == src[:, None]) & has_old[:, None] \
            & (~has_new[:, None] | (val_new < mx[seg]))
        refresh = np.zeros(R, dtype=bool)
        touched = np.zeros(R, dtype=bool)
        if seg.size:
            np.logical_or.at(refresh, seg, shrink.any(axis=1))
            touched[seg] = True
        grow = np.where(has_new[:, None], val_new, -np.inf)
        mx2, mref2 = np_segment_extremum(MAX, grow, seg, R, src,
                                         base=mx, base_refs=mref)
        k = np.asarray(k_rows, dtype=np.float32)
        kk = np.maximum(k, 1.0)[:, None]
        var = s2 / kk - (s1 / kk) ** 2
        refresh |= touched & ((var < -self.var_guard).any(axis=1)
                              | (k <= 0))
        x2 = self.np_tower(s1, s2, mx2, k)
        return x2, {"s1": s1, "s2": s2, "mx": mx2, "mref": mref2}, refresh

    def aggregate_dense(self, stack, k):
        kf = np.float32(max(k, 1))
        mean = stack.sum(axis=0) / kf
        std = np.sqrt(np.maximum((stack * stack).sum(axis=0) / kf
                                 - mean * mean, 0.0))
        return np.concatenate([np.log1p(np.float32(max(k, 0))) * mean, std,
                               stack.max(axis=0)])

    def moments(self, vals: torch.Tensor, src: torch.Tensor,
                seg: torch.Tensor, n_rows: int):
        """``(s2, mx, mref)``: the second moment and the max with its
        witness of each row (``s1`` is a bag sum, which the device engine
        takes from ``embedding_bag``)."""
        valid = (seg < n_rows)[:, None]
        vc = torch.where(valid, vals, 0.0)
        s2 = segment_sum(vc * vc, seg, n_rows)
        mx, mref = segment_extremum(MAX, torch.where(valid, vals, -np.inf),
                                    seg, n_rows, src)
        return s2, mx, mref

    def reaggregate(self, vals, src, seg, n_rows, k_rows):
        vc = torch.where((seg < n_rows)[:, None], vals, 0.0)
        s1 = segment_sum(vc, seg, n_rows)
        s2, mx, mref = self.moments(vals, src, seg, n_rows)
        return self.tower(s1, s2, mx, k_rows), (s1, s2, mx, mref)

    def gain(self, D, d, kmax, M):
        return max(float(np.log1p(max(kmax, 0.0))), 1.0) * D


SUM = InvertibleAgg("sum")
MEAN = InvertibleAgg("mean", by_degree=True)
WSUM = InvertibleAgg("wsum", uses_weights=True)
MAX = MonotonicAgg("max", sign=1.0)
MIN = MonotonicAgg("min", sign=-1.0)
ATTN = AttentionAgg("attn")
TOPK = TopKAgg("topk")
PNA = PNAAgg("pna")

AGGREGATORS: dict[str, Aggregator] = {a.name: a for a in
                                      (SUM, MEAN, WSUM, MAX, MIN,
                                       ATTN, TOPK, PNA)}


def get_aggregator(name: str) -> Aggregator:
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; "
                       f"known: {', '.join(AGGREGATORS)}") from None


# ---------------------------------------------------------------------------
# Host-side (NumPy) primitives
# ---------------------------------------------------------------------------
def np_segment_extremum(agg: MonotonicAgg, vals: np.ndarray, seg: np.ndarray,
                        n_rows: int, src: np.ndarray, *,
                        base: np.ndarray | None = None,
                        base_refs: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Segment min/max with contributor refs (host binding).

    ``vals [E, d]`` grouped by ``seg [E]`` into ``n_rows`` rows; ``src [E]``
    is the contributing vertex id of each value.  Returns ``(S [n_rows, d],
    C [n_rows, d])`` with identity / -1 in empty rows.  Contributor
    tie-breaks are arbitrary (any witness is valid).  ``vals`` may also be
    1-D ``[E]``, the pair-flattened per-dim SHRINK form, giving ``(S
    [n_rows], C [n_rows])``.  With ``base [n_rows, d]`` the segment extremum
    is folded into an existing aggregate and witnesses are taken against
    the folded result; dims the base still wins keep ``base_refs``.
    """
    shape = (n_rows,) if vals.ndim == 1 else (n_rows, vals.shape[1])
    S = np.full(shape, agg.identity, dtype=np.float32)
    agg.ufunc.at(S, seg, vals)
    if base is not None:
        S = agg.ufunc(S, base)
    C = np.full(shape, -1, dtype=np.int32)
    if vals.shape[0]:
        if vals.ndim == 1:
            jj = np.nonzero(vals == S[seg])[0]
            C[seg[jj]] = src[jj]
        else:
            jj, dd = np.nonzero(vals == S[seg])
            C[seg[jj], dd] = src[jj]
    if base_refs is not None:
        C = np.where(C >= 0, C, base_refs)
    return S, C


def np_shrink_dims(agg: MonotonicAgg, C_rows: np.ndarray, S_rows: np.ndarray,
                   src: np.ndarray, vals: np.ndarray,
                   is_del: np.ndarray) -> np.ndarray:
    """Per-(message, dim) SHRINK classification (GROW is the complement).

    A message ``(src -> row)`` shrinks dim ``d`` when ``src`` is that dim's
    tracked contributor and its contribution went away: the edge was
    deleted, or the contributor's new value moved strictly off the stored
    extremum.  Returns the ``[n_messages, d]`` bool mask.
    """
    match = C_rows == src[:, None]
    gone = is_del[:, None] | agg.improves(S_rows, vals)
    return match & gone


def compute_contributors(agg: MonotonicAgg, H: list[np.ndarray],
                         S: list[np.ndarray],
                         graph) -> list[np.ndarray]:
    """Derive contributor refs for a bootstrapped/materialized state.

    ``C[l][v, d]`` = an in-neighbor u with ``H[l-1][u, d] == S[l][v, d]``;
    -1 where the row is empty.  ``C[0]`` is a placeholder for index
    alignment with ``S``.
    """
    src, dst, _ = graph.coo()
    C: list[np.ndarray] = [np.empty((0, 0), dtype=np.int32)]
    for l in range(1, len(S)):
        Cl = np.full(S[l].shape, -1, dtype=np.int32)
        if src.size:
            vals = H[l - 1][src]
            jj, dd = np.nonzero(vals == S[l][dst])
            Cl[dst[jj], dd] = src[jj]
        C.append(Cl)
    return C


# ---------------------------------------------------------------------------
# Device-side (torch) primitive
# ---------------------------------------------------------------------------
def segment_extremum(agg: MonotonicAgg, vals: torch.Tensor, seg: torch.Tensor,
                     n_rows: int, src: torch.Tensor, *,
                     base: torch.Tensor | None = None,
                     base_refs: torch.Tensor | None = None,
                     small_ids: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment min/max with contributor refs on the tensors' device (the
    device engine's half of the :func:`np_segment_extremum` contract).

    ``vals [E, d]`` are native-space values grouped by ``seg [E]`` in
    ``[0, n_rows]`` (``seg == n_rows`` marks padding and contributes
    nothing); ``src [E]`` the contributing vertex ids.  The reductions run
    in max-space (``agg.sign * value``) into an identity-filled buffer with
    one trash row.  Returns ``(S [n_rows, d], C [n_rows, d] int32)`` with
    ``agg.identity`` / -1 in empty rows; ``vals`` may be 1-D ``[E]`` (the
    pair form), giving ``(S [n_rows], C [n_rows])``.  With ``base`` the
    extremum is folded into an existing aggregate and witnesses are taken
    against the folded result; dims the base wins keep ``base_refs``.

    Ties keep the largest winning ``src`` id, as the reference does.  The
    witness reduction runs in int64, exact for any id; ``small_ids`` is
    accepted so the reference's signature carries over, and is inert.
    """
    del small_ids
    sign = agg.sign
    vms = sign * vals
    lanes = seg if vals.dim() == 1 else seg[:, None].expand_as(vms)
    shape = (n_rows + 1,) + tuple(vals.shape[1:])
    S_ms = torch.full(shape, -np.inf, dtype=vals.dtype, device=vals.device)
    S_ms = S_ms.scatter_reduce_(0, lanes, vms, "amax")[:n_rows]
    if base is not None:
        S_ms = torch.maximum(S_ms, sign * base)
    valid = seg < n_rows
    win = vms == S_ms[seg.clamp(max=n_rows - 1)]
    if vals.dim() == 1:
        win = win & valid
        wsrc = src
    else:
        win = win & valid[:, None]
        wsrc = src[:, None]
    cand = torch.where(win, wsrc.to(torch.int64), -1)
    C = torch.full(shape, -1, dtype=torch.int64, device=vals.device)
    C = C.scatter_reduce_(0, lanes, cand, "amax")[:n_rows].to(torch.int32)
    if base_refs is not None:
        C = torch.where(C >= 0, C, base_refs)
    return sign * S_ms, C


def compute_bounded_aux(agg: BoundedRecomputeAgg, H: list[np.ndarray],
                        graph) -> list[dict[str, np.ndarray]]:
    """Derive the bounded family's cached partial state for a
    bootstrapped/materialized state on the host: one aux dict per layer
    (``A[0]`` is a placeholder for index alignment with ``S``).  The
    engines' bootstrap takes it from the device instead
    (:func:`repro_torch.core.full.bounded_aux`)."""
    src, dst, _ = graph.coo()
    A: list[dict[str, np.ndarray]] = [{}]
    for l in range(1, len(H)):
        _, aux = agg.np_reaggregate(H[l - 1], src, dst, graph.n,
                                    graph.in_degree)
        A.append(aux)
    return A


# ---------------------------------------------------------------------------
# Certified error bounds for the bounded family's approximate mode
# ---------------------------------------------------------------------------
def _col_abs_sum(w) -> float:
    """inf-norm Lipschitz constant of ``x -> x @ w``: max column abs-sum."""
    return float(np.max(np.sum(np.abs(np.asarray(w)), axis=0)))


def workload_lipschitz(workload, params_np: list[dict]) -> list[tuple[float, float]]:
    """Per-layer ``(Lx, Lself)``: inf-norm Lipschitz constants of the
    UPDATE w.r.t. the neighbor aggregate x and the self embedding h_prev
    (relu is 1-Lipschitz and drops out)."""
    out = []
    for p in params_np:
        fam = workload.family
        if fam == "gc":
            out.append((_col_abs_sum(p["w"]), 0.0))
        elif fam == "sage":
            out.append((_col_abs_sum(p["w_nbr"]), _col_abs_sum(p["w_self"])))
        elif fam == "gin":
            chain = _col_abs_sum(p["w1"]) * _col_abs_sum(p["w2"])
            out.append((chain, (1.0 + abs(float(p["eps"]))) * chain))
        else:
            raise ValueError(fam)
    return out


def certified_error_bound(workload, params_np: list[dict], eps, M,
                          kmax: float) -> list[float]:
    """Forward error recursion for deferred (eps-stale) layer writes.

    ``eps[l]`` is the certified staleness of the *stored* H[l] vs what the
    engine would have written (eps[0] = eps[L] = 0: features and published
    embeddings are never deferred); ``M[l]`` a running bound on
    ``max |H[l]|``; ``kmax`` the max in-degree seen.  Returns per-layer
    ``E[0..L]``: ``E[l]`` bounds ``|stored H[l] - oracle H[l]|_inf`` per
    vertex, via ``E_{l+1} = Lx * G(E_l + eps_l) + Lself * (E_l + eps_l)``
    with the aggregator's certified gain G (sound because a deferred
    vertex's neighbors aggregated exactly its stored value)."""
    agg = workload.agg
    lip = workload_lipschitz(workload, params_np)
    E = [0.0]
    for l in range(workload.spec.n_layers):
        D = E[l] + float(eps[l])
        Lx, Lself = lip[l]
        E.append(Lx * agg.gain(D, workload.spec.dims[l], kmax, float(M[l]))
                 + Lself * D)
    return E


def deferral_budgets(workload, params_np: list[dict], eps, M, kmax: float,
                     tolerance: float) -> np.ndarray:
    """Per-layer deferral budgets ``tau[1..L-1]``: the largest per-row
    write-deferral magnitude at layer l keeping the final-layer certified
    bound <= tolerance.  ``tau[l] >= eps[l]`` always (re-deferring within
    the already-certified staleness never raises the bound).

    Each layer's budget is first found with the other layers at their
    current ``eps``, as the reference computes it.  With two or more
    interior layers one batch may defer at all of them, and those budgets
    together can exceed the tolerance (the reference's do); the raises
    over ``eps`` are then scaled down by one common factor until the bound
    with every layer at its budget fits.  With one interior layer the
    budgets are the reference's."""
    L = workload.spec.n_layers
    taus = np.zeros(L + 1, dtype=np.float64)
    if tolerance <= 0 or L < 2:
        return taus

    def bound_with(l: int, t: float) -> float:
        e = np.array(eps, dtype=np.float64)
        e[l] = max(e[l], t)
        return certified_error_bound(workload, params_np, e, M, kmax)[-1]

    for l in range(1, L):
        lo = float(eps[l])
        hi = max(tolerance, lo, 1e-6)
        for _ in range(60):  # geometric upper bracket
            if bound_with(l, hi) > tolerance:
                break
            lo, hi = hi, hi * 2.0
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            if bound_with(l, mid) <= tolerance:
                lo = mid
            else:
                hi = mid
        taus[l] = lo

    base = np.array(eps, dtype=np.float64)[1:L]
    raise_ = taus[1:L] - base

    def joint(a: float) -> float:
        e = np.array(eps, dtype=np.float64)
        e[1:L] = base + a * raise_
        return certified_error_bound(workload, params_np, e, M, kmax)[-1]

    if L > 2 and joint(1.0) > tolerance:
        lo, hi = 0.0, 1.0
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            if joint(mid) <= tolerance:
                lo = mid
            else:
                hi = mid
        taus[1:L] = base + lo * raise_
    return taus
