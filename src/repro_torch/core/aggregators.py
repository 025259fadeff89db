"""Aggregator algebra behind RIPPLE: the invertible and monotonic families.

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

The bounded-recompute family (attn/topk/pna) is not ported yet:
:func:`get_aggregator` raises ``NotImplementedError`` for it, naming the
ROADMAP.md item where it lands.
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
    def weighted(self) -> bool:
        return False

    def normalize(self, S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Aggregate -> UPDATE input (x = norm(S, k))."""
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


SUM = InvertibleAgg("sum")
MEAN = InvertibleAgg("mean", by_degree=True)
WSUM = InvertibleAgg("wsum", uses_weights=True)
MAX = MonotonicAgg("max", sign=1.0)
MIN = MonotonicAgg("min", sign=-1.0)

AGGREGATORS: dict[str, Aggregator] = {a.name: a for a in
                                      (SUM, MEAN, WSUM, MAX, MIN)}

# aggregators of the reference that this package does not carry yet
_UNPORTED = {
    "attn": "ROADMAP.md Queue 1 item 7 (bounded family)",
    "topk": "ROADMAP.md Queue 1 item 7 (bounded family)",
    "pna": "ROADMAP.md Queue 1 item 7 (bounded family)",
}


def get_aggregator(name: str) -> Aggregator:
    if name in AGGREGATORS:
        return AGGREGATORS[name]
    if name in _UNPORTED:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported yet: {_UNPORTED[name]}")
    raise KeyError(f"unknown aggregator {name!r}; "
                   f"known: {', '.join(AGGREGATORS)}")


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
