"""Aggregator algebra behind RIPPLE: the invertible family.

**Invertible aggregators** (``sum`` / ``mean`` / ``wsum``).  The aggregate
lives in a group: a contribution can be *retracted* by adding its inverse,
so one delta mailbox per affected vertex is enough::

    S' = S + sum(deltas) + sum(added h_old) - sum(deleted h_old)

``mean`` stays exact because the engines track the *unnormalized* (S, k)
pair and normalize on read.

The monotonic (max/min) and bounded-recompute (attn/topk/pna) families are
not ported yet: :func:`get_aggregator` raises ``NotImplementedError`` for
them, naming the ROADMAP.md item where they land.
"""
from __future__ import annotations

from dataclasses import dataclass

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


SUM = InvertibleAgg("sum")
MEAN = InvertibleAgg("mean", by_degree=True)
WSUM = InvertibleAgg("wsum", uses_weights=True)

AGGREGATORS: dict[str, Aggregator] = {a.name: a for a in (SUM, MEAN, WSUM)}

# aggregators of the reference that this package does not carry yet
_UNPORTED = {
    "max": "ROADMAP.md Queue 1 item 6 (monotonic family)",
    "min": "ROADMAP.md Queue 1 item 6 (monotonic family)",
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
