"""Per-tenant state for the serving layer: sequences + staleness policy.

Multi-tenancy in RIPPLE terms: every tenant is an independent update
stream + query stream multiplexed onto ONE engine and one shared graph
(the paper's deployment shape: many producers and consumers of a single
evolving embedding table, §1).  Consistency is tracked per tenant with two
monotone sequence numbers:

    submitted  -- updates this tenant has handed to ``GraphServer.submit``
    committed  -- the highest submitted sequence whose effects are visible
                  in the published snapshot (publish-on-commit)

Read-your-writes is the per-tenant contract: a query issued after the
tenant submitted sequence ``t`` wants ``committed >= t``.  When ingest is
behind, the tenant's :class:`TenantConfig` decides what a query does:

    "stale"   serve the published snapshot anyway, reporting how many of
              the tenant's own updates it is missing (the default)
    "wait"    block on the publish condition until the snapshot catches up
              (or ``wait_timeout_s`` expires -> :class:`StaleReadError`)
    "reject"  fail fast with :class:`StaleReadError` so the caller can
              retry elsewhere

``max_staleness`` gives every policy slack: a read is only considered
behind when more than that many of the tenant's updates are unpublished.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

STALENESS_POLICIES = ("stale", "wait", "reject")


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class AdmissionError(ServeError):
    """Backpressure: the ingest queue is full and the overload policy is
    'reject' -- the submitted updates were NOT enqueued."""


class StaleReadError(ServeError):
    """A read-your-writes query found the snapshot too far behind under the
    'reject' policy, or timed out under 'wait'."""


@dataclass
class TenantConfig:
    """Declarative per-tenant serving knobs."""

    name: str
    staleness: str = "stale"      # "stale" | "wait" | "reject"
    max_staleness: int = 0        # own updates a read may silently miss
    wait_timeout_s: float = 10.0  # "wait" gives up after this
    weight: float = 1.0           # ingest share under saturation (weighted
    #                               deficit in the server's batcher; the
    #                               load generators use the same ratio)

    def __post_init__(self):
        if self.staleness not in STALENESS_POLICIES:
            raise ValueError(f"staleness must be one of {STALENESS_POLICIES},"
                             f" got {self.staleness!r}")


class Tenant:
    """Runtime bookkeeping for one registered tenant (server-internal).

    ``pending`` holds (last_seq, t_submit, n_updates) stamps of submitted
    chunks not yet fully published; the publish path pops them to derive
    end-to-end ingest latency (publish time minus submit time).
    """

    def __init__(self, config: TenantConfig):
        self.config = config
        self.submitted = 0       # sequence of the last update handed to us
        self.committed = 0       # highest sequence visible in the snapshot
        self.pending: deque = deque()   # (last_seq, t_submit, n_updates)
        self.rejected_updates = 0       # shed by admission control
        self.rejected_queries = 0       # failed the staleness policy
        self.queries = 0

    @property
    def name(self) -> str:
        return self.config.name

    def behind(self, need: int | None = None) -> int:
        """How many of the tenant's own updates the snapshot is missing."""
        return max((self.submitted if need is None else need)
                   - self.committed, 0)
