"""Concurrent multi-tenant serving over an :class:`InferenceSession`.

Layers (bottom-up):

- ``tenants``   -- per-tenant sequences + staleness policy (read-your-writes)
- ``scheduler`` -- online latency model, deadline-driven micro-batching,
  bounded-queue admission control
- ``server``    -- :class:`GraphServer`: snapshot-consistent publish-on-commit
  read path concurrent with a threaded ingest worker
- ``loadgen``   -- open-/closed-loop traffic generators for the serve bench

``python -m repro_torch.serve`` runs a small live demo (see ``__main__``).
"""
from .loadgen import (ClosedLoopLoad, LoadReport, OpenLoopLoad,
                      latency_summary, percentile, split_stream,
                      tenant_shares)
from .scheduler import AdmissionController, ControllerConfig, LatencyModel
from .server import GraphServer, QueryResult, ServeStopped
from .tenants import (STALENESS_POLICIES, AdmissionError, ServeError,
                      StaleReadError, Tenant, TenantConfig)

__all__ = [
    "AdmissionController", "AdmissionError", "ClosedLoopLoad",
    "ControllerConfig", "GraphServer", "LatencyModel", "LoadReport",
    "OpenLoopLoad", "QueryResult", "STALENESS_POLICIES", "ServeError",
    "ServeStopped", "StaleReadError", "Tenant", "TenantConfig",
    "latency_summary", "percentile", "split_stream", "tenant_shares",
]
