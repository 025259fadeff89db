"""Traffic generators + latency accounting for the serving benchmark.

Two load shapes, because they answer different questions:

- **Closed loop** (:class:`ClosedLoopLoad`): each tenant thread fires its
  next request the moment the previous one returns.  Offered load adapts
  to service rate, so the run measures *saturation throughput* -- the
  paper's "how much stream can one engine absorb" number.

- **Open loop** (:class:`OpenLoopLoad`): arrivals are a Poisson process at
  a fixed rate, independent of completions.  Latency is measured from the
  *scheduled* arrival time, not from when the generator got around to
  sending -- the standard fix for coordinated omission, without which a
  stalled server hides its own tail.

Tenant skew reuses the stream machinery's power-law shape: traffic shares
are ``(i+1)^-skew`` over tenants, the same law ``make_stream`` applies to
vertex popularity, so a hot tenant hammers the queue while cold ones probe
tail latency.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .tenants import ServeError


def percentile(samples, q) -> float:
    """p50/p99/p999-style percentile of a latency sample list (seconds)."""
    if not len(samples):
        return float("nan")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def latency_summary(samples) -> dict:
    """The fixed percentile set every serving latency summary reports."""
    return {"n": int(len(samples)),
            "p50_ms": percentile(samples, 50) * 1e3,
            "p99_ms": percentile(samples, 99) * 1e3,
            "p999_ms": percentile(samples, 99.9) * 1e3,
            "mean_ms": (float(np.mean(samples)) * 1e3 if len(samples)
                        else float("nan"))}


def tenant_shares(n_tenants: int, skew: float = 1.0) -> np.ndarray:
    """Power-law traffic shares over tenants (skew=0 -> uniform)."""
    w = (np.arange(1, n_tenants + 1, dtype=np.float64)) ** (-float(skew))
    return w / w.sum()


def split_stream(updates, n_tenants: int, *, skew: float = 1.0,
                 seed: int = 0) -> list[list]:
    """Partition one update stream across tenants with power-law skew,
    preserving each tenant's relative update order (per-tenant streams
    stay causally ordered; cross-tenant order is the server's to pick)."""
    rng = np.random.default_rng(seed)
    owners = rng.choice(n_tenants, size=len(updates),
                        p=tenant_shares(n_tenants, skew))
    per = [[] for _ in range(n_tenants)]
    for u, o in zip(updates, owners):
        per[o].append(u)
    return per


@dataclass
class LoadReport:
    """What one load-generator run measured (all latencies in seconds)."""

    mode: str                      # "closed" | "open"
    wall_s: float = 0.0
    n_updates: int = 0             # updates actually accepted by the server
    n_queries: int = 0
    n_rejected: int = 0            # submissions/queries shed by policy
    query_latencies: list = field(default_factory=list)
    submit_latencies: list = field(default_factory=list)
    achieved_rate: float = 0.0     # accepted updates / wall_s

    def summary(self) -> dict:
        return {"mode": self.mode, "wall_s": self.wall_s,
                "n_updates": self.n_updates, "n_queries": self.n_queries,
                "n_rejected": self.n_rejected,
                "updates_per_s": self.achieved_rate,
                "query_latency": latency_summary(self.query_latencies),
                "submit_latency": latency_summary(self.submit_latencies)}


class _TenantScript:
    """One tenant's pre-materialized request tape: chunks of updates with a
    query after every ``query_every`` chunks (query targets drawn from the
    tenant's own touched vertices -- the read-your-writes-relevant set)."""

    def __init__(self, name, updates, *, chunk: int, query_every: int,
                 n_query_vertices: int, n_vertices: int, seed: int):
        self.name = name
        rng = np.random.default_rng(seed)
        self.requests = []          # ("submit", chunk) | ("query", vertices)
        for i in range(0, len(updates), max(chunk, 1)):
            part = updates[i:i + chunk]
            self.requests.append(("submit", part))
            if query_every and (i // max(chunk, 1)) % query_every == 0:
                touched = [getattr(u, "dst", getattr(u, "vertex", 0))
                           for u in part]
                pool = np.unique(np.asarray(touched + [0], dtype=np.int64)
                                 % n_vertices)
                self.requests.append(
                    ("query", rng.choice(pool, size=min(n_query_vertices,
                                                        pool.size),
                                         replace=False)))


def _build_scripts(server, per_tenant_updates, *, chunk, query_every,
                   n_query_vertices, seed):
    n_vertices = server.session.graph.n
    scripts = []
    for idx, (name, ups) in enumerate(per_tenant_updates.items()):
        scripts.append(_TenantScript(
            name, ups, chunk=chunk, query_every=query_every,
            n_query_vertices=n_query_vertices, n_vertices=n_vertices,
            seed=seed + idx))
    return scripts


class ClosedLoopLoad:
    """One thread per tenant, back-to-back requests: measures saturation."""

    def __init__(self, server, per_tenant_updates: dict, *, chunk: int = 4,
                 query_every: int = 2, n_query_vertices: int = 8,
                 query_mode: str = "snapshot", seed: int = 0):
        self.server = server
        self.query_mode = query_mode
        self.scripts = _build_scripts(server, per_tenant_updates,
                                      chunk=chunk, query_every=query_every,
                                      n_query_vertices=n_query_vertices,
                                      seed=seed)

    def run(self) -> LoadReport:
        rep = LoadReport(mode="closed")
        lock = threading.Lock()

        def drive(script):
            q_lat, s_lat, n_up, n_q, n_rej = [], [], 0, 0, 0
            for kind, payload in script.requests:
                t0 = time.perf_counter()
                try:
                    if kind == "submit":
                        self.server.submit(script.name, payload)
                        s_lat.append(time.perf_counter() - t0)
                        n_up += len(payload)
                    else:
                        r = self.server.query(script.name, payload,
                                              mode=self.query_mode)
                        q_lat.append(r.latency_s)
                        n_q += 1
                except ServeError:
                    n_rej += 1
            with lock:
                rep.query_latencies += q_lat
                rep.submit_latencies += s_lat
                rep.n_updates += n_up
                rep.n_queries += n_q
                rep.n_rejected += n_rej

        threads = [threading.Thread(target=drive, args=(s,), daemon=True)
                   for s in self.scripts]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.server.drain()
        rep.wall_s = time.perf_counter() - t0
        rep.achieved_rate = rep.n_updates / rep.wall_s if rep.wall_s else 0.0
        return rep


class OpenLoopLoad:
    """Poisson arrivals at ``rate`` requests/s across all tenants.

    A single dispatcher thread walks a pre-drawn exponential arrival
    schedule; every request's latency clock starts at its *scheduled*
    arrival (coordinated-omission safe).  Requests run on short-lived
    worker threads so one slow query cannot delay later arrivals.
    """

    def __init__(self, server, per_tenant_updates: dict, *,
                 rate: float = 200.0, chunk: int = 4, query_every: int = 2,
                 n_query_vertices: int = 8, query_mode: str = "snapshot",
                 seed: int = 0):
        self.server = server
        self.rate = float(rate)
        self.query_mode = query_mode
        scripts = _build_scripts(server, per_tenant_updates, chunk=chunk,
                                 query_every=query_every,
                                 n_query_vertices=n_query_vertices, seed=seed)
        # interleave tenant tapes round-robin into one arrival sequence
        self.sequence = []          # (tenant, kind, payload)
        cursors = [iter(s.requests) for s in scripts]
        names = [s.name for s in scripts]
        while cursors:
            nxt_c, nxt_n = [], []
            for cur, name in zip(cursors, names):
                req = next(cur, None)
                if req is not None:
                    self.sequence.append((name, *req))
                    nxt_c.append(cur)
                    nxt_n.append(name)
            cursors, names = nxt_c, nxt_n
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / max(self.rate, 1e-9),
                               size=len(self.sequence))
        self.schedule = np.cumsum(gaps)

    def run(self) -> LoadReport:
        rep = LoadReport(mode="open")
        lock = threading.Lock()
        threads = []

        def fire(tenant, kind, payload, t_sched):
            n_up = n_q = n_rej = 0
            q_lat, s_lat = [], []
            try:
                if kind == "submit":
                    self.server.submit(tenant, payload)
                    s_lat.append(time.perf_counter() - t_sched)
                    n_up = len(payload)
                else:
                    self.server.query(tenant, payload, mode=self.query_mode)
                    q_lat.append(time.perf_counter() - t_sched)
                    n_q = 1
            except ServeError:
                n_rej = 1
            with lock:
                rep.query_latencies += q_lat
                rep.submit_latencies += s_lat
                rep.n_updates += n_up
                rep.n_queries += n_q
                rep.n_rejected += n_rej

        t0 = time.perf_counter()
        for (tenant, kind, payload), offset in zip(self.sequence,
                                                   self.schedule):
            t_sched = t0 + offset
            delay = t_sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=fire,
                                  args=(tenant, kind, payload, t_sched),
                                  daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
        self.server.drain()
        rep.wall_s = time.perf_counter() - t0
        rep.achieved_rate = rep.n_updates / rep.wall_s if rep.wall_s else 0.0
        return rep
