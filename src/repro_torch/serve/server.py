"""``GraphServer`` -- concurrent multi-tenant serving over one session.

The paper's target regime is near-realtime inference under a continuous
update stream (§1, fig 2), but a bare ``InferenceSession`` is one
synchronous loop: a query issued while a batch propagates either reads a
half-committed state or waits the whole batch out.  The server fixes both
with a snapshot-consistent read path layered on publish-on-commit:

- **Ingest** runs on a dedicated worker thread: tenants ``submit`` updates
  into a bounded admission queue, the :class:`AdmissionController` sizes
  micro-batches from the online latency model, and every micro-batch goes
  through ``session.apply_one`` (journaled, engine-agnostic).  The worker
  runs under ``torch.cuda.device(session.device)``, so its CUDA work goes
  to the session's card, never to whatever device a new thread starts on.

- **Publish-on-commit.** The server owns a host mirror of the final-layer
  embeddings (``H_pub``).  When a micro-batch *commits*, exactly the rows
  it changed are patched into the mirror under the snapshot lock -- a
  frontier-proportional publish, never O(|V|).  The device engine exposes
  ``drain_commits()``: the committed rows, gathered on the card and copied
  to the host when the batch resolves, so publication trails the async
  pipeline without ever blocking on an in-flight batch; the host engines
  publish straight from ``state.H[-1]``.  The ``full``/``vertexwise``
  baselines, whose ``affected`` sets do not cover all changed rows,
  republish the whole layer (detected automatically).

- **Snapshot queries** read ``H_pub`` under the (tiny) snapshot lock:
  they never touch the engine or the card, never wait for propagation,
  and can never observe a half-committed batch -- the mirror only ever
  mutates by whole committed patches.  ``mode="blocking"`` is the contrast baseline: it
  takes the engine lock (waiting out any in-flight batch) and reads the
  authoritative state, which is what a serving layer *without* snapshots
  would have to do.

- **Read-your-writes** per tenant: each tenant's updates carry sequence
  numbers; a query wants the snapshot to cover everything the tenant
  submitted before it.  When ingest is behind, the tenant's staleness
  policy ("stale" | "wait" | "reject", see ``tenants.py``) decides.

Threading: ``threaded=True`` spawns the worker; ``threaded=False`` is the
deterministic mode -- ``submit`` enqueues and ``pump()`` processes
micro-batches inline, which is what the consistency tests script against
an oracle.  Lock order (strictly): engine lock -> snapshot lock; the
queue lock never nests inside either.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import EdgeUpdate, UpdateBatch

from .scheduler import AdmissionController, ControllerConfig
from .tenants import (AdmissionError, StaleReadError, Tenant, TenantConfig)

# engines whose UpdateResult.affected does not cover every changed H[-1]
# row (full recompute touches everything; vertexwise is lazy) -- publish
# falls back to re-copying the whole final layer for these
_FULL_PUBLISH_ENGINES = ("full", "vertexwise")


class QueryResult(NamedTuple):
    """One snapshot (or blocking) read."""

    values: np.ndarray   # final-layer embedding rows for the asked vertices
    version: int         # committed micro-batches folded into what was read
    seen_seq: int        # tenant sequence the snapshot covered at read time
    staleness: int       # tenant updates submitted but not yet visible
    latency_s: float


class _Submitted(NamedTuple):
    """One queued update with its provenance."""

    tenant: Tenant
    update: object       # EdgeUpdate | FeatureUpdate
    seq: int


class GraphServer:
    """Multiplex concurrent tenant update/query streams onto one session."""

    def __init__(self, session, *, tenants=("default",),
                 controller: ControllerConfig | None = None,
                 deadline_ms: float | None = None,
                 max_batch: int = 256, capacity: int = 8192,
                 overload: str = "block", threaded: bool = True,
                 gil_slice_s: float = 1e-3):
        cfg = controller or ControllerConfig(
            deadline_ms=session.deadline_ms if deadline_ms is None
            else deadline_ms,
            max_batch=max_batch, capacity=capacity, overload=overload)
        self.session = session
        self.controller = AdmissionController(cfg)
        self.threaded = threaded
        # bound CPython's GIL slice while serving: a NumPy engine batch can
        # otherwise hold the interpreter for the full default 5 ms switch
        # interval, which lands directly on snapshot-query tail latency
        self._gil_slice = gil_slice_s

        self._tenants: dict[str, Tenant] = {}
        for t in tenants:
            self.register_tenant(t)

        # ingest queues (guarded by _qcv's lock): one FIFO per tenant,
        # drained by weighted deficit round-robin -- each tenant accrues
        # virtual time served/weight and the scheduler always picks the
        # non-empty tenant furthest behind, so a 3:1-weighted pair gets a
        # 3:1 share of every micro-batch under saturation while an idle
        # tenant costs nothing (work-conserving).  _busy counts chunks
        # popped from the queues but not yet applied+published -- without it
        # drain() could declare victory while the worker holds a chunk
        # mid-apply
        self._queues: dict[str, deque[_Submitted]] = {
            name: deque() for name in self._tenants}
        self._served: dict[str, int] = {name: 0 for name in self._tenants}
        self._qtotal = 0
        self._busy = 0
        self._qcv = threading.Condition()
        # engine lock: held around every apply/flush/swap; "blocking"
        # queries take it too -- that wait IS the no-snapshot baseline
        self._elock = threading.RLock()
        # snapshot lock + publish condition ("wait" readers sleep on it)
        self._scv = threading.Condition()
        self._H_pub = np.array(session.query(), dtype=np.float32, copy=True)
        self._version = 0
        self._inflight: deque = deque()   # ({tenant: max seq}, n_updates)

        # metrics (appended under their owning locks / the GIL)
        self.ingest_latencies: list[float] = []   # submit -> publish, s
        self.batch_latencies: list[float] = []    # per-micro-batch apply, s
        # apply + commit capture + publish, the full serving cost per
        # micro-batch (what the bench's steady-state throughput divides by)
        self.batch_full_latencies: list[float] = []
        self.batch_sizes: list[int] = []
        self.query_latencies: dict[str, list[float]] = {"snapshot": [],
                                                        "blocking": []}
        self.staleness_samples: list[int] = []
        self.n_published = 0
        self.published_updates = 0
        # engine-busy window: first apply start -> last publish.  The
        # bench's saturation number uses this (how fast the serving layer
        # can feed the engine), excluding load-generator ramp-up/queries
        self._t_first_apply: float | None = None
        self._t_last_publish: float | None = None

        self._running = False
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        self._old_switch: float | None = None
        # the session's card with its index pinned in the constructing
        # thread: a bare "cuda" means that thread's current device
        self._device = torch.device(session.device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._attach_engine()

    # -- tenants -----------------------------------------------------------
    def register_tenant(self, tenant) -> Tenant:
        """Register a tenant by name or :class:`TenantConfig`."""
        cfg = tenant if isinstance(tenant, TenantConfig) \
            else TenantConfig(name=str(tenant))
        if cfg.name in self._tenants:
            raise ValueError(f"tenant {cfg.name!r} already registered")
        t = Tenant(cfg)
        self._tenants[cfg.name] = t
        if hasattr(self, "_queues"):     # late registration (post-init)
            with self._qcv:
                self._queues[cfg.name] = deque()
                self._served[cfg.name] = 0
        return t

    def tenant(self, name: str) -> Tenant:
        return self._tenants[name]

    @property
    def version(self) -> int:
        """Committed micro-batches folded into the published snapshot."""
        return self._version

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GraphServer":
        if self.threaded and self._worker is None:
            self._running = True
            self._old_switch = sys.getswitchinterval()
            sys.setswitchinterval(self._gil_slice)
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="ripple-ingest", daemon=True)
            self._worker.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop serving; with ``drain`` (default) everything queued is
        applied and published first."""
        if self._worker is not None:
            if not drain:
                with self._qcv:
                    for q in self._queues.values():
                        q.clear()
                    self._qtotal = 0
                    self._qcv.notify_all()
            with self._qcv:
                self._running = False
                self._qcv.notify_all()
            self._worker.join()
            self._worker = None
            if self._old_switch is not None:
                sys.setswitchinterval(self._old_switch)
                self._old_switch = None
        elif drain:
            self.pump()
        self._flush_tail()
        self._raise_worker_error()

    def __enter__(self) -> "GraphServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- ingest path -------------------------------------------------------
    def submit(self, tenant: str, updates) -> int:
        """Enqueue updates for ``tenant``; returns the tenant sequence of
        the last one (the read-your-writes watermark for later queries).

        Backpressure: when the queue bound is hit, ``overload="block"``
        waits for drain and ``overload="reject"`` raises
        :class:`AdmissionError` without enqueueing anything.
        """
        from repro_torch.api.session import _flatten
        self._raise_worker_error()
        t = self._tenants[tenant]
        flat = _flatten(updates)
        if not flat:
            return t.submitted
        with self._qcv:
            while not self.controller.admits(self._qtotal, len(flat)):
                if self.controller.config.overload == "reject":
                    t.rejected_updates += len(flat)
                    raise AdmissionError(
                        f"queue full ({self._qtotal} updates), "
                        f"rejecting {len(flat)} from {tenant!r}")
                if not (self._running or not self.threaded):
                    raise ServeStopped(tenant)
                self._qcv.wait(0.1)
            q = self._queues[tenant]
            for u in flat:
                t.submitted += 1
                q.append(_Submitted(t, u, t.submitted))
            self._qtotal += len(flat)
            t.pending.append((t.submitted, time.perf_counter(), len(flat)))
            self._qcv.notify_all()
        return t.submitted

    def pump(self, max_batches: int | None = None) -> int:
        """Deterministic (non-threaded) mode: apply queued micro-batches
        inline; returns the number applied.  Also usable while a worker is
        stopped -- never concurrently with a live worker."""
        if self._worker is not None:
            raise RuntimeError("pump() while the worker runs")
        done = 0
        while max_batches is None or done < max_batches:
            if not self._step():
                break
            done += 1
        return done

    def drain(self) -> None:
        """Block until everything submitted so far is published."""
        if self._worker is None:
            self.pump()
            self._flush_tail()
            return
        with self._qcv:
            while (self._qtotal or self._busy) and self._running:
                self._raise_worker_error()
                self._qcv.wait(0.05)
        with self._scv:
            while self._inflight and self._running and self._error is None:
                self._scv.wait(0.05)
        self._raise_worker_error()

    # the worker applies one micro-batch per _step; queue lock is dropped
    # before the engine is touched
    def _step(self) -> bool:
        with self._qcv:
            if not self._qtotal:
                return False
            bs = self.controller.next_batch_size(self._qtotal)
            chunk = self._pop_weighted(min(bs, self._qtotal))
            self._busy += 1
            self._qcv.notify_all()
        try:
            self._apply_chunk(chunk)
        finally:
            with self._qcv:
                self._busy -= 1
                self._qcv.notify_all()
        return True

    def _pop_weighted(self, n: int) -> list[_Submitted]:
        """Pop ``n`` updates by weighted deficit: each slot goes to the
        non-empty tenant with the lowest virtual time (served / weight).
        Caller holds the queue lock."""
        chunk: list[_Submitted] = []
        for _ in range(n):
            name = min(
                (nm for nm, q in self._queues.items() if q),
                key=lambda nm: self._served[nm]
                / max(self._tenants[nm].config.weight, 1e-9))
            chunk.append(self._queues[name].popleft())
            self._served[name] += 1
        self._qtotal -= len(chunk)
        return chunk

    def _worker_loop(self) -> None:
        dev = self._device
        on_card = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        try:
            with on_card:
                self._serve_queue()
        except BaseException as e:   # surfaced on the next API call
            self._error = e
            with self._qcv:
                self._running = False
                self._qcv.notify_all()
            with self._scv:
                self._scv.notify_all()

    def _serve_queue(self) -> None:
        while True:
            with self._qcv:
                if not self._qtotal:
                    if not self._running:
                        break
                    # idle: publish any pipelined tail, then sleep
                    if not self._inflight:
                        self._qcv.wait(0.02)
                        continue
            if not self._step():
                self._flush_tail()

    def _apply_chunk(self, chunk: list[_Submitted]) -> None:
        batch = UpdateBatch()
        meta: dict[Tenant, int] = {}
        for s in chunk:
            (batch.edges if isinstance(s.update, EdgeUpdate)
             else batch.features).append(s.update)
            meta[s.tenant] = max(meta.get(s.tenant, 0), s.seq)
        with self._elock:
            t0 = time.perf_counter()
            if self._t_first_apply is None:
                self._t_first_apply = t0
            res = self.session.apply_one(batch)
            dt = time.perf_counter() - t0
            self._inflight.append((meta, len(chunk)))
            commits = self._commits_for(res)
        self.controller.observe(len(chunk), dt)
        self.batch_latencies.append(dt)
        self.batch_sizes.append(len(chunk))
        for aff, rows in commits:
            self._publish(aff, rows)
        self.batch_full_latencies.append(time.perf_counter() - t0)

    def _flush_tail(self) -> None:
        """Resolve + publish whatever a pipelined engine still holds."""
        with self._elock:
            if not self._inflight:
                return
            flush = getattr(self.session.engine, "flush", None)
            if flush is not None:
                flush()
            commits = self._drain_engine_commits()
        for aff, rows in commits:
            self._publish(aff, rows)

    # -- commit extraction -------------------------------------------------
    def _attach_engine(self) -> None:
        """Adopt the session's current engine (construction + hot-swap):
        enable its commit log when it has one, and pick the publish mode."""
        eng = self.session.engine
        enable = getattr(eng, "enable_commit_log", None)
        if enable is not None:
            enable()
        self._publish_full = self.session.engine_name in _FULL_PUBLISH_ENGINES

    def _drain_engine_commits(self):
        drain = getattr(self.session.engine, "drain_commits", None)
        return [(aff, rows) for _idx, aff, rows in drain()] \
            if drain is not None else []

    def _commits_for(self, res):
        """Committed (affected, rows) patches implied by one apply call.

        Pipelined engines report commits through ``drain_commits`` (possibly
        for an *earlier* batch -- FIFO matches them to ``_inflight``);
        synchronous engines commit in place, so the patch is read straight
        from the authoritative state while the engine lock is held.
        """
        commits = self._drain_engine_commits()
        if getattr(self.session.engine, "drain_commits", None) is not None:
            return commits
        if self._publish_full:
            return [(None, None)]       # republish the whole layer
        aff = np.asarray(res.affected, dtype=np.int64)
        # query()'s fancy index / device download already yields fresh rows
        return [(aff, self.session.query(aff))]

    # -- publish / query ---------------------------------------------------
    def _publish(self, aff, rows) -> None:
        """Fold one committed batch's final-layer patch into the snapshot
        and advance every covered tenant's committed sequence."""
        t_now = time.perf_counter()
        with self._scv:
            meta, n_updates = self._inflight.popleft() if self._inflight \
                else ({}, 0)
            self.published_updates += n_updates
            self._t_last_publish = t_now
            if aff is None:
                self._H_pub = np.array(self.session.query(), copy=True)
            elif aff.size:
                self._H_pub[aff] = rows
            self._version += 1
            self.n_published += 1
            for tenant, seq in meta.items():
                tenant.committed = max(tenant.committed, seq)
                while tenant.pending and \
                        tenant.pending[0][0] <= tenant.committed:
                    _last, t_sub, _n = tenant.pending.popleft()
                    self.ingest_latencies.append(t_now - t_sub)
            self._scv.notify_all()

    def query(self, tenant: str, vertices, *, mode: str = "snapshot",
              min_seq: int | None = None) -> QueryResult:
        """Final-layer embeddings for ``vertices`` as seen by ``tenant``.

        ``mode="snapshot"`` (default) reads the published snapshot --
        concurrent with ingest, read-your-writes enforced per the tenant's
        staleness policy.  ``mode="blocking"`` takes the engine lock and
        reads the authoritative engine state: always fresh, but it waits
        out any in-flight batch (the baseline the snapshot path beats).
        ``min_seq`` overrides the read-your-writes watermark (default: all
        of the tenant's own submissions at call time).
        """
        self._raise_worker_error()
        t = self._tenants[tenant]
        t.queries += 1
        v = np.asarray(vertices, dtype=np.int64)
        t0 = time.perf_counter()
        if mode == "blocking":
            with self._elock:
                vals = np.array(self.session.query(v), copy=True)
                version, seen = self._version, t.committed
        elif mode == "snapshot":
            need = t.submitted if min_seq is None else min_seq
            with self._scv:
                cfg = t.config
                if t.behind(need) > cfg.max_staleness:
                    if cfg.staleness == "reject":
                        t.rejected_queries += 1
                        raise StaleReadError(
                            f"{tenant!r} snapshot is {t.behind(need)} updates"
                            f" behind (> {cfg.max_staleness})")
                    if cfg.staleness == "wait":
                        deadline = t0 + cfg.wait_timeout_s
                        while t.behind(need) > cfg.max_staleness:
                            self._raise_worker_error()
                            left = deadline - time.perf_counter()
                            if left <= 0:
                                t.rejected_queries += 1
                                raise StaleReadError(
                                    f"{tenant!r} gave up waiting after "
                                    f"{cfg.wait_timeout_s}s still "
                                    f"{t.behind(need)} updates behind")
                            self._scv.wait(left)
                vals = self._H_pub[v].copy()
                version, seen = self._version, t.committed
        else:
            raise ValueError(f"unknown query mode {mode!r}")
        lat = time.perf_counter() - t0
        staleness = t.behind(min_seq) if mode == "snapshot" else 0
        self.query_latencies[mode].append(lat)
        if mode == "snapshot":
            self.staleness_samples.append(staleness)
        return QueryResult(values=vals, version=version, seen_seq=seen,
                           staleness=staleness, latency_s=lat)

    # -- engine hot-swap ---------------------------------------------------
    def swap_engine(self, name: str, **options):
        """Hot-swap the session's backend mid-serve.

        Pauses ingest at a batch boundary (engine lock), publishes the
        pipelined tail so nothing committed is lost, migrates state
        (bit-exact, see ``session.swap_engine``), re-attaches commit
        tracking, and republishes the full snapshot from the new engine.
        """
        with self._elock:
            self._flush_tail()
            engine = self.session.swap_engine(name, **options)
            self._attach_engine()
            with self._scv:
                self._H_pub = np.array(self.session.query(), copy=True)
                self._scv.notify_all()
        return engine

    # -- metrics -----------------------------------------------------------
    def metrics(self) -> dict:
        """Point-in-time serving counters + latency samples (lists are
        live references; copy before mutating)."""
        busy = (self._t_last_publish - self._t_first_apply) \
            if self._t_first_apply and self._t_last_publish else 0.0
        return {
            "version": self._version,
            "queue_depth": self._qtotal,
            "published_updates": self.published_updates,
            "engine_busy_s": busy,
            "engine_updates_per_s": self.published_updates / busy
            if busy > 0 else 0.0,
            "batches": len(self.batch_latencies),
            "batch_sizes": self.batch_sizes,
            "batch_latencies_s": self.batch_latencies,
            "batch_full_latencies_s": self.batch_full_latencies,
            "ingest_latencies_s": self.ingest_latencies,
            "query_latencies_s": self.query_latencies,
            "staleness_samples": self.staleness_samples,
            "tenants": {
                name: {"submitted": t.submitted, "committed": t.committed,
                       "queries": t.queries,
                       "rejected_updates": t.rejected_updates,
                       "rejected_queries": t.rejected_queries}
                for name, t in self._tenants.items()},
        }


class ServeStopped(RuntimeError):
    """submit() blocked on a full queue of a server that is shutting down."""

    def __init__(self, tenant: str):
        super().__init__(f"server stopped while {tenant!r} waited on a "
                         f"full queue")
