"""``InferenceSession`` -- the one serving API over graph + state + engine.

The paper's deployment shape (§5, §7.3): bootstrap a snapshot, ingest
streaming updates under a latency deadline, answer embedding/label
queries, and pick the execution backend per the hardware at hand::

    session = InferenceSession.build(SessionConfig(workload="gc-s",
                                                   engine="device"))
    report  = session.ingest(session.make_stream(3000), batch_size=100,
                             deadline_ms=5.0)
    preds   = session.predict()
    session.swap_engine("full")            # migrate state mid-stream

Everything runs on ``SessionConfig.device`` (``"cuda"`` unless the caller
passes ``"cpu"``); engines that declare a ``device`` option get it.
Engine selection always goes through ``repro_torch.api.registry``.
Checkpoints and the update journal are not ported yet (ROADMAP.md
Queue 1 item 4).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import (DynamicGraph, EdgeUpdate, FeatureUpdate,
                                    UpdateBatch, erdos_renyi, powerlaw_graph)
from repro_torch.core.state import InferenceState
from repro_torch.core.workloads import Workload, make_workload
from repro_torch.data.streams import UpdateStream, make_stream, snapshot_split
from repro_torch.serve.scheduler import LatencyModel
from repro_torch.utils import resolve_device

from .registry import (Engine, UpdateResult, canonical_name, engine_options,
                       make_engine)

_GRAPH_GENS = {"er": erdos_renyi, "powerlaw": powerlaw_graph}
_CKPT_TODO = "checkpoints are not ported yet: ROADMAP.md Queue 1 item 4"


@dataclass
class SessionConfig:
    """Everything needed to bootstrap a serving session from scratch."""

    workload: str = "gc-s"
    engine: str = "device"
    engine_options: dict = field(default_factory=dict)  # per-engine extras
    graph: str = "powerlaw"          # "er" | "powerlaw"
    n: int = 2000
    m: int = 8000
    n_layers: int = 2
    d_in: int = 32
    d_hidden: int = 32
    n_classes: int = 8
    holdout_frac: float = 0.1        # edges held out for streaming re-insertion
    seed: int = 0
    deadline_ms: float = 0.0         # default ingest latency budget (0 = off)
    ckpt_dir: str = ""               # not ported yet: must stay empty
    ckpt_every: int = 10
    ckpt_keep: int = 3
    device: str = "cuda"             # torch device of params, bootstrap, engine


@dataclass
class IngestReport:
    """Latency/throughput accounting for one ``ingest`` call."""

    n_updates: int = 0
    n_batches: int = 0
    wall_seconds: float = 0.0
    latencies: list[float] = field(default_factory=list)   # per micro-batch, s
    results: list[UpdateResult] = field(default_factory=list)
    final_batch_size: int = 0

    @property
    def throughput(self) -> float:
        return self.n_updates / max(self.wall_seconds, 1e-12)

    @property
    def median_latency_ms(self) -> float:
        return float(np.median(self.latencies)) * 1e3 if self.latencies else 0.0

    @property
    def p99_latency_ms(self) -> float:
        return float(np.percentile(self.latencies, 99)) * 1e3 \
            if self.latencies else 0.0


def _flatten(updates) -> list:
    """Normalize any accepted ingest input to a flat list of updates."""
    if isinstance(updates, UpdateBatch):
        return list(updates.edges) + list(updates.features)
    if isinstance(updates, UpdateStream):
        return list(updates.updates)
    if isinstance(updates, (EdgeUpdate, FeatureUpdate)):
        return [updates]
    flat: list = []
    for u in updates:
        flat.extend(_flatten(u))
    return flat


def _to_batch(chunk: Sequence) -> UpdateBatch:
    b = UpdateBatch()
    for u in chunk:
        (b.edges if isinstance(u, EdgeUpdate) else b.features).append(u)
    return b


class InferenceSession:
    """Facade owning graph + state + engine with ingest/query/swap."""

    def __init__(self, workload: Workload, params: list, graph: DynamicGraph,
                 state: InferenceState, engine: str = "device", *,
                 engine_options: dict | None = None, device="cuda",
                 deadline_ms: float = 0.0, ckpt_dir: str = "",
                 holdout=None, seed: int = 0):
        if ckpt_dir:
            raise NotImplementedError(_CKPT_TODO)
        self.workload = workload
        self.params = params
        self.graph = graph
        self.state = state
        self.device = resolve_device(device)
        self.engine_name = canonical_name(engine)
        self.engine_options = dict(engine_options or {})
        self.engine: Engine = self._make_engine(self.engine_name,
                                                self.engine_options)
        self.deadline_ms = deadline_ms
        self.holdout = holdout
        self.seed = seed
        self.step = 0                     # micro-batches applied

    def _make_engine(self, name: str, options: dict) -> Engine:
        options = dict(options)
        if "device" in engine_options(name):
            options.setdefault("device", self.device)
        return make_engine(name, self.workload, self.params, self.graph,
                           self.state, **options)

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, config: SessionConfig) -> "InferenceSession":
        """Bootstrap graph, params, and state from a config (synthetic data
        path; bring-your-own-graph via ``bootstrap``).  Graph, split and
        features are those of the reference for the same seed; the weights
        come from a torch generator seeded with ``config.seed``."""
        if config.ckpt_dir:
            raise NotImplementedError(_CKPT_TODO)
        device = resolve_device(config.device)
        wl = make_workload(config.workload, n_layers=config.n_layers,
                           d_in=config.d_in, d_hidden=config.d_hidden,
                           n_classes=config.n_classes)
        gen = _GRAPH_GENS[config.graph]
        src, dst, w = gen(config.n, config.m, seed=config.seed,
                          weighted=wl.spec.weighted)
        snap, holdout = snapshot_split(src, dst, w, config.holdout_frac,
                                       seed=config.seed)
        graph = DynamicGraph(config.n, *snap)
        rng = np.random.default_rng(config.seed)
        x = rng.normal(size=(config.n, config.d_in)).astype(np.float32)
        params = wl.init_params(torch.Generator().manual_seed(config.seed),
                                device=device)
        state = InferenceState.bootstrap(wl, params, x, graph, device=device)
        return cls(wl, params, graph, state, config.engine,
                   engine_options=config.engine_options, device=device,
                   deadline_ms=config.deadline_ms, holdout=holdout,
                   seed=config.seed)

    @classmethod
    def bootstrap(cls, workload: Workload, params: list, x: np.ndarray,
                  graph: DynamicGraph, engine: str = "device", *,
                  device="cuda", **opts) -> "InferenceSession":
        """Bring-your-own graph + features (+ layer modules on ``device``):
        one full layer-wise pass precomputes all per-layer embeddings, then
        streaming starts."""
        state = InferenceState.bootstrap(workload, params, x, graph,
                                         device=device)
        return cls(workload, params, graph, state, engine, device=device,
                   **opts)

    def make_stream(self, n_updates: int, seed: int = 1,
                    feature_scale: float = 1.0,
                    mix: tuple[float, float, float] = (1.0, 1.0, 1.0),
                    skew: float = 0.0,
                    feature_target: str = "rank") -> UpdateStream:
        """Paper-protocol stream (§7.1.2) from the held-out edge split;
        ``mix``/``skew``/``feature_target`` expose the add/delete/feature
        ratio and hot-vertex locality knobs of
        :func:`repro_torch.data.streams.make_stream`."""
        if self.holdout is None:
            holdout = (np.empty(0, np.int64), np.empty(0, np.int64),
                       np.empty(0, np.float32))
        else:
            holdout = self.holdout
        return make_stream(self.graph, holdout, n_updates,
                           self.state.H[0].shape[1], seed=seed,
                           feature_scale=feature_scale, mix=mix, skew=skew,
                           feature_target=feature_target)

    # -- ingest -----------------------------------------------------------
    def ingest(self, updates, *, batch_size: int | None = None,
               deadline_ms: float | None = None,
               keep_results: bool = True) -> IngestReport:
        """Apply updates through the engine with deadline-driven
        micro-batching (the paper's latency-vs-throughput knob, §7.3).

        ``updates`` may be an ``UpdateBatch``, an ``UpdateStream``, a single
        update, or any (nested) iterable of these.  When ``deadline_ms`` is
        set, each micro-batch is sized by an online affine latency model
        (:class:`repro_torch.serve.scheduler.LatencyModel`): the largest
        batch predicted to fit the budget, clamped to the requested
        ``batch_size``.  ``keep_results=False`` drops the per-batch
        ``UpdateResult`` objects (latency floats are always kept).
        """
        deadline = self.deadline_ms if deadline_ms is None else deadline_ms
        flat = _flatten(updates)
        max_bs = batch_size or max(len(flat), 1)
        model = LatencyModel()
        bs = max_bs
        report = IngestReport(final_batch_size=bs)
        t_start = time.perf_counter()
        i = 0
        while i < len(flat):
            if deadline:
                bs = model.batch_for(deadline * 1e-3, hi=max_bs)
            chunk = flat[i:i + bs]
            i += len(chunk)
            t0 = time.perf_counter()
            res = self.apply_one(_to_batch(chunk))
            dt = time.perf_counter() - t0
            model.observe(len(chunk), dt)
            report.latencies.append(dt)
            if keep_results:
                report.results.append(res)
            report.n_updates += len(chunk)
            report.n_batches += 1
        # pipelined engines (device async_dispatch) may still have a batch
        # in flight; drain it so throughput accounting is honest
        flush = getattr(self.engine, "flush", None)
        if flush is not None:
            flush()
        report.wall_seconds = time.perf_counter() - t_start
        report.final_batch_size = bs
        return report

    def apply_one(self, batch: UpdateBatch) -> UpdateResult:
        """Apply one pre-formed micro-batch: no batching policy and no
        flush -- a pipelined engine may still hold this batch in flight
        when the call returns."""
        res = self.engine.apply_batch(batch)
        self.step += 1
        return res

    # -- query ------------------------------------------------------------
    def query(self, vertices=None) -> np.ndarray:
        """Final-layer embeddings for ``vertices`` (all vertices if None)."""
        if vertices is None:
            vertices = np.arange(self.graph.n, dtype=np.int64)
        vertices = np.asarray(vertices, dtype=np.int64)
        native = getattr(self.engine, "query", None)
        if native is not None:
            return np.asarray(native(vertices))
        return self.engine.state.H[-1][vertices]

    def predict(self, vertices=None) -> np.ndarray:
        """Class labels (argmax over the final layer)."""
        return np.argmax(self.query(vertices), axis=-1)

    # -- state management -------------------------------------------------
    def sync(self) -> InferenceState:
        """Force the engine's authoritative state back to the host."""
        self.state = self.engine.sync()
        return self.state

    def swap_engine(self, name: str, **options) -> Engine:
        """Hot-swap the execution backend mid-stream.

        Downloads the current engine's state to the host, then constructs
        the new backend over the *same* graph + state -- exact, because all
        backends share the (H, S, k) state contract, plus the contributor
        refs C of the monotonic workloads and the aux state A and staleness
        eps of the bounded ones.
        """
        name = canonical_name(name)
        if name == self.engine_name and not options:
            return self.engine
        self.sync()
        self.engine = self._make_engine(name, options)
        self.engine_name = name
        self.engine_options = dict(options)
        return self.engine

    def checkpoint(self) -> str:
        raise NotImplementedError(_CKPT_TODO)

    def restore(self, step: int | None = None, *, replay: bool = False) -> int:
        raise NotImplementedError(_CKPT_TODO)
