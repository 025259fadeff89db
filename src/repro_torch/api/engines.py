"""Registry adapters for the execution backends.

Each adapter normalizes one backend to the ``Engine`` protocol: constructor
``(workload, params, graph, state)`` with ``params`` the workload's layer
modules, ``apply_batch`` returning an ``UpdateResult``, and ``sync()``
returning the authoritative host ``InferenceState``.

Registered backends:

    device      device-resident incremental propagation (device_engine.py)
    full        from-scratch layer-wise inference over the whole graph on
                every batch (the exactness oracle as an engine)

The reference's other engine names (ripple, rc, vertexwise, dist, dist-rc)
are registered too, so the name table matches; building one raises
``NotImplementedError`` naming the ROADMAP.md item where it lands.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.aggregators import compute_contributors
from repro_torch.core.device_engine import DeviceEngine
from repro_torch.core.full import full_inference
from repro_torch.core.graph import DynamicGraph, UpdateBatch
from repro_torch.core.state import InferenceState, _to_numpy
from repro_torch.core.workloads import Workload
from repro_torch.utils import resolve_device

from .registry import EngineOption, UpdateResult, register_engine


def _touched(batch: UpdateBatch) -> np.ndarray:
    """Vertices directly hit by a batch (edge dsts + feature targets)."""
    ids = [e.dst for e in batch.edges] + [f.vertex for f in batch.features]
    return np.unique(np.asarray(ids, dtype=np.int64))


def _materialize_state(workload: Workload, params: list, graph: DynamicGraph,
                       state: InferenceState, device) -> InferenceState:
    """From-scratch layer-wise pass over the current graph + features on
    ``device``, written into ``state`` in place (exact, the oracle's
    output)."""
    x = torch.as_tensor(state.H[0], device=resolve_device(device))
    H, S = full_inference(workload, params, x, *graph.coo(),
                          graph.in_degree)
    state.H = [_to_numpy(h) for h in H]
    state.S = [_to_numpy(s) for s in S]
    state.k = graph.in_degree.copy()
    if workload.agg.algebra == "monotonic":
        state.C = compute_contributors(workload.agg, state.H, state.S, graph)
    return state


_DEVICE_OPTION = EngineOption(
    "device", "cuda",
    "torch device the engine computes on; 'cuda' raises when no card is "
    "present (the tests pass 'cpu')")

_DEVICE_OPTIONS = (
    _DEVICE_OPTION,
    EngineOption("min_bucket", 64, "smallest static buffer capacity"),
    EngineOption("donate", True,
                 "update the H/S/C/k device tensors in place through the gated "
                 "commit (disable for A/B equivalence checks against the "
                 "copying path)"),
    EngineOption("use_pallas", False,
                 "accepted so engine options move across from the JAX "
                 "package, and inert: the hop apply always runs through the "
                 "fused kernels (CUDA on a card, their plain versions on "
                 "the CPU)"),
    EngineOption("async_dispatch", False,
                 "overlap host routing of batch t+1 with device compute of "
                 "batch t; the overflow flag is checked lazily and "
                 "``apply_batch`` reports the previous batch's affected ids "
                 "(flush()/sync() drain exactly)"),
    EngineOption("debug_checks", False,
                 "assert the on-device in-degree vector k matches the host "
                 "graph after every batch"),
    EngineOption("warm", True,
                 "run the rung-0 cap schedule once at construction on a "
                 "sentinel no-op batch"),
    EngineOption("tolerance", 0.0,
                 "bounded-family approximate mode; the invertible and "
                 "monotonic workloads ported here are exact, so any value "
                 "> 0 raises"),
)


@register_engine("device", "jit", options=_DEVICE_OPTIONS)
class DeviceAdapter:
    """Device-resident propagation; state lives on the device between
    batches.

    ``sync()`` downloads the device state *into the host ``InferenceState``
    object this adapter was built from* (in place), so hot-swapping to
    another engine hands over the same arrays the session already holds.
    """

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 device="cuda", min_bucket: int = 64, donate: bool = True,
                 use_pallas: bool = False, async_dispatch: bool = False,
                 debug_checks: bool = False, warm: bool = True,
                 tolerance: float = 0.0):
        self._host = state
        self._impl = DeviceEngine(workload, params, graph, state,
                                  device=device, min_bucket=min_bucket,
                                  donate=donate, use_pallas=use_pallas,
                                  async_dispatch=async_dispatch,
                                  debug_checks=debug_checks, warm=warm,
                                  tolerance=tolerance)

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult:
        # synchronous mode: the resolve inside already waited for the
        # batch's report, which the device writes after the commit, so
        # wall_seconds covers the fully committed state
        t0 = time.perf_counter()
        affected = self._impl.apply_batch(batch)
        impl = self._impl
        return UpdateResult(affected=affected,
                            wall_seconds=time.perf_counter() - t0,
                            affected_per_hop=[int(affected.size)],
                            shrink_events=impl.last_shrink_events,
                            rows_reaggregated=impl.last_rows_reaggregated,
                            dims_reaggregated=impl.last_dims_reaggregated,
                            recover_hits=impl.last_recover_hits)

    def flush(self) -> None:
        """Drain the async pipeline (no-op when synchronous)."""
        self._impl.flush()

    def enable_commit_log(self) -> None:
        self._impl.enable_commit_log()

    @property
    def impl(self) -> DeviceEngine:
        """The underlying engine (mirror counters, ladder stats)."""
        return self._impl

    def sync(self) -> InferenceState:
        self._impl.flush()
        n = self._impl.n
        dev = self._impl.state
        for h_host, h_dev in zip(self._host.H, dev.H):
            h_host[...] = h_dev[:n].cpu().numpy()
        for s_host, s_dev in zip(self._host.S[1:], dev.S[1:]):
            s_host[...] = s_dev[:n].cpu().numpy()
        self._host.k[...] = dev.k[:n].cpu().numpy()
        if self._host.C is not None:
            for c_host, c_dev in zip(self._host.C[1:], dev.C[1:]):
                c_host[...] = c_dev[:n].cpu().numpy()
        return self._host

    @property
    def state(self) -> InferenceState:
        return self.sync()

    def query(self, vertices: np.ndarray) -> np.ndarray:
        """Backend-native read: final-layer rows straight off the device
        (drains the async pipeline first so reads see every applied
        batch)."""
        vertices = np.asarray(vertices, dtype=np.int64)
        if vertices.size and (vertices.min() < 0
                              or vertices.max() >= self._impl.n):
            # checked here: a bad index on the card is a device-side assert
            raise IndexError(f"query vertices outside [0, {self._impl.n})")
        self._impl.flush()
        idx = torch.as_tensor(vertices, device=self._impl.device)
        return self._impl.state.H[-1][idx].cpu().numpy()


@register_engine("full", "oracle", options=(_DEVICE_OPTION,))
class FullRecomputeAdapter:
    """From-scratch layer-wise inference after every batch (§2.1 baseline)."""

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 device="cuda"):
        self.workload = workload
        self.params = params
        self.graph = graph
        self.device = resolve_device(device)
        self._state = state

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult:
        t0 = time.perf_counter()
        self.graph.apply_topology(batch.edges)
        for f in batch.features:
            self._state.H[0][f.vertex] = np.asarray(f.value, dtype=np.float32)
        _materialize_state(self.workload, self.params, self.graph,
                           self._state, self.device)
        return UpdateResult(affected=_touched(batch),
                            wall_seconds=time.perf_counter() - t0,
                            numeric_ops=2 * self.graph.num_edges
                            * self.workload.spec.n_layers)

    def sync(self) -> InferenceState:
        return self._state

    @property
    def state(self) -> InferenceState:
        return self._state


def _unported(name: str, *aliases: str, item: str) -> None:
    """Register a reference engine name whose port is still to come."""
    def factory(*args, **kwargs):
        raise NotImplementedError(f"engine {name!r} is not ported yet: {item}")
    factory.unported = item
    register_engine(name, *aliases)(factory)


_unported("ripple", "rp", item="ROADMAP.md Queue 1 item 3 (host engines)")
_unported("rc", "recompute", item="ROADMAP.md Queue 1 item 3 (host engines)")
_unported("vertexwise", "dnc",
          item="ROADMAP.md Queue 1 item 8 (vertexwise engine)")
_unported("dist", "distributed",
          item="ROADMAP.md Queue 1 item 10 (distributed path)")
_unported("dist-rc", "dist-recompute",
          item="ROADMAP.md Queue 1 item 10 (distributed path)")
