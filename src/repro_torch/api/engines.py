"""Registry adapters for the execution backends.

Each adapter normalizes one backend to the ``Engine`` protocol: constructor
``(workload, params, graph, state)`` with ``params`` the workload's layer
modules, ``apply_batch`` returning an ``UpdateResult``, and ``sync()``
returning the authoritative host ``InferenceState``.

Registered backends:

    ripple      incremental delta-message engine (paper §4.3, host NumPy)
    rc          layer-wise recompute over affected neighborhoods (§4.2,
                host NumPy)
    device      device-resident incremental propagation (device_engine.py)
    vertexwise  per-target recursive expansion (the paper's DNC baseline);
                lazy -- updates mutate the graph/features, embeddings are
                computed on query
    full        from-scratch layer-wise inference over the whole graph on
                every batch (the exactness oracle as an engine)

    dist        distributed incremental RIPPLE over a (data, model) mesh of
                torch.distributed ranks (paper §5) -- declares mesh/mode/
                data_axes options
    dist-rc     the pull-based distributed recompute baseline (paper fig 12)

The host engines work on the host ``InferenceState`` that the full pass
bootstrapped on the session's device; ``full`` and ``vertexwise.sync`` run
that pass (``segment_mm`` for the invertible workloads) on their ``device``.
The distributed engines run on their mesh's device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.aggregators import compute_contributors
from repro_torch.core.device_engine import DeviceEngine
from repro_torch.core.dist_host import DistEngine
from repro_torch.core.engine import RecomputeEngine, RippleEngine
from repro_torch.core.full import bounded_aux, full_inference
from repro_torch.core.graph import DynamicGraph, UpdateBatch
from repro_torch.core.state import (InferenceState, _to_numpy, aux_to_numpy,
                                    params_to_numpy)
from repro_torch.core.vertexwise import VertexWiseEngine
from repro_torch.core.workloads import Workload
from repro_torch.launch.mesh import default_mesh
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
    src, dst, w = graph.coo()
    H, S = full_inference(workload, params, x, src, dst, w, graph.in_degree)
    state.H = [_to_numpy(h) for h in H]
    state.S = [_to_numpy(s) for s in S]
    state.k = graph.in_degree.copy()
    if workload.agg.algebra == "monotonic":
        state.C = compute_contributors(workload.agg, state.H, state.S, graph)
    if workload.agg.tracks_aux:
        state.A = aux_to_numpy(bounded_aux(workload, H, src, dst))
        # the pass above is exact: no deferred staleness survives it
        state.eps = np.zeros(workload.spec.n_layers + 1, dtype=np.float32)
    return state


class _HostAdapter:
    """Shared adapter over the NumPy host engines (ripple / rc)."""

    _impl_cls: type

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 tolerance: float = 0.0):
        self._impl = self._impl_cls(workload, params_to_numpy(params),
                                    graph, state, tolerance=tolerance)

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult:
        s = self._impl.apply_batch(batch)
        return UpdateResult(affected=np.asarray(s.final_affected),
                            wall_seconds=s.wall_seconds,
                            affected_per_hop=s.affected_per_hop,
                            messages_per_hop=s.messages_per_hop,
                            numeric_ops=s.numeric_ops,
                            shrink_events=s.shrink_events,
                            rows_reaggregated=s.rows_reaggregated,
                            dims_reaggregated=s.dims_reaggregated,
                            recover_hits=s.recover_hits,
                            patch_events=s.patch_events,
                            bound_violations=s.bound_violations,
                            deferred_rows=s.deferred_rows)

    def error_bound(self) -> np.ndarray:
        """Certified per-vertex error bound (bounded workloads; zeros
        elsewhere and at tolerance=0 with no deferred staleness)."""
        return self._impl.error_bound()

    def sync(self) -> InferenceState:
        return self._impl.state

    @property
    def state(self) -> InferenceState:
        return self._impl.state


_TOLERANCE_OPTION = EngineOption(
    "tolerance", 0.0,
    "bounded-family approximate mode: interior-layer writes within the "
    "certified deferral budget are skipped so the published error stays "
    "<= tolerance (error_bound() gives the certified bound); 0.0 is "
    "bit-exact; > 0 raises for the invertible and monotonic workloads")


@register_engine("ripple", "rp", options=(_TOLERANCE_OPTION,))
class RippleAdapter(_HostAdapter):
    _impl_cls = RippleEngine


@register_engine("rc", "recompute")
class RecomputeAdapter(_HostAdapter):
    _impl_cls = RecomputeEngine


_DEVICE_OPTION = EngineOption(
    "device", "cuda",
    "torch device the engine computes on; 'cuda' raises when no card is "
    "present (the tests pass 'cpu')")

_DEVICE_OPTIONS = (
    _DEVICE_OPTION,
    EngineOption("min_bucket", 64, "smallest static buffer capacity"),
    EngineOption("donate", True,
                 "update the H/S/C/A/k device tensors in place through the "
                 "gated commit (disable for A/B equivalence checks against "
                 "the copying path)"),
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
    _TOLERANCE_OPTION,
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
                            recover_hits=impl.last_recover_hits,
                            patch_events=impl.last_patch_events,
                            bound_violations=impl.last_bound_violations,
                            deferred_rows=impl.last_deferred_rows)

    def error_bound(self) -> np.ndarray:
        """Certified per-vertex error bound (bounded workloads; drains the
        async pipeline so the high-water epsilons are current)."""
        self._impl.flush()
        return self._impl.error_bound()

    def flush(self) -> None:
        """Drain the async pipeline (no-op when synchronous)."""
        self._impl.flush()

    def enable_commit_log(self) -> None:
        """Serving layer: record per-commit final-layer patches (captured
        at resolve time, after the gated commit is known to have landed)."""
        self._impl.enable_commit_log()

    def drain_commits(self) -> list:
        """Serving layer: pop [(commit_idx, affected, H_final_rows)] in
        commit order; the async pipeline's in-flight batch is excluded
        until its resolve."""
        return self._impl.drain_commits()

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
        if self._host.A is not None:
            names = self._impl.workload.agg.aux_names
            for a_host, a_dev in zip(self._host.A[1:], dev.A[1:]):
                for nm, t in zip(names, a_dev):
                    a_host[nm][...] = t[:n].cpu().numpy()
            self._host.eps[...] = self._impl._eps
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

    def error_bound(self) -> np.ndarray:
        """Every batch is recomputed exactly: the bound is zero."""
        return np.zeros(self.graph.n, dtype=np.float32)

    def sync(self) -> InferenceState:
        return self._state

    @property
    def state(self) -> InferenceState:
        return self._state


@register_engine("vertexwise", "dnc", options=(_DEVICE_OPTION,))
class VertexWiseAdapter:
    """Per-target recursive expansion (DNC, paper Fig. 1/8).

    Updates only mutate the graph and input features; embeddings are
    expanded per target on ``query`` (exact by construction, with all the
    redundant recomputation the paper quantifies).  ``sync()`` materializes
    the full layered state with the full pass on ``device``, so hot-swap
    out of this backend is possible.
    """

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 device="cuda"):
        self.workload = workload
        self.params = params
        self._params_np = params_to_numpy(params)
        self.graph = graph
        self.device = resolve_device(device)
        self._state = state
        self._dirty = False
        self.ops = 0  # cumulative aggregation ops across queries

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult:
        t0 = time.perf_counter()
        self.graph.apply_topology(batch.edges)
        for f in batch.features:
            self._state.H[0][f.vertex] = np.asarray(f.value, dtype=np.float32)
        self._dirty = True
        return UpdateResult(affected=_touched(batch),
                            wall_seconds=time.perf_counter() - t0)

    def query(self, vertices: np.ndarray) -> np.ndarray:
        vw = VertexWiseEngine(self.workload, self._params_np, self.graph,
                              self._state.H[0])
        out = vw.infer(np.asarray(vertices, dtype=np.int64))
        self.ops += vw.ops
        return out

    def sync(self) -> InferenceState:
        if self._dirty:
            _materialize_state(self.workload, self.params, self.graph,
                               self._state, self.device)
            self._dirty = False
        return self._state

    @property
    def state(self) -> InferenceState:
        return self.sync()


_DIST_OPTIONS = (
    EngineOption("mesh", None,
                 "torch DeviceMesh with a 'model' dimension plus the data "
                 "dimensions; None = the initialised default process group "
                 "as 'data' (model=1), or else one rank on the params' "
                 "device (NCCL on cuda, gloo on cpu)"),
    EngineOption("data_axes", ("data",),
                 "mesh dimensions the vertex partition spans -- ('pod', "
                 "'data') reaches the multi-pod geometry from launch/mesh.py"),
    EngineOption("seed", 0, "LDG partitioner seed"),
    EngineOption("min_bucket", 32, "smallest static buffer capacity"),
    EngineOption("donate", True,
                 "update the ranks' H/S/C tensors in place through the "
                 "gated commit, which keeps overflow retries bit-exact "
                 "(disable for A/B equivalence checks against the copying "
                 "path)"),
    EngineOption("async_dispatch", False,
                 "overlap host routing/packing of batch t+1 with device "
                 "compute of batch t; the overflow flag is checked lazily "
                 "and ``apply_batch`` reports the previous batch's affected "
                 "ids (flush()/sync() drain exactly)"),
    EngineOption("warm", True,
                 "run the rung-0 cap schedule once at construction on a "
                 "sentinel no-op batch"),
)


@register_engine("dist", "distributed",
                 options=_DIST_OPTIONS + (
                     EngineOption("mode", "ripple",
                                  "'ripple' (incremental) or 'rc' "
                                  "(pull-based recompute baseline)"),))
class DistAdapter:
    """Distributed RIPPLE over a mesh of ranks (paper §5) as a session
    backend.

    Every rank builds the same session and makes every call (see
    ``core/dist_host.py``).  Entry migration scatters the host
    ``InferenceState`` onto the ranks (re-partition + relabel, no
    recomputation); ``sync()`` gathers their state back into the same host
    arrays in original vertex-id order -- so ``swap_engine`` host <-> mesh
    is exact.  The session graph stays authoritative on the host: the
    engine mirrors every effective update into its relabeled copy during
    routing.

    Bounded-family workloads (ga-s, gp-m) have no distributed propagation:
    the adapter *declares* the gap by setting ``bounded_fallback`` and
    routing every call through a host ``RecomputeEngine`` -- exact
    (RC-style re-aggregation), single-shard, never silently wrong.
    """

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 mesh=None, mode: str = "ripple",
                 data_axes: tuple = ("data",), seed: int = 0,
                 min_bucket: int = 32, donate: bool = True,
                 async_dispatch: bool = False, warm: bool = True):
        self._host = state
        self.bounded_fallback = workload.agg.algebra == "bounded"
        if self.bounded_fallback:
            self._impl = None
            self._fallback = RecomputeEngine(workload,
                                             params_to_numpy(params),
                                             graph, state)
            return
        if mesh is None:
            mesh = default_mesh(next(params[0].parameters()).device)
        self._impl = DistEngine(workload, params, graph, state, mesh,
                                mode=mode, data_axes=tuple(data_axes),
                                seed=seed, min_bucket=min_bucket,
                                donate=donate, async_dispatch=async_dispatch,
                                warm=warm)

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult:
        t0 = time.perf_counter()
        if self.bounded_fallback:
            s = self._fallback.apply_batch(batch)
            return UpdateResult(affected=np.asarray(s.final_affected),
                                wall_seconds=time.perf_counter() - t0,
                                affected_per_hop=s.affected_per_hop,
                                messages_per_hop=s.messages_per_hop,
                                numeric_ops=s.numeric_ops,
                                rows_reaggregated=s.rows_reaggregated)
        affected = self._impl.apply_batch(batch)
        comm = self._impl.last_comm  # None until the first resolve (async)
        return UpdateResult(
            affected=affected,
            wall_seconds=time.perf_counter() - t0,
            messages_per_hop=[] if comm is None else [int(c) for c in comm],
            shrink_events=self._impl.last_shrink_events,
            rows_reaggregated=self._impl.last_rows_reaggregated,
            dims_reaggregated=self._impl.last_dims_reaggregated,
            recover_hits=self._impl.last_recover_hits)

    def flush(self) -> None:
        """Drain the async pipeline (no-op when synchronous)."""
        if not self.bounded_fallback:
            self._impl.flush()

    def sync(self) -> InferenceState:
        if self.bounded_fallback:
            return self._fallback.state
        return self._impl.gather_state(self._host)

    @property
    def state(self) -> InferenceState:
        return self.sync()

    def query(self, vertices: np.ndarray) -> np.ndarray:
        """Backend-native read: final-layer rows (collective)."""
        if self.bounded_fallback:
            v = np.asarray(vertices, dtype=np.int64)
            return self._fallback.state.H[-1][v]
        return self._impl.query(vertices)

    @property
    def ckpt_shards(self) -> int:
        """Data-shard count for the per-shard checkpoint layout."""
        return 1 if self.bounded_fallback else self._impl.n_parts

    @property
    def ckpt_writer(self) -> bool:
        """Whether this rank writes the session's shared files (the
        mesh's first rank; the host fallback is one process)."""
        return self.bounded_fallback or self._impl.comm.writer

    def barrier(self) -> None:
        """Wait for every rank of the mesh (no-op in the host fallback)."""
        if not self.bounded_fallback:
            self._impl.comm.barrier()

    @property
    def impl(self):
        """The underlying engine (comm counters, CSR stats) for benches."""
        return self._fallback if self.bounded_fallback else self._impl


@register_engine("dist-rc", "dist-recompute", options=_DIST_OPTIONS)
class DistRCAdapter(DistAdapter):
    """Distributed pull-based recompute baseline (paper fig 12) -- ``dist``
    with the mode pinned to 'rc'."""

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, *,
                 mesh=None, data_axes: tuple = ("data",), seed: int = 0,
                 min_bucket: int = 32, donate: bool = True,
                 async_dispatch: bool = False, warm: bool = True):
        super().__init__(workload, params, graph, state, mesh=mesh,
                         mode="rc", data_axes=data_axes, seed=seed,
                         min_bucket=min_bucket, donate=donate,
                         async_dispatch=async_dispatch, warm=warm)
