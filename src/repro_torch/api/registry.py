"""Unified ``Engine`` protocol + engine registry.

The paper's central claim (§4) is a *generalized* incremental programming
model: one UPDATE/AGGREGATE contract that any execution backend can
implement.  The seed grew four engines with incompatible constructor
signatures (NumPy params vs parameter trees, ``InferenceState`` vs raw
features) and hand-wired ``if/elif`` dispatch at every call site.  This
module is the contract that removes that: every backend is an ``Engine``
built from one normalized signature

    factory(workload, params, graph, state) -> Engine

where ``params`` are the layer modules from ``Workload.init_params`` or
``params_from_numpy`` (adapters convert to device layouts internally) and
``state`` is the host ``InferenceState``.  Backends self-register under a short name::

    @register_engine("ripple", "rp")
    class RippleAdapter: ...

and call sites construct via ``make_engine(name, ...)`` — adding a backend
(distributed, new kernels) is a registry entry, never another ``elif``.

Backends that need more than the normalized four (a device mesh, a
partitioning seed, ...) *declare* those extras as ``EngineOption`` entries
at registration time::

    @register_engine("dist", options=(EngineOption("mesh", None, "..."),))
    class DistAdapter: ...

``make_engine(name, workload, params, graph, state, **options)`` validates
the keyword options against the declaration — unknown options raise
``TypeError`` naming what the engine accepts, and declared-but-omitted
options are filled from their defaults, so every factory always receives
its full normalized keyword set.  Engines with no declaration accept no
options, which is how ``mesh=...`` can exist for ``dist`` without leaking
into the five single-machine backends.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.graph import DynamicGraph, UpdateBatch
from repro_torch.core.state import InferenceState
from repro_torch.core.workloads import Workload


@dataclass
class UpdateResult:
    """Engine-agnostic result of applying one update batch.

    Mirrors the host engines' ``BatchStats`` fields so benchmark code is
    backend-independent; engines that don't track a field leave it empty.
    """

    affected: np.ndarray                      # final-hop affected vertex ids
    wall_seconds: float = 0.0
    affected_per_hop: list[int] = field(default_factory=list)
    messages_per_hop: list[int] = field(default_factory=list)
    numeric_ops: int = 0
    shrink_events: int = 0      # monotonic aggregators: SHRINK messages
    rows_reaggregated: int = 0  # monotonic: rows with >=1 re-aggregated dim
    dims_reaggregated: int = 0  # monotonic: (row, dim) cells gathered
    recover_hits: int = 0       # monotonic: shrunk dims the re-cover probe
    #                             re-witnessed without touching the CSR
    patch_events: int = 0       # bounded: O(1) cache patches applied
    bound_violations: int = 0   # bounded: rows refreshed because the stale
    #                             cache could not certify the tolerance
    deferred_rows: int = 0      # bounded approximate mode: rows whose H
    #                             write was deferred under the budget

    @property
    def total_affected(self) -> int:
        if self.affected_per_hop:
            return int(sum(self.affected_per_hop))
        return int(self.affected.size)

    # back-compat alias used by benchmark bucketing
    @property
    def final_affected(self) -> np.ndarray:
        return self.affected


@runtime_checkable
class Engine(Protocol):
    """What every inference backend must provide.

    ``state`` must always be readable; for device-resident backends it may
    be a cached host mirror — ``sync()`` forces the authoritative download
    and returns the host ``InferenceState`` (the same object thereafter
    reflected by ``state``).  Engines may additionally expose
    ``query(vertices) -> np.ndarray`` for backend-native reads; the session
    falls back to ``state.H[-1]`` when absent.
    """

    def apply_batch(self, batch: UpdateBatch) -> UpdateResult: ...

    def sync(self) -> InferenceState: ...

    @property
    def state(self) -> InferenceState: ...


EngineFactory = Callable[[Workload, list, DynamicGraph, InferenceState], Engine]


@dataclass(frozen=True)
class EngineOption:
    """One declared per-engine constructor option (name, default, doc)."""

    name: str
    default: object = None
    doc: str = ""


_REGISTRY: dict[str, EngineFactory] = {}
_CANONICAL: dict[str, str] = {}  # alias -> canonical name
_OPTIONS: dict[str, dict[str, EngineOption]] = {}  # canonical -> declaration


def register_engine(name: str, *aliases: str,
                    options: tuple[EngineOption, ...] = ()
                    ) -> Callable[[EngineFactory], EngineFactory]:
    """Class/function decorator registering an engine factory under ``name``
    (plus optional aliases).  The factory must accept the normalized
    signature ``(workload, params, graph, state, **declared_options)``."""

    def deco(factory: EngineFactory) -> EngineFactory:
        for nm in (name, *aliases):
            key = nm.lower()
            if key in _REGISTRY:
                raise ValueError(f"engine {key!r} already registered")
            _REGISTRY[key] = factory
            _CANONICAL[key] = name.lower()
        _OPTIONS[name.lower()] = {o.name: o for o in options}
        factory.engine_name = name.lower()  # type: ignore[attr-defined]
        return factory

    return deco


def engine_names(*, canonical_only: bool = True) -> list[str]:
    """Registered engine names (canonical by default, aliases included
    otherwise)."""
    if canonical_only:
        return sorted(set(_CANONICAL.values()))
    return sorted(_REGISTRY)


def canonical_name(name: str) -> str:
    key = name.lower()
    if key not in _CANONICAL:
        raise KeyError(
            f"unknown engine {name!r}; registered: {', '.join(engine_names())}")
    return _CANONICAL[key]


def engine_options(name: str) -> dict[str, EngineOption]:
    """The option declaration for ``name`` (empty for option-less engines)."""
    return dict(_OPTIONS[canonical_name(name)])


def normalize_options(name: str, options: dict) -> dict:
    """Validate ``options`` against ``name``'s declaration and fill defaults.

    Unknown options raise ``TypeError`` naming what the engine accepts;
    the result always contains every declared option.
    """
    decl = _OPTIONS[canonical_name(name)]
    unknown = sorted(set(options) - set(decl))
    if unknown:
        accepted = ", ".join(sorted(decl)) if decl else "none"
        raise TypeError(
            f"engine {canonical_name(name)!r} does not accept option(s) "
            f"{unknown}; accepted: {accepted}")
    full = {nm: o.default for nm, o in decl.items()}
    full.update(options)
    return full


def make_engine(name: str, workload: Workload, params: list,
                graph: DynamicGraph, state: InferenceState,
                **options) -> Engine:
    """Construct a registered engine from the normalized signature.

    ``options`` must be a subset of the engine's declared ``EngineOption``
    set; omitted options are filled from their declared defaults.  An
    engine registered with an ``unported`` note raises
    ``NotImplementedError`` naming where it lands."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown engine {name!r}; registered: {', '.join(engine_names())}")
    unported = getattr(_REGISTRY[key], "unported", None)
    if unported:
        raise NotImplementedError(
            f"engine {canonical_name(key)!r} is not ported yet: {unported}")
    return _REGISTRY[key](workload, params, graph, state,
                          **normalize_options(key, options))
