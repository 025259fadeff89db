"""Elastic scaling: resize the partition count of a running stream engine.

Strategy (snapshot -> reshard -> restart, the standard production pattern):
the engine's per-partition state is gathered into original-vertex order,
the graph is re-partitioned for the new worker count, and a fresh engine
resumes from the *exact* same embeddings -- no recomputation, no
approximation.  The engine's scatter-on-entry / gather-on-exit state
contract (dist_host.py) is what makes this a pure relabel.  Combined with
the update journal this also covers worker loss: restart on the surviving
mesh and replay from the last snapshot's high-water mark.  The new mesh
spans the same ranks (the same world) in another geometry; every rank
calls this with the same arguments.
"""
from __future__ import annotations

import numpy as np

from .dist_host import DistEngine
from .state import InferenceState


def elastic_resize(engine: DistEngine, new_mesh, *, seed: int = 0,
                   data_axes: tuple | None = None) -> DistEngine:
    """Rebuild the distributed engine on a new mesh (more/fewer partitions).

    ``data_axes`` defaults to the engine's current partition axes so a
    multi-pod geometry keeps its meaning across a resize; pass it
    explicitly when the new mesh names different axes."""
    if data_axes is None:
        data_axes = engine.data_axes
    n = engine.part.n
    dims = engine.workload.spec.dims
    state = InferenceState(
        H=[np.zeros((n, d), np.float32) for d in dims],
        S=[np.zeros((n, 1), np.float32)]
        + [np.zeros((n, d), np.float32) for d in dims[:-1]],
        k=np.zeros(n, np.float32),
        C=[np.full((n, 1), -1, np.int32)]
        + [np.full((n, d), -1, np.int32) for d in dims[:-1]]
        if engine.monotonic else None)
    engine.gather_state(state)
    return DistEngine(engine.workload, engine.params, engine.host_graph,
                      state, new_mesh, mode=engine.mode,
                      data_axes=data_axes, seed=seed)
