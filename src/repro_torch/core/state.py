"""Engine state: per-layer embeddings + unnormalized aggregates + degrees.

RIPPLE's assumption (§4.1): initial embeddings for all layers are
bootstrapped with the trained model before updates arrive.  We additionally
keep the *unnormalized* aggregate S^l and in-degree k so that ``mean``
aggregation stays exact when topology updates change degrees.  Monotonic
workloads (max/min) carry one more array per layer: the contributor refs
``C[l][v, d]``, the in-neighbor whose layer-(l-1) embedding attains the
stored extremum ``S[l][v, d]`` (see core/aggregators.py).  Bounded
workloads (attention / top-k / PNA) carry the cached partial state ``A``
and the certified staleness ``eps`` of approximate mode.  The state is
NumPy on the host; the device engine mirrors it on its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tracing import span

from .aggregators import compute_contributors
from .full import bounded_aux, full_inference
from .graph import DynamicGraph
from .workloads import Workload


@dataclass
class InferenceState:
    """Mutable per-vertex state owned by an engine."""

    H: list[np.ndarray]  # H[0..L]: embeddings per layer; H[0] = features
    S: list[np.ndarray]  # S[1..L]: unnormalized aggregates (S[0] unused)
    k: np.ndarray        # in-degree (float32), shared across layers
    C: list[np.ndarray] | None = None  # C[1..L]: monotonic contributor refs
    #                                    (int32, -1 = empty; None if invertible)
    A: list[dict] | None = None  # A[1..L]: bounded-family cached partial
    #                              state, arrays in aux_names order
    #                              (A[0] = {} placeholder; None otherwise)
    eps: np.ndarray | None = None  # [L+1]: certified staleness of stored
    #                                H[l] under tolerance>0 deferral

    @classmethod
    def bootstrap(cls, workload: Workload, params: list, x: np.ndarray,
                  graph: DynamicGraph, device="cuda") -> "InferenceState":
        """One full layer-wise pass on ``device`` (where ``params`` live).

        The bounded family's ``A`` comes from the same device
        reaggregation the pass runs (:func:`bounded_aux`), not from the
        host's ``compute_bounded_aux``, which walks every edge and dim in
        NumPy."""
        with span("InferenceState.full_pass", setup=True):
            x_t = torch.as_tensor(np.asarray(x, dtype=np.float32),
                                  device=device)
            src, dst, w = graph.coo()
            H_t, S_t = full_inference(workload, params, x_t, src, dst, w,
                                      graph.in_degree)
            H = [_to_numpy(h) for h in H_t]
            S = [_to_numpy(s) for s in S_t]
        agg = workload.agg
        C = A = eps = None
        if agg.algebra == "monotonic":
            with span("InferenceState.contributors", setup=True):
                C = compute_contributors(agg, H, S, graph)
        if agg.tracks_aux:
            with span("InferenceState.aux", setup=True):
                A = aux_to_numpy(bounded_aux(workload, H_t, src, dst))
            eps = np.zeros(workload.spec.n_layers + 1, dtype=np.float32)
        return cls(H=H, S=S, k=graph.in_degree.copy(), C=C, A=A, eps=eps)

    def clone(self) -> "InferenceState":
        """A deep copy: every array copied, nothing shared."""
        return InferenceState(H=[h.copy() for h in self.H],
                              S=[s.copy() for s in self.S],
                              k=self.k.copy(),
                              C=None if self.C is None
                              else [c.copy() for c in self.C],
                              A=None if self.A is None
                              else [{k_: v.copy() for k_, v in a.items()}
                                    for a in self.A],
                              eps=None if self.eps is None
                              else self.eps.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # a fresh writable array: the engines update host state in place
    return np.array(t.detach().cpu().numpy(), dtype=np.float32)


def aux_to_numpy(A: list[dict]) -> list[dict]:
    """Per-layer aux tensors -> fresh host arrays (dtypes kept: ``mref``
    is int32)."""
    return [{nm: np.array(a.detach().cpu().numpy()) for nm, a in layer.items()}
            for layer in A]


def params_to_numpy(params: list) -> list[dict]:
    """Layer modules -> the reference's ``list[dict[str, np.ndarray]]``."""
    return [{name: _to_numpy(p) for name, p in layer.named_parameters()}
            for layer in params]
