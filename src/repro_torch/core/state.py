"""Engine state: per-layer embeddings + unnormalized aggregates + degrees.

RIPPLE's assumption (§4.1): initial embeddings for all layers are
bootstrapped with the trained model before updates arrive.  We additionally
keep the *unnormalized* aggregate S^l and in-degree k so that ``mean``
aggregation stays exact when topology updates change degrees.  The state
is NumPy on the host; the device engine mirrors it on its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .full import full_inference
from .graph import DynamicGraph
from .workloads import Workload


@dataclass
class InferenceState:
    """Mutable per-vertex state owned by an engine."""

    H: list[np.ndarray]  # H[0..L]: embeddings per layer; H[0] = features
    S: list[np.ndarray]  # S[1..L]: unnormalized aggregates (S[0] unused)
    k: np.ndarray        # in-degree (float32), shared across layers

    @classmethod
    def bootstrap(cls, workload: Workload, params: list, x: np.ndarray,
                  graph: DynamicGraph, device="cuda") -> "InferenceState":
        """One full layer-wise pass on ``device`` (where ``params`` live)."""
        x_t = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
        H_t, S_t = full_inference(workload, params, x_t, *graph.coo(),
                                  graph.in_degree)
        return cls(H=[_to_numpy(h) for h in H_t], S=[_to_numpy(s) for s in S_t],
                   k=graph.in_degree.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # a fresh writable array: the engines update host state in place
    return np.array(t.detach().cpu().numpy(), dtype=np.float32)


def params_to_numpy(params: list) -> list[dict]:
    """Layer modules -> the reference's ``list[dict[str, np.ndarray]]``."""
    return [{name: _to_numpy(p) for name, p in layer.named_parameters()}
            for layer in params]
