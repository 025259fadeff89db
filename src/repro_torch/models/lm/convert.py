"""Weight carry from the reference: ``repro``'s ``init_params`` tree, as
NumPy arrays, into the port's parameters."""
from __future__ import annotations

import numpy as np
import torch

from .config import LMConfig
from .model import param_shapes


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX hands out
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree, cfg: LMConfig, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from the reference's tree (nested dicts of
    arrays: ``np.asarray`` of each JAX leaf, fp32 or bf16), dense, MoE,
    MLA and MTP alike: the same keys and shapes, each leaf a tensor on
    ``device`` in its own dtype class -- the MoE router fp32, every other
    leaf ``dtype`` (default ``cfg.param_dtype``).  Raises on a tree whose
    keys or any leaf's shape are not ``cfg``'s."""
    dt = dtype or getattr(torch, cfg.param_dtype)

    def conv(t, want, path):
        if isinstance(want, dict):
            if not isinstance(t, dict) or set(t) != set(want):
                got = sorted(t) if isinstance(t, dict) else type(t).__name__
                raise ValueError(f"{path or 'the tree'} has keys {got}, "
                                 f"expected {sorted(want)} for {cfg.name}")
            return {k: conv(t[k], want[k], f"{path}/{k}") for k in want}
        shape, _ = want
        out = _tensor(t)
        if not out.is_floating_point():
            raise TypeError(f"{path} is {out.dtype}, not a float array")
        if tuple(out.shape) != shape:
            raise ValueError(f"{path} has shape {tuple(out.shape)}, expected "
                             f"{shape} for {cfg.name}")
        return out.to(device=device, dtype=torch.float32
                      if path.endswith("/router") else dt)

    return conv(tree, param_shapes(cfg), "")
