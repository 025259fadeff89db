"""Weight carry from the reference: ``repro``'s ``init_params`` tree, as
NumPy arrays, into the port's parameters."""
from __future__ import annotations

import numpy as np
import torch

from .config import LMConfig
from .model import _check_dense


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX hands out
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree, cfg: LMConfig, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from the reference's tree (nested dicts of
    arrays: ``np.asarray`` of each JAX leaf, fp32 or bf16): the same keys
    and shapes, each leaf a tensor of ``dtype`` (default
    ``cfg.param_dtype``) on ``device``.  Raises on a tree that is not the
    dense-GQA layout of ``cfg``."""
    _check_dense(cfg)
    dt = dtype or getattr(torch, cfg.param_dtype)
    want = {"embed", "ln_f", "dense_blocks"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != want:
        raise ValueError(f"tree keys {sorted(tree)} are not the dense "
                         f"layout's {sorted(want)}")

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in t.items()}
        out = _tensor(t)
        if not out.is_floating_point():
            raise TypeError(f"{path} is {out.dtype}, not a float array")
        return out.to(device=device, dtype=dt)

    params = conv(tree, "")
    L, D = cfg.n_layers, cfg.d_model
    blocks = params["dense_blocks"]
    for path, t, shape in (
            ("embed", params["embed"], (cfg.vocab, D)),
            ("dense_blocks/ln1", blocks["ln1"], (L, D)),
            ("dense_blocks/attn/w_q", blocks["attn"]["w_q"],
             (L, D, cfg.n_heads, cfg.head_dim)),
            ("dense_blocks/attn/w_k", blocks["attn"]["w_k"],
             (L, D, cfg.n_kv_heads, cfg.head_dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{path} has shape {tuple(t.shape)}, expected "
                             f"{shape} for {cfg.name}")
    return params
