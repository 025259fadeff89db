"""Wrapper of causal grouped-query attention: the CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import cuda_device, on_cpu
from .ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q ``[B,S,H,Dh]`` over k/v ``[B,S,Hkv,Dh]`` with
    the ``H / Hkv`` query heads of each kv head grouped together; returns
    ``[B,S,H,Dh]`` in q's dtype.  fp32 or bf16, all three of one dtype,
    contiguous; ``Dh`` one of :data:`HEAD_DIMS`; any ``S``.
    ``flash_attention.launches`` counts the kernel launches of this
    process."""
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v)
    dev = cuda_device(q)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q is {q.dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one of {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    for name, t, shape in (("q", q, (B, S, H, Dh)), ("k", k, (B, S, Hkv, Dh)),
                           ("v", v, (B, S, Hkv, Dh))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    if B * S * H * Dh >= 2**31:
        raise ValueError(f"q has {B * S * H * Dh} elements, beyond the "
                         f"kernel's int32 extents")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, S, H, Hkv, Dh,
                          int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
