"""Wrapper of the fused GIN apply: the CUDA kernel (``csrc/mlp_apply.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import check_operand, cuda_device, on_cpu
from .ref import mlp_apply_ref

# the opt-in shared memory one H100 block may use (232,448 bytes)
_MAX_SMEM = 227 * 1024


@functools.cache
def _lib():
    lib = _build.load("mlp_apply")
    lib.mlp_apply_launch.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.mlp_apply_launch.restype = ctypes.c_int
    lib.mlp_apply_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mlp_apply_smem_bytes.restype = ctypes.c_longlong
    return lib


def mlp_apply(S, mailbox, h_prev, k, eps: float, W1, b1, W2, b2, *,
              mean: bool = False, relu: bool = True):
    """Fused S' = S + M; h = act(relu(((1+eps) h_prev + norm(S', k)) @ W1
    + b1) @ W2 + b2).  ``eps`` is a host float.  Returns (S', h).

    ``mlp_apply.launches`` counts the kernel launches of this process
    and ``launches_by_shape`` those at each shape ``(R, Din, Dh, Dout)``.
    """
    eps = float(eps)
    if on_cpu(S, mailbox, h_prev, k, W1, b1, W2, b2):
        return mlp_apply_ref(S, mailbox, h_prev, k, eps, W1, b1, W2, b2,
                             mean=mean, relu=relu)
    dev = cuda_device(S)
    if S.dim() != 2 or W1.dim() != 2 or W2.dim() != 2:
        raise ValueError("S, W1 and W2 must be 2-D")
    R, Din = S.shape
    Dh, Dout = W1.shape[1], W2.shape[1]
    if min(Din, Dh, Dout) < 1:
        raise ValueError(f"widths must be positive: Din={Din} Dh={Dh} "
                         f"Dout={Dout}")
    for name, t, shape in (("S", S, (R, Din)), ("mailbox", mailbox, (R, Din)),
                           ("h_prev", h_prev, (R, Din)), ("k", k, (R,)),
                           ("W1", W1, (Din, Dh)), ("b1", b1, (Dh,)),
                           ("W2", W2, (Dh, Dout)), ("b2", b2, (Dout,))):
        check_operand(name, t, shape, dev)
    lib = _lib()
    smem = lib.mlp_apply_smem_bytes(Din, Dh)
    if smem > _MAX_SMEM:
        raise ValueError(f"mlp_apply: the z and h1 row tiles need {smem} B "
                         f"of shared memory at Din={Din}, Dh={Dh}; a block "
                         f"has at most {_MAX_SMEM} B")
    S_new = torch.empty_like(S)
    h = torch.empty((R, Dout), dtype=torch.float32, device=dev)
    if R == 0:
        return S_new, h
    with torch.cuda.device(dev):
        err = lib.mlp_apply_launch(
            S.data_ptr(), mailbox.data_ptr(), h_prev.data_ptr(),
            k.data_ptr(), W1.data_ptr(), b1.data_ptr(), W2.data_ptr(),
            b2.data_ptr(), S_new.data_ptr(), h.data_ptr(), R, Din, Dh, Dout,
            eps, int(mean), int(relu),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_apply kernel launch failed: CUDA error "
                           f"{err}")
    mlp_apply.launches += 1
    by_shape = mlp_apply.launches_by_shape
    by_shape[(R, Din, Dh, Dout)] = by_shape.get((R, Din, Dh, Dout), 0) + 1
    return S_new, h


mlp_apply.launches = 0
mlp_apply.launches_by_shape = {}
