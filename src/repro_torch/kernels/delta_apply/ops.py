"""Wrapper of the fused hop apply: the CUDA kernel (``csrc/delta_apply.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import check_operand, cuda_device, on_cpu
from .ref import delta_apply_ref


@functools.cache
def _launcher():
    fn = _build.load("delta_apply").delta_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def delta_apply(S, mailbox, k, W, b, *, mean: bool = False,
                relu: bool = True):
    """Fused S' = S + M; h = act(norm(S', k) @ W + b).  Returns (S', h).

    ``delta_apply.launches`` counts the kernel launches of this process
    and ``launches_by_shape`` those at each shape ``(R, Din, Dout)``.
    """
    if on_cpu(S, mailbox, k, W, b):
        return delta_apply_ref(S, mailbox, k, W, b, mean=mean, relu=relu)
    dev = cuda_device(S)
    if S.dim() != 2 or W.dim() != 2:
        raise ValueError("S and W must be 2-D")
    R, Din = S.shape
    Dout = W.shape[1]
    if Din < 1 or Dout < 1:
        raise ValueError(f"widths must be positive: Din={Din} Dout={Dout}")
    for name, t, shape in (("S", S, (R, Din)), ("mailbox", mailbox, (R, Din)),
                           ("k", k, (R,)), ("W", W, (Din, Dout)),
                           ("b", b, (Dout,))):
        check_operand(name, t, shape, dev)
    S_new = torch.empty_like(S)
    h = torch.empty((R, Dout), dtype=torch.float32, device=dev)
    if R == 0:
        return S_new, h
    with torch.cuda.device(dev):
        err = _launcher()(S.data_ptr(), mailbox.data_ptr(), k.data_ptr(),
                          W.data_ptr(), b.data_ptr(), S_new.data_ptr(),
                          h.data_ptr(), R, Din, Dout, int(mean), int(relu),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"delta_apply kernel launch failed: CUDA error "
                           f"{err}")
    delta_apply.launches += 1
    by_shape = delta_apply.launches_by_shape
    by_shape[(R, Din, Dout)] = by_shape.get((R, Din, Dout), 0) + 1
    return S_new, h


delta_apply.launches = 0
delta_apply.launches_by_shape = {}
