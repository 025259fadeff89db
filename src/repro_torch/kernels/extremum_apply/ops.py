"""Wrapper of the fused monotonic hop apply: the CUDA kernel
(``csrc/extremum_apply.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import check_operand, cuda_device, on_cpu
from .ref import extremum_apply_ref


@functools.cache
def _launcher():
    fn = _build.load("extremum_apply").extremum_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extremum_apply(S, mailbox, W, b, *, reagg=None, mask=None,
                   maximize: bool = True, relu: bool = True):
    """Fused S' = max|min(base, M); h = act(finite(S') @ W + b), where
    base = ``mask ? reagg : S`` when ``reagg``/``mask`` are given (the
    per-dim SHRINK variant) and ``S`` otherwise.  Returns (S', h).

    The mask may be bool or uint8, or fp32 as the reference passes it
    (nonzero means set); the kernel reads one byte per cell.
    ``extremum_apply.launches`` counts the kernel launches of this process.
    """
    if (reagg is None) != (mask is None):
        raise ValueError("reagg and mask travel together")
    masked = reagg is not None
    operands = (S, mailbox, W, b) + ((reagg, mask) if masked else ())
    if on_cpu(*operands):
        return extremum_apply_ref(S, mailbox, W, b, reagg=reagg, mask=mask,
                                  maximize=maximize, relu=relu)
    dev = cuda_device(S)
    if S.dim() != 2 or W.dim() != 2:
        raise ValueError("S and W must be 2-D")
    R, Din = S.shape
    Dout = W.shape[1]
    if Din < 1 or Dout < 1:
        raise ValueError(f"widths must be positive: Din={Din} Dout={Dout}")
    checks = [("S", S, (R, Din)), ("mailbox", mailbox, (R, Din)),
              ("W", W, (Din, Dout)), ("b", b, (Dout,))]
    if masked:
        checks.append(("reagg", reagg, (R, Din)))
        if mask.dtype == torch.float32:
            mask = mask != 0
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"mask is {mask.dtype}, expected bool, uint8 "
                            f"or float32")
        if mask.device != dev or tuple(mask.shape) != (R, Din) \
                or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous {(R, Din)} tensor "
                             f"on {dev}")
    for name, t, shape in checks:
        check_operand(name, t, shape, dev)
    S_new = torch.empty_like(S)
    h = torch.empty((R, Dout), dtype=torch.float32, device=dev)
    if R == 0:
        return S_new, h
    with torch.cuda.device(dev):
        err = _launcher()(S.data_ptr(), mailbox.data_ptr(),
                          reagg.data_ptr() if masked else None,
                          mask.data_ptr() if masked else None,
                          W.data_ptr(), b.data_ptr(), S_new.data_ptr(),
                          h.data_ptr(), R, Din, Dout, int(maximize),
                          int(relu), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"extremum_apply kernel launch failed: CUDA error "
                           f"{err}")
    extremum_apply.launches += 1
    return S_new, h


extremum_apply.launches = 0
