"""Wrapper of the fused monotonic hop apply: the CUDA kernel
(``csrc/extremum_apply.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

The kernel has two routes, chosen by :func:`kernel_plan` before the launch:

- ``"resident"``: W resident in shared memory, persistent CTAs of one or
  two teams walking row tiles loaded by bulk copies (Din a multiple of 16,
  Dout of 4, W and the staged tiles within shared memory, 16-byte aligned
  operands);
- ``"kchunk"``: W staged in K-chunks, for every other shape.

A failed build or launch raises; nothing runs the plain version in its
place."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _resident
from .._common import check_operand, cuda_device, on_cpu
from .._resident import device_limits
from .ref import extremum_apply_ref

ROUTES = ("resident", "kchunk")


@functools.cache
def kernel_plan(R: int, Din: int, Dout: int, masked: bool, n_sm: int,
                smem_limit: int) -> dict:
    """How the kernel takes ``R`` rows of ``Din`` -> ``Dout`` on a card of
    ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes of shared
    memory: ``{"route": "kchunk"}``, or the resident route's tiling
    (``teams`` of 4 warps a CTA, ``tm`` rows a thread, ``rows`` a tile,
    ``grid`` CTAs, ``smem`` bytes; ``_resident.tiling``).  Cached: the
    dict returned is shared, not to be changed.

    A staged cell takes 8 bytes (S, M), 13 masked (and reagg, the mask).
    Tiles of 8, 16 or 32 rows at Dout > 64 and of 16 or 32 at Dout <= 64
    (the row counts the resident route has always had, which its plan
    tests pin), each with ``delta_apply``'s rows a thread for that
    tile size (the two kernels share ``csrc/resident_apply.cuh``)."""
    tilings = [(32, 4), (16, 2), (8, 2)] if Dout > 64 else [(32, 2), (16, 1)]
    plan = _resident.tiling(
        R, Din, Dout, cell_bytes=13 if masked else 8, row_bytes=0,
        tilings=tilings, n_sm=n_sm, smem_limit=smem_limit)
    return plan or {"route": "kchunk"}


@functools.cache
def _launcher():
    fn = _build.load("extremum_apply").extremum_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
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
    ``extremum_apply.launches`` counts the kernel launches of this process,
    ``launches_by_route`` each route's and ``launches_by_shape`` those at
    each shape ``(R, Din, Dout)``.
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
    plan = kernel_plan(R, Din, Dout, masked, *device_limits(dev.index or 0))
    launched = (S, mailbox, W, b, S_new, h) + ((reagg, mask) if masked
                                                else ())
    if not _resident.aligned(*launched):
        plan = {"route": "kchunk"}
    with torch.cuda.device(dev):
        err = _launcher()(S.data_ptr(), mailbox.data_ptr(),
                          reagg.data_ptr() if masked else None,
                          mask.data_ptr() if masked else None,
                          W.data_ptr(), b.data_ptr(), S_new.data_ptr(),
                          h.data_ptr(), R, Din, Dout, int(maximize),
                          int(relu), plan.get("tm", 0), plan.get("rows", 0),
                          plan.get("teams", 0), plan.get("grid", 0),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"extremum_apply kernel launch failed: CUDA error "
                           f"{err}")
    extremum_apply.launches += 1
    extremum_apply.launches_by_route[plan["route"]] += 1
    by_shape = extremum_apply.launches_by_shape
    by_shape[(R, Din, Dout)] = by_shape.get((R, Din, Dout), 0) + 1
    return S_new, h


extremum_apply.launches = 0
extremum_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
extremum_apply.launches_by_shape = {}
