"""Wrapper of the fused hop apply: the CUDA kernel (``csrc/delta_apply.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors.

The kernel has two routes, chosen by :func:`kernel_plan` before the launch:

- ``"resident"``: W resident in shared memory, persistent CTAs of one or
  two teams walking row tiles loaded by bulk copies (Din a multiple of 16,
  Dout of 4, W and the staged tiles within shared memory, 16-byte aligned
  operands);
- ``"tiled"``: one block per (32-row, 64-column) tile with W staged in
  K-chunks (the design the resident route replaced), for every other
  shape.

A failed build or launch raises; nothing runs the plain version in its
place."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _resident
from .._common import check_operand, cuda_device, on_cpu
from .._resident import device_limits
from .ref import delta_apply_ref

ROUTES = ("resident", "tiled")


@functools.cache
def kernel_plan(R: int, Din: int, Dout: int, n_sm: int,
                smem_limit: int) -> dict:
    """How the kernel takes ``R`` rows of ``Din`` -> ``Dout`` on a card of
    ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes of shared
    memory: ``{"route": "tiled"}``, or the resident route's tiling
    (``teams`` of 4 warps a CTA, ``tm`` rows a thread, ``rows`` a tile,
    ``grid`` CTAs, ``smem`` bytes; ``_resident.tiling``).  A staged cell
    takes 8 bytes (S, M) and a row 4 (k).  Cached: the dict returned is
    shared, not to be changed.

    Tiles of 8, 16 or 32 rows.  The warps of a tile read the same W rows
    from shared memory, whose bandwidth, not the FMAs, bounds a product of
    few rows a thread; so small tiles keep 1-2 rows a thread even where
    that leaves warps without a unit of 4 tm rows x 64 columns
    (``team_product`` in ``csrc/resident_apply.cuh``).  The rows a thread
    at each tile size are the fastest of a sweep on an H100 at Din 128,
    Dout 40 and 128."""
    tilings = [(32, 2), (16, 1), (8, 1)] if Dout <= 64 \
        else [(32, 4), (16, 2), (8, 2)]
    plan = _resident.tiling(R, Din, Dout, cell_bytes=8, row_bytes=4,
                            tilings=tilings, n_sm=n_sm,
                            smem_limit=smem_limit)
    return plan or {"route": "tiled"}


@functools.cache
def _launcher():
    fn = _build.load("delta_apply").delta_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(plan: dict, S, mailbox, k, W, b, S_new, h, *, mean: bool,
           relu: bool) -> None:
    """Launch ``plan``'s route on the current stream, uncounted; raises on
    a CUDA error.  The operands are checked by the caller."""
    R, Din = S.shape
    err = _launcher()(S.data_ptr(), mailbox.data_ptr(), k.data_ptr(),
                      W.data_ptr(), b.data_ptr(), S_new.data_ptr(),
                      h.data_ptr(), R, Din, W.shape[1], int(mean),
                      int(relu), plan.get("tm", 0), plan.get("rows", 0),
                      plan.get("teams", 0), plan.get("grid", 0),
                      torch.cuda.current_stream(S.device).cuda_stream)
    if err:
        raise RuntimeError(f"delta_apply kernel launch failed ({plan}): "
                           f"CUDA error {err}")


def delta_apply(S, mailbox, k, W, b, *, mean: bool = False,
                relu: bool = True):
    """Fused S' = S + M; h = act(norm(S', k) @ W + b).  Returns (S', h).

    ``delta_apply.launches`` counts the kernel launches of this process,
    ``launches_by_route`` each route's and ``launches_by_shape`` those at
    each shape ``(R, Din, Dout)``.
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
    plan = kernel_plan(R, Din, Dout, *device_limits(dev.index or 0))
    if not _resident.aligned(S, mailbox, W, b, S_new, h):
        plan = {"route": "tiled"}
    with torch.cuda.device(dev):
        launch(plan, S, mailbox, k, W, b, S_new, h, mean=mean, relu=relu)
    delta_apply.launches += 1
    delta_apply.launches_by_route[plan["route"]] += 1
    by_shape = delta_apply.launches_by_shape
    by_shape[(R, Din, Dout)] = by_shape.get((R, Din, Dout), 0) + 1
    return S_new, h


delta_apply.launches = 0
delta_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
delta_apply.launches_by_shape = {}
