"""Wrapper of the fused GIN apply: the CUDA kernel (``csrc/mlp_apply.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors.

The kernel has two routes, chosen by :func:`kernel_plan` before the
launch:

- ``"resident"``: persistent CTAs, each holding W1 and W2 resident in
  shared memory, walking row tiles loaded by bulk copies (Din a multiple
  of 16, Dh of 8, Dout of 4, the weights and a tile within the card's
  opt-in shared memory, 16-byte aligned operands);
- ``"tiled"``: one block per 32-row tile with the weights staged in
  K-chunks (the design the resident route replaced), for every other
  shape; widths whose z and h1 tiles do not fit in shared memory are
  refused.

A failed build or launch raises; nothing runs the plain version in its
place."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _resident
from .._common import check_operand, cuda_device, on_cpu
from .._resident import device_limits
from .ref import mlp_apply_ref

ROUTES = ("resident", "tiled")


def resident_smem(Din: int, Dh: int, Dout: int, rows: int, ns: int) -> int:
    """Shared memory of one CTA of the resident route, in bytes
    (``MlpPlan`` in ``csrc/mlp_apply.cu``): W1 and W2, ``ns`` stages of
    S, M and h_prev, z, h1, k, the mbarriers."""
    plane = rows * Din * 4
    return (4 * Dh * (Din + Dout) + (3 * ns + 1) * plane + 4 * rows * Dh
            + _resident.round16(4 * rows) + (ns + 1) * 8)


def thread_rows(rows: int, ncols: int) -> int:
    """Rows a thread takes in a product of ``ncols`` output columns over a
    tile of ``rows`` rows: the fastest of a sweep on an H100 (1-2 in tiles
    of up to 16 rows, 2-4 in tiles of 32; fewer where the product has at
    most 64 columns, so that its units of 4 x rows-a-thread rows x 64
    columns still reach several warps)."""
    return (2 if rows < 32 else 4) // (2 if ncols <= 64 else 1)


@functools.cache
def kernel_plan(R: int, Din: int, Dh: int, Dout: int, n_sm: int,
                smem_limit: int) -> dict:
    """How the kernel takes ``R`` rows of ``Din`` -> ``Dh`` -> ``Dout`` on
    a card of ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes
    of shared memory: ``{"route": "tiled"}``, or the resident route's
    tiling: ``rows`` a tile (8, 16, 32), ``tm1`` and ``tm2`` rows a thread
    in the two products, ``ns`` stages of inputs, ``grid`` CTAs, ``smem``
    bytes a CTA.  Cached: the dict returned is shared, not to be changed.

    The tiles are the smallest that leave no SM two of them; where even
    32-row tiles outnumber the SMs, 32 rows and two stages, so that a
    tile's loads run under the previous tile's products.  A tiling whose
    shared memory does not fit takes fewer stages, then smaller tiles,
    then the tiled route."""
    if Din % 16 or Dh % 8 or Dout % 4:
        return {"route": "tiled"}
    sizes = (8, 16, 32)
    first = next((i for i, rows in enumerate(sizes)
                  if -(-R // rows) <= n_sm), len(sizes) - 1)
    for rows in reversed(sizes[:first + 1]):
        tiles = -(-R // rows)
        for ns in ((2, 1) if tiles > n_sm else (1,)):
            smem = resident_smem(Din, Dh, Dout, rows, ns)
            if smem <= smem_limit:
                return dict(route="resident", rows=rows,
                            tm1=thread_rows(rows, Dh),
                            tm2=thread_rows(rows, Dout), ns=ns,
                            grid=min(tiles, n_sm), smem=smem)
    return {"route": "tiled"}


@functools.cache
def _lib():
    lib = _build.load("mlp_apply")
    lib.mlp_apply_launch.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.mlp_apply_launch.restype = ctypes.c_int
    lib.mlp_apply_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mlp_apply_smem_bytes.restype = ctypes.c_longlong
    lib.mlp_apply_resident_smem.argtypes = [ctypes.c_int] * 5
    lib.mlp_apply_resident_smem.restype = ctypes.c_longlong
    return lib


def launch(plan: dict, S, mailbox, h_prev, k, eps: float, W1, b1, W2, b2,
           S_new, h, *, mean: bool, relu: bool) -> None:
    """Launch ``plan``'s route on the current stream, uncounted; raises on
    a CUDA error.  The operands are checked by the caller."""
    R, Din = S.shape
    err = _lib().mlp_apply_launch(
        S.data_ptr(), mailbox.data_ptr(), h_prev.data_ptr(), k.data_ptr(),
        W1.data_ptr(), b1.data_ptr(), W2.data_ptr(), b2.data_ptr(),
        S_new.data_ptr(), h.data_ptr(), R, Din, W1.shape[1], W2.shape[1],
        float(eps), int(mean), int(relu),
        int(plan["route"] == "resident"),
        plan.get("rows", 0), plan.get("tm1", 0), plan.get("tm2", 0),
        plan.get("ns", 0), plan.get("grid", 0),
        torch.cuda.current_stream(S.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_apply kernel launch failed ({plan}): CUDA "
                           f"error {err}")


def mlp_apply(S, mailbox, h_prev, k, eps: float, W1, b1, W2, b2, *,
              mean: bool = False, relu: bool = True):
    """Fused S' = S + M; h = act(relu(((1+eps) h_prev + norm(S', k)) @ W1
    + b1) @ W2 + b2).  ``eps`` is a host float.  Returns (S', h).

    ``mlp_apply.launches`` counts the kernel launches of this process,
    ``launches_by_route`` each route's and ``launches_by_shape`` those at
    each shape ``(R, Din, Dh, Dout)``.
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
    S_new = torch.empty_like(S)
    h = torch.empty((R, Dout), dtype=torch.float32, device=dev)
    index = dev.index or 0
    plan = kernel_plan(max(R, 1), Din, Dh, Dout, *device_limits(index))
    if not _resident.aligned(S, mailbox, h_prev, W1, b1, W2, b2, S_new, h):
        plan = {"route": "tiled"}
    if plan["route"] == "tiled":
        smem, limit = _lib().mlp_apply_smem_bytes(Din, Dh), \
            device_limits(index)[1]
        if smem > limit:
            raise ValueError(f"mlp_apply: the z and h1 row tiles need {smem} "
                             f"B of shared memory at Din={Din}, Dh={Dh}; a "
                             f"block of CUDA device {index} may opt in to "
                             f"{limit} B")
    if R == 0:
        return S_new, h
    with torch.cuda.device(dev):
        launch(plan, S, mailbox, h_prev, k, eps, W1, b1, W2, b2, S_new, h,
               mean=mean, relu=relu)
    mlp_apply.launches += 1
    mlp_apply.launches_by_route[plan["route"]] += 1
    by_shape = mlp_apply.launches_by_shape
    by_shape[(R, Din, Dh, Dout)] = by_shape.get((R, Din, Dh, Dout), 0) + 1
    return S_new, h


mlp_apply.launches = 0
mlp_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
mlp_apply.launches_by_shape = {}
