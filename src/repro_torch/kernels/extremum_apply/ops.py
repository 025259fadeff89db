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

from .. import _build
from .._common import check_operand, cuda_device, on_cpu
from .ref import extremum_apply_ref

ROUTES = ("resident", "kchunk")


def kernel_plan(R: int, Din: int, Dout: int, masked: bool, n_sm: int,
                smem_limit: int) -> dict:
    """How the kernel takes ``R`` rows of ``Din`` -> ``Dout`` on a card of
    ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes of shared
    memory: ``{"route": "kchunk"}``, or the resident route's tiling
    (``teams`` of 4 warps a CTA, ``tm`` rows a thread, ``rows`` a tile,
    ``grid`` CTAs, ``smem`` bytes).

    The resident route computes h in passes of ``p`` columns (64 when Dout
    <= 64, else 128); a team's warps are ``4 // (p // 64)`` row blocks of
    ``4 tm`` rows by ``p // 64`` column blocks of 64 columns, so a tile has
    ``rows = 4 // (p // 64) * 4 * tm`` rows, at most 32 (a thread's 4 x 8
    tile at p = 128).  Where 32-row tiles would outnumber the SMs, two
    teams share each CTA's W, with the largest tiles that still give every
    team one.  Otherwise one team a CTA and the smallest tiles (8-32 rows)
    that leave no SM two of them.  A tiling whose shared memory (W, then a
    team's x and input stage; ``csrc/extremum_apply.cu`` ``Plan``) does
    not fit takes smaller tiles, then the K-chunked route."""
    if Din % 16 or Dout % 4:
        return {"route": "kchunk"}
    per_tm = 4 // ((64 if Dout <= 64 else 128) // 64) * 4   # rows a tm
    tms = [tm for tm in (4, 2, 1) if per_tm * tm <= 32]
    if -(-R // 32) > n_sm:   # the largest tiles that busy every team
        teams = 2
        first = next((tm for tm in tms
                      if -(-R // (per_tm * tm)) >= 2 * n_sm), tms[-1])
    else:   # the smallest tiles that leave no SM two of them
        teams = 1
        first = next(tm for tm in reversed(tms)
                     if -(-R // (per_tm * tm)) <= n_sm)
    cell = 13 if masked else 8   # bytes a staged cell takes
    for tm in tms[tms.index(first):]:
        rows = per_tm * tm
        smem = (4 * Din * Dout + teams * rows * Din * (4 + cell)
                + (teams + 1) * 8)
        if smem <= smem_limit:
            tiles = -(-R // rows)
            return dict(route="resident", teams=teams, tm=tm, rows=rows,
                        grid=min(-(-tiles // teams), n_sm), smem=smem)
    return {"route": "kchunk"}


@functools.cache
def _launcher():
    fn = _build.load("extremum_apply").extremum_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to, bytes) of CUDA device
    ``index``: the two numbers :func:`kernel_plan` tiles for."""
    query = _build.load("extremum_apply").extremum_apply_smem_optin
    query.argtypes = [ctypes.c_int]
    query.restype = ctypes.c_int
    smem = query(index)
    if smem < 0:
        raise RuntimeError(f"cannot read the shared memory limit of CUDA "
                           f"device {index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, \
        smem


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
    if any(t.data_ptr() % 16 for t in launched):
        # bulk copies and float4 accesses need 16-byte alignment
        plan = {"route": "kchunk"}
    with torch.cuda.device(dev):
        err = _launcher()(S.data_ptr(), mailbox.data_ptr(),
                          reagg.data_ptr() if masked else None,
                          mask.data_ptr() if masked else None,
                          W.data_ptr(), b.data_ptr(), S_new.data_ptr(),
                          h.data_ptr(), R, Din, Dout, int(maximize),
                          int(relu), plan.get("tm", 0),
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
