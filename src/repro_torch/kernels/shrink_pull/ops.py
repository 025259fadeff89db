"""Wrapper of the monotonic hop's SHRINK pull: the CUDA kernel
(``csrc/shrink_pull.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors.

The kernel re-derives every needed (row, dim) cell from the in-CSR in one
launch, with no compaction of the cells and no static lane bucket, so it
reads neither cap and drops nothing: its ``pull_total`` counts every
needed cell.  The caller's overflow rule (``need.sum() > pd_cap`` or
``pull_total > p_cap``) therefore flags the same attempts on both routes.
A failed build or launch raises; nothing runs the plain version in its
place."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import check_operand, cuda_device, on_cpu
from .ref import shrink_pull_ref


@functools.cache
def _launcher():
    fn = _build.load("shrink_pull").shrink_pull_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shrink_pull(need, aff_c, start, length, col, H_pre, pos_p, patch_val,
                C_pre_rows, *, sign: float, pd_cap: int, p_cap: int):
    """Re-derive the needed cells of a monotonic hop's recipients.

    ``need [R, d]`` bool marks the cells; ``aff_c [R]`` the recipients'
    vertex ids; ``start``, ``length`` ``[n]`` and ``col`` the in-CSR's
    slack pool (int64); ``H_pre [n + 1, d]`` fp32 the layer's rows, read
    through the patch (``pos_p [n + 1]`` int64, a vertex's slot in
    ``patch_val [P, d]`` or -1); ``C_pre_rows [R, d]`` int32 the
    recipients' witnesses; ``sign`` +1 (max) or -1 (min).  Returns ``(MK,
    RG, base_C, pull_total)``: MK equal to ``need`` (on a card ``need``
    itself), RG the re-derived extremum at needed cells and 0 elsewhere,
    base_C its witness (the largest source on a tie, -1 over no in-edge)
    at needed cells and ``C_pre_rows`` elsewhere, ``pull_total`` an int64
    device scalar, the needed cells' in-degrees summed.  ``pd_cap`` and
    ``p_cap`` bound the plain version's buckets only.
    ``shrink_pull.launches`` counts the kernel launches of this process.
    """
    operands = (need, aff_c, start, length, col, H_pre, pos_p, patch_val,
                C_pre_rows)
    if on_cpu(*operands):
        return shrink_pull_ref(*operands, sign=sign, pd_cap=pd_cap,
                               p_cap=p_cap)
    dev = cuda_device(need)
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, not {sign!r}")
    if need.dim() != 2 or H_pre.dim() != 2 or patch_val.dim() != 2:
        raise ValueError("need, H_pre and patch_val must be 2-D")
    (R, d), n = need.shape, H_pre.shape[0] - 1
    if max(n + 1, R) >= 2**31:
        raise ValueError(f"{n} vertices or {R} rows exceed the kernel's "
                         f"int32 ids")
    for name, t, shape, dtype in (
            ("need", need, (R, d), torch.bool),
            ("aff_c", aff_c, (R,), torch.int64),
            ("start", start, (n,), torch.int64),
            ("length", length, (n,), torch.int64),
            ("col", col, (col.shape[0],), torch.int64),
            ("H_pre", H_pre, (n + 1, d), torch.float32),
            ("pos_p", pos_p, (n + 1,), torch.int64),
            ("patch_val", patch_val, (patch_val.shape[0], d), torch.float32),
            ("C_pre_rows", C_pre_rows, (R, d), torch.int32)):
        check_operand(name, t, shape, dev, dtype)
    RG = torch.empty((R, d), dtype=torch.float32, device=dev)
    base_C = torch.empty((R, d), dtype=torch.int32, device=dev)
    pull_total = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(need.data_ptr(), aff_c.data_ptr(), start.data_ptr(),
                          length.data_ptr(), col.data_ptr(), H_pre.data_ptr(),
                          pos_p.data_ptr(), patch_val.data_ptr(),
                          C_pre_rows.data_ptr(), RG.data_ptr(),
                          base_C.data_ptr(), pull_total.data_ptr(), R, d,
                          int(sign), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"shrink_pull kernel launch failed: CUDA error "
                           f"{err}")
    shrink_pull.launches += 1
    return need, RG, base_C, pull_total


shrink_pull.launches = 0
