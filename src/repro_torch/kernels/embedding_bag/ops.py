"""Wrapper of the sum-mode bag: the CUDA kernel (``csrc/embedding_bag.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import cuda_device, on_cpu
from .ref import embedding_bag_ref


@functools.cache
def _launcher():
    fn = _build.load("embedding_bag").embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lanes_per_block() -> int:
    return int(_build.load("embedding_bag").embedding_bag_lanes_per_block())


def embedding_bag(table, idx, padding_idx: int | None = None):
    """``out[b] = sum_h table[idx[b, h]]`` for ``idx [B, hot]`` int32 and
    ``table [V, d]`` fp32 or bf16; returns ``[B, d]`` in the table's dtype
    (a bf16 table is summed in fp32 and rounded once).  Lanes equal to
    ``padding_idx`` skip the row read and add nothing.  An index outside
    ``[0, V)`` is never clamped: on the CPU it raises, on a card the kernel
    traps, which surfaces at the next synchronisation.
    ``embedding_bag.launches`` counts the kernel launches of this process.
    """
    if on_cpu(table, idx):
        return embedding_bag_ref(table, idx, padding_idx)
    dev = cuda_device(table)
    for name, t in (("table", table), ("idx", idx)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx is {idx.dtype}, expected torch.int32")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table is {table.dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    (V, d), (B, hot) = table.shape, idx.shape
    if padding_idx is not None and not 0 <= padding_idx < V:
        raise ValueError(f"padding_idx {padding_idx} outside [0, {V})")
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    if B == 0 or d == 0:
        return out
    # a bag is summed in spans of lanes, one block each; the spans' sums
    # meet in an fp32 scratch that a second kernel adds up in order
    spans = -(-hot // _lanes_per_block()) if hot else 1
    if max(V, hot) >= 2**31 or B * spans * -(-d // 128) >= 2**31:
        raise ValueError(f"idx {tuple(idx.shape)} with table "
                         f"{tuple(table.shape)} exceeds the kernel's int32 "
                         f"extents and grid")
    partial = torch.empty((B * spans, d), dtype=torch.float32, device=dev) \
        if spans > 1 else None
    with torch.cuda.device(dev):
        err = _launcher()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          None if partial is None else partial.data_ptr(),
                          V, d, B, hot,
                          -1 if padding_idx is None else padding_idx,
                          int(table.dtype == torch.bfloat16),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{err}")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
