"""Wrapper of the message-passing SpMM: the CUDA kernel
(``csrc/segment_mm.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors.

The reference splits its SpMM into a host conversion of the edge list
(``coo_to_bsr``) and the product (``segment_mm``); so does this module:
:func:`coo_to_csr` builds a dst-major CSR once, with the kernel's work
items on a CUDA device (:func:`partition`), and :func:`segment_mm_csr` runs the product over
it as often as the caller needs (the full pass runs one per layer over the
same edges).  The BSR tiling of the reference is a TPU layout choice and
is not carried over.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import _build
from .._common import on_cpu
from .ref import partition_ref, segment_mm_ref

# the most edges, and the most rows, of one work item of the kernel
EDGE_BUDGET = 128


def partition(rowptr, budget: int = EDGE_BUDGET):
    """The kernel's work items over the rows of a CSR whose row ``r`` has
    edges ``[rowptr[r], rowptr[r+1])`` (``rowptr [n+1]``, a tensor or
    array; the result lies on its device), longest first:
    ``(items [I, 4], long_rows [n_long], chunk_ptr [n_long + 1], n_chunks)``,
    int32 tensors and an int.

    A row of more than ``budget`` edges is cut into chunks of ``budget``
    edges (the last one shorter), an item each.  The other rows go in runs
    of whole consecutive rows: a run's edges all lie in one window
    ``[k budget, (k + 1) budget)`` of the edge list, and it does not cross
    a multiple of ``budget`` in row index, so it has at most ``budget``
    rows (rows without edges included); a row that crosses a window's end
    is a run of its own.  So no item has more than ``budget`` edges.
    ``items[i] = (first row, end, first edge, end edge)``, where ``end`` is
    the run's end row, or ``~slot`` (negative) for a chunk, whose sum goes
    to scratch row ``slot``.  Ties in length keep row order.  The chunked
    rows are ``long_rows``; row ``long_rows[j]``'s chunks are slots
    ``[chunk_ptr[j], chunk_ptr[j+1])``, in edge order, and are added in
    that order; ``n_chunks`` counts the slots.

    On a CUDA device two kernels of ``csrc/segment_mm.cu`` decide and
    write the items, around two ``cumsum`` calls, one readback of the
    sizes and the sort by length (``partition.launches`` counts these
    calls); on the CPU the plain version (``ref.partition_ref``) runs."""
    if budget < 1:
        raise ValueError(f"budget must be positive, not {budget}")
    rowptr = torch.as_tensor(rowptr)
    if on_cpu(rowptr):
        return partition_ref(rowptr, budget)
    if rowptr.dim() != 1 or rowptr.shape[0] < 1:
        raise ValueError(f"rowptr must be 1-D with n + 1 >= 1 entries; got "
                         f"shape {tuple(rowptr.shape)}")
    dev, n = rowptr.device, rowptr.shape[0] - 1
    rp = rowptr.to(torch.int32).contiguous()
    is_new = torch.empty(n, dtype=torch.uint8, device=dev)
    opened = torch.empty(n, dtype=torch.int64, device=dev)
    is_long = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _partition_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segment_mm_partition_flags(
            rp.data_ptr(), n, budget, is_new.data_ptr(), opened.data_ptr(),
            is_long.data_ptr(), stream)
        if err:
            raise RuntimeError(f"segment_mm partition launch failed: CUDA "
                               f"error {err}")
        # opened packs a row's items (low 32 bits) and chunks (high 32)
        opened = torch.cumsum(opened, 0)
        n_long_before = torch.cumsum(is_long, 0)
        n_items = n_chunks = n_long = 0
        if n:
            total, n_long = torch.stack([opened[-1],
                                         n_long_before[-1]]).tolist()
            n_items, n_chunks = total & 0xFFFFFFFF, total >> 32
        items = torch.empty((n_items, 4), dtype=torch.int32, device=dev)
        key = torch.empty(n_items, dtype=torch.int32, device=dev)
        long_rows = torch.empty(n_long, dtype=torch.int32, device=dev)
        chunk_ptr = torch.full((n_long + 1,), n_chunks, dtype=torch.int32,
                               device=dev)
        err = lib.segment_mm_partition_emit(
            rp.data_ptr(), n, budget, is_new.data_ptr(), opened.data_ptr(),
            n_long_before.data_ptr(), items.data_ptr(), key.data_ptr(),
            long_rows.data_ptr(), chunk_ptr.data_ptr(), stream)
        if err:
            raise RuntimeError(f"segment_mm partition launch failed: CUDA "
                               f"error {err}")
    partition.launches += 1
    return (items[torch.argsort(key, stable=True)], long_rows, chunk_ptr,
            n_chunks)


partition.launches = 0


@dataclass(frozen=True)
class CSR:
    """A weighted edge list sorted by destination (stable, so each row
    keeps the edges' order), with the kernel's work items.

    ``rowptr [n+1]``, ``col [E]`` (source ids), ``row [E]`` (destination
    ids) and ``w [E]`` (fp32 weights) are int32/fp32 tensors on one
    device; ``n_src`` is one more than the largest source id.  On a CUDA
    device ``items``, ``long_rows``, ``chunk_ptr`` and ``n_chunks`` are
    :func:`partition`'s, at :data:`EDGE_BUDGET`; on the CPU, whose plain
    version reads none of them, they are ``None`` and 0."""

    rowptr: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    w: torch.Tensor
    n: int
    n_src: int
    items: torch.Tensor | None
    long_rows: torch.Tensor | None
    chunk_ptr: torch.Tensor | None
    n_chunks: int


def coo_to_csr(src, dst, w, n: int, device) -> CSR:
    """The dst-major CSR of the edges ``src[e] -> dst[e]`` with weights
    ``w[e]`` (arrays or tensors of one length) over ``n`` destination rows,
    built on ``device``: a stable sort by ``dst``, ``searchsorted`` of the
    sorted ids for ``rowptr`` and, on a CUDA device, the work items of
    :func:`partition`.  Ids must lie in ``[0, n)`` for ``dst`` and be
    non-negative for ``src``; anything else raises."""
    dev = torch.device(device)
    src = torch.as_tensor(src, device=dev).long()
    dst = torch.as_tensor(dst, device=dev).long()
    w = torch.as_tensor(w, device=dev).float()
    if src.dim() != 1 or src.shape != dst.shape or src.shape != w.shape:
        raise ValueError(f"src, dst and w must be 1-D of one length; got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(w.shape)}")
    E = src.shape[0]
    if n < 0 or max(n, E) >= 2**31:
        raise ValueError(f"{E} edges over {n} rows exceed the kernel's int32 "
                         f"extents")
    n_src = 0
    if E:
        lo_d, hi_d, lo_s, hi_s = torch.stack(
            [dst.min(), dst.max(), src.min(), src.max()]).tolist()
        if lo_d < 0 or hi_d >= n:
            raise ValueError(f"dst ids span [{lo_d}, {hi_d}], outside "
                             f"[0, {n})")
        if lo_s < 0 or hi_s >= 2**31 - 1:
            raise ValueError(f"src ids span [{lo_s}, {hi_s}], outside "
                             f"[0, 2^31 - 1)")
        n_src = hi_s + 1
    order = torch.argsort(dst, stable=True)
    row = dst[order]
    # (bincount would read the ids' extremes back twice on a CUDA device)
    i32 = torch.int32
    rowptr = torch.searchsorted(row, torch.arange(n + 1, device=dev),
                                out_int32=True)
    items = long_rows = chunk_ptr = None
    n_chunks = 0
    if dev.type == "cuda":
        items, long_rows, chunk_ptr, n_chunks = partition(rowptr)
    return CSR(rowptr=rowptr, col=src[order].to(i32),
               row=row.to(i32), w=w[order].contiguous(), n=n, n_src=n_src,
               items=items, long_rows=long_rows, chunk_ptr=chunk_ptr,
               n_chunks=n_chunks)


@functools.cache
def _partition_lib():
    lib = _build.load("segment_mm")
    ptr = ctypes.c_void_p
    lib.segment_mm_partition_flags.argtypes = [ptr, ctypes.c_int,
                                               ctypes.c_int] + [ptr] * 4
    lib.segment_mm_partition_emit.argtypes = [ptr, ctypes.c_int,
                                              ctypes.c_int] + [ptr] * 8
    lib.segment_mm_partition_flags.restype = ctypes.c_int
    lib.segment_mm_partition_emit.restype = ctypes.c_int
    return lib


@functools.cache
def _launcher():
    fn = _build.load("segment_mm").segment_mm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_mm_csr(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum_{e in row v} w[e] * x[col[e]]`` for ``x [n_x, d]``
    fp32 or bf16 on the CSR's device; returns ``[n, d]`` in x's dtype,
    summed in fp32 in a fixed order (no atomics: the same result in every
    run).  ``segment_mm.launches`` counts the kernel launches of this
    process."""
    if on_cpu(x, csr.col):
        return segment_mm_ref(csr.col, csr.row, csr.w, x, csr.n)
    dev = csr.col.device
    if dev.type != "cuda" or x.device != dev:
        raise ValueError(f"x is on {x.device} and the CSR on {dev}: both "
                         f"must lie on the CPU or on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {x.dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be 2-D and contiguous; got shape "
                         f"{tuple(x.shape)}")
    n_x, d = x.shape
    if n_x < csr.n_src:
        raise ValueError(f"x has {n_x} rows, the edges read row "
                         f"{csr.n_src - 1}")
    out = torch.empty((csr.n, d), dtype=x.dtype, device=dev)
    if csr.n == 0 or d == 0:
        return out
    partial = torch.empty((csr.n_chunks, d), dtype=torch.float32,
                          device=dev) if csr.n_chunks else None
    # 16-byte loads where every row starts on a 16-byte boundary
    vec = (d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = _launcher()(
            csr.items.data_ptr(), csr.items.shape[0], csr.col.data_ptr(),
            csr.w.data_ptr(), csr.row.data_ptr(), x.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            csr.long_rows.data_ptr(), csr.chunk_ptr.data_ptr(),
            csr.long_rows.shape[0], csr.n_chunks, n_x, d, int(vec),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment_mm kernel launch failed: CUDA error "
                           f"{err}")
    segment_mm.launches += 1
    return out


def segment_mm(src, dst, w, x: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's contract: ``out[v] = sum_{(u, v)} w_uv * x[u]`` over
    the edges ``src -> dst`` with weights ``w``, ``[n, d]`` in x's dtype,
    on x's device.  Builds the CSR and runs :func:`segment_mm_csr`; a
    caller that runs several products over one edge list builds the CSR
    once instead."""
    return segment_mm_csr(coo_to_csr(src, dst, w, n, x.device), x)


segment_mm.launches = 0
