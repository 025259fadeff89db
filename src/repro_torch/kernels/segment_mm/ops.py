"""Wrapper of the message-passing SpMM: the CUDA kernel
(``csrc/segment_mm.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors.

The reference splits its SpMM into a host conversion of the edge list
(``coo_to_bsr``) and the product (``segment_mm``); so does this module:
:func:`coo_to_csr` builds a dst-major CSR once on the device, and
:func:`segment_mm_csr` runs the product over it as often as the caller
needs (the full pass runs one per layer over the same edges).  The BSR
tiling of the reference is a TPU layout choice and is not carried over.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import _build
from .._common import on_cpu
from .ref import segment_mm_ref

# a row with more in-edges than this is summed in spans of this many edges,
# one warp each, whose sums a second kernel adds in span order
SPAN_EDGES = 256


@dataclass(frozen=True)
class CSR:
    """A weighted edge list sorted by destination (stable, so each row
    keeps the edges' order), with the span tables of its long rows.

    ``rowptr [n+1]``, ``col [E]`` (source ids), ``row [E]`` (destination
    ids) and ``w [E]`` (fp32 weights) are int32/fp32 tensors on one
    device; ``n_src`` is one more than the largest source id.  The rows of
    more than :data:`SPAN_EDGES` edges are ``long_rows [n_long]``; long row
    ``j`` owns spans ``[span_ptr[j], span_ptr[j+1])`` and ``owner
    [n_spans]`` names each span's long row."""

    rowptr: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    w: torch.Tensor
    n: int
    n_src: int
    long_rows: torch.Tensor
    span_ptr: torch.Tensor
    owner: torch.Tensor

    @property
    def n_spans(self) -> int:
        return int(self.owner.shape[0])


def coo_to_csr(src, dst, w, n: int, device) -> CSR:
    """The dst-major CSR of the edges ``src[e] -> dst[e]`` with weights
    ``w[e]`` (arrays or tensors of one length) over ``n`` destination rows,
    built on ``device``: a stable sort by ``dst``, then ``bincount`` and
    ``cumsum`` for ``rowptr``.  Ids must lie in ``[0, n)`` for ``dst`` and
    be non-negative for ``src``; anything else raises."""
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
    counts = torch.bincount(dst, minlength=n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=rowptr[1:])
    long_rows = (counts > SPAN_EDGES).nonzero().flatten()
    per_row = (counts[long_rows] + SPAN_EDGES - 1) // SPAN_EDGES
    span_ptr = torch.zeros(long_rows.shape[0] + 1, dtype=torch.int64,
                           device=dev)
    torch.cumsum(per_row, 0, out=span_ptr[1:])
    owner = torch.repeat_interleave(
        torch.arange(long_rows.shape[0], device=dev), per_row)
    i32 = torch.int32
    return CSR(rowptr=rowptr.to(i32), col=src[order].to(i32),
               row=dst[order].to(i32), w=w[order].contiguous(), n=n,
               n_src=n_src, long_rows=long_rows.to(i32),
               span_ptr=span_ptr.to(i32), owner=owner.to(i32))


@functools.cache
def _launcher():
    fn = _build.load("segment_mm").segment_mm_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
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
    n_long, n_spans = int(csr.long_rows.shape[0]), csr.n_spans
    partial = torch.empty((n_spans, d), dtype=torch.float32, device=dev) \
        if n_spans else None
    with torch.cuda.device(dev):
        err = _launcher()(
            csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.w.data_ptr(),
            x.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            csr.long_rows.data_ptr(), csr.span_ptr.data_ptr(),
            csr.owner.data_ptr(), csr.n, n_x, d, n_long, n_spans, SPAN_EDGES,
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
