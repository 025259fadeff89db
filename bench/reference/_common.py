"""Pieces both plain forward passes share: the fp32 / TF32 matrix product
and an edge-chunked segment reduction.

A segment sum over a hub's in-edges adds about 10^5 fp32 terms; summed in
fp32 its rounding alone reaches a few 1e-4 of the row, more than the
program's own (whose first moment is summed in spans).  So the reference
accumulates sums in float64 and rounds each once to fp32: its aggregates
are the correctly rounded fp32 values, and only the layers' products run
in the model's precision."""
from __future__ import annotations

import contextlib

import torch

EDGE_CHUNK = 1 << 20   # edges gathered at once: bounds the gather's memory


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores round their fp32 inputs."""
    bits = t.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _matmul_tf32(on: bool):
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = on
    try:
        yield
    finally:
        flags.allow_tf32 = old


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` in fp32, or in TF32 for the control: on a card through the
    tensor cores, on the CPU by rounding both operands as they would."""
    if tf32 and a.device.type == "cpu":
        return tf32_round(a) @ tf32_round(b)
    with _matmul_tf32(tf32):
        return a @ b


def segment_reduce(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n: int, op: str) -> torch.Tensor:
    """Per vertex, the ``op`` ("sum", "sum_sq" or "amax") over its
    in-edges of ``h[src]``: zeros for the sums, -inf for an empty max.
    Sums accumulate in float64 and are returned in float64."""
    if op == "amax":
        out = torch.full((n, h.shape[1]), float("-inf"), dtype=h.dtype,
                         device=h.device)
    else:
        out = torch.zeros((n, h.shape[1]), dtype=torch.float64,
                          device=h.device)
    for lo in range(0, src.shape[0], EDGE_CHUNK):
        s, d = src[lo:lo + EDGE_CHUNK], dst[lo:lo + EDGE_CHUNK]
        if op == "amax":
            vals = h[s]
            out.scatter_reduce_(0, d[:, None].expand_as(vals), vals, "amax")
        else:
            vals = h[s].double()
            out.index_add_(0, d, vals * vals if op == "sum_sq" else vals)
    return out
