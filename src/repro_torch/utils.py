"""Shared small utilities: padding, bucketing, device selection, and the
dry-run's human-readable sizes."""
from __future__ import annotations

import math

import numpy as np
import torch


def next_bucket(n: int, *, minimum: int = 16) -> int:
    """Round ``n`` up to the next power of two (>= minimum).

    Bucketed capacities keep the device engine's buffer shapes on a small
    ladder, so a batch's cap schedule changes O(log n) times at most.
    """
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``arr`` with ``fill`` up to ``size`` entries."""
    if arr.shape[0] == size:
        return arr
    if arr.shape[0] > size:
        raise ValueError(f"cannot pad {arr.shape[0]} down to {size}")
    pad_width = [(0, size - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA request without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000.0:
            return f"{n:.3g}{unit}"
        n /= 1000.0
    return f"{n:.3g}E"


def is_dtensor(x) -> bool:
    """``x`` is a ``DTensor`` (a dry-run cell's argument, or made from one)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_block(mesh, dims: list) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) of a tensor dim
    sharded over the mesh dims ``dims`` of ``mesh``, outermost first."""
    coord = mesh.get_coordinate()
    block, n = 0, 1
    for i in dims:
        block = block * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return block, n
