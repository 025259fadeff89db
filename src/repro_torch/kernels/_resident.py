"""Tiling of the resident hop-apply kernels (``csrc/resident_apply.cuh``):
``extremum_apply`` and ``delta_apply`` walk row tiles with W resident in
shared memory, and :func:`tiling` says how, from the shape and the card's
limits (:func:`device_limits`).  Nothing here needs a card, so the CPU
tests check every plan."""
from __future__ import annotations

import functools

import torch


def round16(n: int) -> int:
    return -(-n // 16) * 16


def tiling(R: int, Din: int, Dout: int, *, cell_bytes: int, row_bytes: int,
           tilings: list[tuple[int, int]], n_sm: int,
           smem_limit: int) -> dict | None:
    """The resident kernel's tiling of ``R`` rows of ``Din`` -> ``Dout``
    on ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes of
    shared memory, or None where the resident kernel cannot take it.

    ``tilings`` lists the candidate (rows a tile, rows a thread) pairs from
    the largest tile (32 rows) to the smallest; a staged cell takes
    ``cell_bytes`` and a tile's row ``row_bytes`` (``Plan`` in
    ``resident_apply.cuh``: W, then per team x, the stage and the row
    values, then the mbarriers).  Where 32-row tiles would outnumber the
    SMs, two teams share each CTA's W, with the largest tiles that still
    give every team one.  Otherwise one team a CTA and the smallest tiles
    that leave no SM two of them.  A tiling whose shared memory does not
    fit takes smaller tiles; None when none fits, or when Din is not a
    multiple of 16 or Dout of 4."""
    if Din % 16 or Dout % 4:
        return None
    sizes = [rows for rows, _ in tilings]
    if -(-R // 32) > n_sm:   # the largest tiles that busy every team
        teams = 2
        first = next((i for i, rows in enumerate(sizes)
                      if -(-R // rows) >= 2 * n_sm), len(sizes) - 1)
    else:   # the smallest tiles that leave no SM two of them
        teams = 1
        first = next(i for i in reversed(range(len(sizes)))
                     if -(-R // sizes[i]) <= n_sm)
    for rows, tm in tilings[first:]:
        smem = (4 * Din * Dout
                + teams * (rows * Din * (4 + cell_bytes)
                           + round16(rows * row_bytes))
                + (teams + 1) * 8)
        if smem <= smem_limit:
            tiles = -(-R // rows)
            return dict(route="resident", teams=teams, tm=tm, rows=rows,
                        grid=min(-(-tiles // teams), n_sm), smem=smem)
    return None


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to, bytes) of CUDA device
    ``index``: the two numbers the resident kernels tile for."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def aligned(*tensors: torch.Tensor) -> bool:
    """True when every operand starts on a 16-byte boundary, as bulk
    copies and float4 accesses need."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
