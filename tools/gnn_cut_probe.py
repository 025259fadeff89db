"""Measures the peak device memory of one GNN train step at the
``ogb_products`` cell for a ladder of cuts, to size the cut that
``chip_smoke.py`` phase 9 runs.

    python tools/gnn_cut_probe.py [arch[@cell]:cut,cut,...] ...

Default ladders (n and m divided together; the cell's d, classes, widths,
depth, average in-degree and triplet formula kept):
schnet 8,4,2; pna 16,8,4; nequip 256,128,64; dimenet 4096,2048,1024.
For each arch the cuts run from the largest to the smallest and stop at
the first step that runs out of memory.  Each step: build the cell
(``configs/<arch>.py::cells()["ogb_products"]``), reset the peak, one
AdamW step, ``max_memory_allocated``.  Prints one JSON line per cut with
the card's name and power limit.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

LADDERS = {"schnet": (8, 4, 2), "pna": (16, 8, 4), "nequip": (256, 128, 64),
           "dimenet": (4096, 2048, 1024)}


def probe(arch: str, cell: str, cut: int, card: str) -> bool:
    """One step at ``cut``; prints its line, returns False on OOM."""
    from repro_torch.configs import get_arch
    row = dict(arch=arch, cell=cell, cut=cut, card=card)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        built = get_arch(arch).cells()[cell]("cuda", seed=0, cut=cut)
        torch.cuda.synchronize()
        row["build_s"] = time.perf_counter() - t0
        row.update({k: built.sizes[k] for k in ("n", "m", "t", "t_real")})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, loss = built.step(*built.args)
        torch.cuda.synchronize()
        row.update(step_ms=(time.perf_counter() - t0) * 1e3,
                   loss=float(loss),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        ok = True
    except torch.cuda.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0][:200]
        ok = False
    print(json.dumps(row), flush=True)
    return ok


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        sys.exit("gnn_cut_probe: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    ladders = {spec.split(":")[0]: tuple(int(c) for c in
                                         spec.split(":")[1].split(","))
               for spec in argv} or LADDERS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for key, cuts in ladders.items():
        arch, _, cell = key.partition("@")
        for cut in cuts:
            if not probe(arch, cell or "ogb_products", cut, card):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
