"""Times the monotonic hop's SHRINK pull at the shapes the benchmark's
``gsmax-arxiv.uniform-b100`` cell gives it, on one CUDA card.

It runs the cell for a short window (``bench/harness.py::run_cell``) with
the engine's ``shrink_pull`` wrapped to keep the operands of the last
batch's hops, then on each hop's operands: checks the kernel against its
plain version on the card's tensors (the chain of torch ops the kernel
replaced, at the engine's caps: MK, the witnesses and the pulled count
equal, RG bit-equal with -0.0 equal to 0.0); times both on the device
(``chip_smoke.device_ms``, the median of 25 calls, inputs warm in L2 where
they fit) and the host's enqueue of one call (the host clock from a
synchronised start to the call's return, median of 25); and gives the
least time the card could take, ``chip_smoke.shrink_pull_bytes`` over
3.35 TB/s.

    python3 tools/shrink_pull_timing.py [--seed N] [--seconds S]

Prints one JSON line: the card's name and power limit and one entry a
hop.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CELL = "gsmax-arxiv.uniform-b100"


def enqueue_ms(fn, iters: int = 25) -> float:
    """Median host ms from a synchronised start to ``fn``'s return."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3305550001)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("shrink_pull_timing: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from bench import harness
    from repro_torch.kernels.shrink_pull import shrink_pull
    from repro_torch.kernels.shrink_pull.ref import shrink_pull_ref

    with chip_smoke.kept_shrink_pulls(3) as calls:
        line = harness.run_cell(CELL, args.seed, args.seconds, False)
    if not line["correct"] or len(calls) < 3:
        sys.exit(f"shrink_pull_timing: the cell's run failed or pulled "
                 f"fewer than 3 hops ({len(calls)})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    hops = []
    for hop, (a, kw) in enumerate(calls):
        got = shrink_pull(*a, **kw)
        chip_smoke.hold_shrink_pull(got, shrink_pull_ref(*a, **kw),
                                    f"hop {hop}")
        need = a[0]
        nbytes = chip_smoke.shrink_pull_bytes(a)
        kernel_ms = chip_smoke.device_ms(lambda: shrink_pull(*a, **kw))
        hops.append(dict(
            hop=hop, R=need.shape[0], d=need.shape[1],
            cells=int(need.sum()), needy_rows=int(need.any(dim=1).sum()),
            pulled_lanes=int(got[3]),
            caps={k: kw[k] for k in ("pd_cap", "p_cap")},
            bound_bytes=nbytes,
            bound_ms=nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3,
            kernel_ms=kernel_ms,
            plain_ms=chip_smoke.device_ms(lambda: shrink_pull_ref(*a, **kw)),
            kernel_enqueue_ms=enqueue_ms(lambda: shrink_pull(*a, **kw)),
            plain_enqueue_ms=enqueue_ms(
                lambda: shrink_pull_ref(*a, **kw))))
        hops[-1]["roofline_pct"] = 100 * hops[-1]["bound_ms"] / kernel_ms
    print(json.dumps(dict(card=card, cell=CELL, seed=args.seed,
                          window_correct=line["correct"], hops=hops)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
