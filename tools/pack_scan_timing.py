"""Times the distributed engine's bucket packing on a card, with its
per-bucket scans against the JAX package's one-hot scan.

    python tools/pack_scan_timing.py

``core/distributed.py::_pack_buckets`` gives each message its slot in
its destination's buffer by one 1-D cumulative sum per bucket.  The JAX
package takes a cumulative sum down a one-hot ``[N, n_buckets + 1]``
matrix instead (``src/repro/core/distributed.py:145``); in torch on a
card that is an outer-dimension scan.  Both are timed here (median of 25
calls after warm-up, CUDA events) at the main path's message counts:
phase 6's gc-s halo (~8.7 K), ``dist-rc``'s pull (~0.78 M) and gs-max's
per-dim pull (~10.2 M), with 1 and 4 buckets; both must give the same
buffers.  Prints one JSON line per shape with the card's name and power
limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def one_hot_pack(n_buckets, cap, bucket, key, key_sentinel, vals):
    """The JAX package's ``_pack_buckets`` formulation, in torch."""
    from repro_torch.core.distributed import _scatter_buckets
    oh = bucket[:, None] == torch.arange(n_buckets + 1, device=bucket.device)
    run = torch.cumsum(oh.to(torch.int64), 0)
    pos = run.gather(1, bucket[:, None]).squeeze(1) - 1
    counts = run[-1, :n_buckets]
    keys, buf = _scatter_buckets(n_buckets, cap, bucket, pos, key,
                                 key_sentinel, vals)
    return keys, buf, counts, (counts > cap).any()


def ms(fn, iters: int = 25) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pack_scan_timing: no CUDA device")
    from repro_torch.core.distributed import _pack_buckets
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n, width in (("gc-s halo", 8_704, 129),
                            ("dist-rc pull", 776_713, 1),
                            ("gs-max pull", 10_188_332, 2)):
        for n_buckets in (1, 4):
            bucket = torch.randint(0, n_buckets + 1, (n,), device="cuda",
                                   generator=gen)
            key = torch.randint(0, 1 << 20, (n,), device="cuda",
                                generator=gen)
            vals = torch.rand((n, width), device="cuda", generator=gen)
            cap = n
            got = _pack_buckets(n_buckets, cap, bucket, key, 1 << 20, vals)
            ref = one_hot_pack(n_buckets, cap, bucket, key, 1 << 20, vals)
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            if not same:
                raise AssertionError(f"{label}: the two packs differ")
            print(json.dumps(dict(
                card=card, shape=label, messages=n, buckets=n_buckets,
                width=width, per_bucket_ms=ms(lambda: _pack_buckets(
                    n_buckets, cap, bucket, key, 1 << 20, vals)),
                one_hot_ms=ms(lambda: one_hot_pack(
                    n_buckets, cap, bucket, key, 1 << 20, vals)),
                equal=same)), flush=True)


if __name__ == "__main__":
    main()
