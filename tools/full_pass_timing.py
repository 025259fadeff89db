"""Times the port's full pass at the arxiv scale of ``chip_smoke.py``'s
sessions (gc-s: 169,343 vertices, 1,049,499 edges, 3 layers x 128) on one
CUDA card: the CSR it builds (``coo_to_csr``: upload, sort and the
kernel's work items) and the whole pass (``full_inference``: the CSR, then
``segment_mm`` and the layer once per layer), each on the host clock
between two synchronisations, in turns, after a warm-up; and the
``segment_mm`` kernel alone over that CSR at d = 128 and 40 (fp32), by
``chip_smoke.device_ms``.

It imports ``repro_torch`` from ``--src``, so one call can compare two
trees, the older unpacked into a gitignored directory (``git archive``):

    python3 tools/full_pass_timing.py --src build/parent/src --label parent
    python3 tools/full_pass_timing.py --src src --label change

Prints one JSON line: the label, the card's name and power limit, and
each time's median and samples in ms.  Exits non-zero without a card.
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


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("full_pass_timing: no CUDA device is available")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference
    from repro_torch.kernels.segment_mm import coo_to_csr, segment_mm_csr

    session = InferenceSession.build(SessionConfig(
        workload="gc-s", engine="full", graph="powerlaw", holdout_frac=0.1,
        seed=0, device="cuda", **chip_smoke.ARXIV))
    src, dst, w = session.graph.coo()
    x = torch.as_tensor(session.sync().H[0], device="cuda")
    n = chip_smoke.ARXIV["n"]

    def csr():
        coo_to_csr(src, dst, w, n, "cuda")

    def full():
        full_inference(session.workload, session.params, x, src, dst, w,
                       session.graph.in_degree)

    times = {"csr_ms": [], "full_pass_ms": []}
    for i in range(args.iters + 2):
        for key, fn in (("csr_ms", csr), ("full_pass_ms", full)):
            t = host_ms(fn)
            if i >= 2:
                times[key].append(t)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(label=args.label, src=args.src, card=card, n=n,
               edges=len(src))
    for key, ts in times.items():
        out[key] = statistics.median(ts)
        out[key + "_samples"] = ts
    built = coo_to_csr(src, dst, w, n, "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for d in (128, 40):
        xd = torch.randn((n, d), generator=g, device="cuda")
        out[f"segment_mm_ms_d{d}"] = chip_smoke.device_ms(
            lambda: segment_mm_csr(built, xd))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
