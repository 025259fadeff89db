"""Runs the port's dry-run over every cell on both production meshes (the
45 cells of ``--arch all`` and ``--arch extra`` with ``--mesh both``), one
``python -m repro_torch.launch.dryrun`` process per (arch, mesh), several
at a time, and writes their records to one JSONL.

    python tools/dryrun_all.py [--device cuda] [--jobs 8] [--out DIR]

DIR defaults to ``build/dryrun``.
Each process's records go to ``DIR/<arch>_<mesh>.jsonl`` and its output to
``DIR/<arch>_<mesh>.log``; ``DIR/dryrun.jsonl`` holds them all (in
registry order, single mesh first).  Then it prints
``benchmarks/roofline_report.py``'s tables of that file, a Markdown table
of every record (FLOPs, bytes, collective bytes and peak per chip, the
dominant term and the trace's seconds), and the card's name and power
limit as ``nvidia-smi`` gives them.  Exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MESHES = ("single", "multi")


def run_one(arch: str, mesh: str, device: str, out: Path) -> tuple:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = out / f"{arch}_{mesh}.jsonl"
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--mesh", mesh, "--device", device, "--out", str(path)],
        cwd=ROOT, env=env, capture_output=True, text=True)
    (out / f"{arch}_{mesh}.log").write_text(proc.stdout + proc.stderr)
    return arch, mesh, proc.returncode, time.perf_counter() - t0, proc.stdout


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import ARCHS
    from repro_torch.utils import human_count

    def human(n: float, unit: str) -> str:
        return f"{human_count(n)}{unit}"
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # the longest traces first (deepseek-v3's 61 layers; its opt variant's
    # train step runs 8 microbatches)
    first = ("deepseek-v3-opt", "deepseek-v3-671b")
    jobs = [(a, m) for a in first for m in MESHES] + \
        [(a, m) for a in ARCHS for m in MESHES if a not in first]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda j: run_one(*j, args.device, out), jobs))
    failed = []
    for arch, mesh, rc, secs, stdout in done:
        print(f"{arch} {mesh}: exit {rc}, {secs:.1f} s", flush=True)
        for line in stdout.splitlines():
            if line.startswith(("[OK]", "[FAIL]")):
                print("  " + line)
        if rc != 0:
            failed.append(f"{arch}/{mesh}")
    records = []
    for arch, mesh in [(a, m) for m in MESHES for a in ARCHS]:
        path = out / f"{arch}_{mesh}.jsonl"
        if path.exists():
            records += [json.loads(x) for x in path.read_text().splitlines()]
    allpath = out / "dryrun.jsonl"
    allpath.write_text("".join(json.dumps(r) + "\n" for r in records))
    report = subprocess.run(
        [sys.executable, "-m", "benchmarks.roofline_report", str(allpath)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True)
    print(report.stdout)
    print("| cell | mesh | FLOPs/chip | bytes/chip | collective B/chip | "
          "peak B/chip | dominant | trace s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in records:
        print(f"| {r['cell']} | {r['mesh']} | "
              f"{human(r['flops_per_chip'], 'FLOP')} | "
              f"{human(r['bytes_per_chip'], 'B')} | "
              f"{human(r['collective_bytes_per_chip'], 'B')} | "
              f"{human(r['mem_per_device']['peak_bytes'], 'B')} | "
              f"{r['dominant']} | {r['compile_s']} |")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True) if args.device == "cuda" else None
    print(f"card: {card.stdout.strip() if card else 'none (cpu)'}")
    print(f"records: {len(records)}; failed: {failed}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
