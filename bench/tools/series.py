"""Run one cell several times, each run a process of its own, and keep
every result line.

    python3 bench/tools/series.py --workload <cell> --seconds 30 \
        --trace 0 --seeds 11 12 13 --out build/runs/<tag>.jsonl

Prints one summary line a run: the seed, the exit code, the wall seconds,
``correct`` and each metric's value.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print("card:", card(), flush=True)
    for seed in args.seeds:
        cmd = [sys.executable, "bench/run.py", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=420)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        rec = dict(workload=args.workload, seed=seed, trace=args.trace,
                   seconds=args.seconds, rc=p.returncode, wall_s=wall,
                   result=res, stderr=p.stderr[-6000:])
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        summary = {k: v["value"] for k, v in (res or {}).get(
            "metrics", {}).items()}
        print(json.dumps(dict(seed=seed, rc=p.returncode,
                              wall_s=round(wall, 1),
                              correct=(res or {}).get("correct"),
                              checks={k: v["value"] for k, v in
                                      (res or {}).get("checks", {}).items()},
                              **summary)), flush=True)
        if res is None:
            print(p.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
