"""The readings a limit is set from: for each seed, the program's compared
numbers (a short window at the cell's own load and sizes) and the
control's, the plain reference in TF32 judged against the same reference
in fp32 on the same final graph.  One process for all seeds.  With
``--fault tf32`` the program runs its warm-up and window with TF32
products (the reference stays fp32): a fault confined to the rows the
stream reaches.

    python3 bench/tools/readings.py --workload <cell> --seconds 5 \
        --seeds 1 2 3 ... --out build/runs/<tag>.jsonl [--fault tf32]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    from bench.harness import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fault", choices=("tf32",))
    args = ap.parse_args()
    tamper = None
    if args.fault == "tf32":
        import torch

        def tamper(session):
            torch.backends.cuda.matmul.allow_tf32 = True
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        r = run_cell(args.workload, seed, args.seconds, False, control=True,
                     tamper=tamper)
        rec = dict(workload=args.workload, seed=seed, fault=args.fault,
                   correct=r["correct"],
                   program={k: v["value"] for k, v in r["checks"].items()},
                   control=r["control"], attempted=r["attempted"])
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
