"""Streaming-inference CLI: the serving loop for RIPPLE on one device.

A thin CLI over ``repro_torch.api.InferenceSession``: graph snapshot ->
bootstrap -> journaled update batches -> incremental engine -> latency
report, with checkpoints (``--ckpt-dir``, ``--ckpt-every``) and
deadline-driven micro-batching.  Engine selection goes through the
registry.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.stream --engine device \
        --workload gc-s --n 2000 --updates 3000 --batch-size 100

``--engine`` takes ripple, rc, vertexwise, device, full, dist and dist-rc;
``--workload`` takes the five invertible workloads, the monotonic
``gs-max`` / ``gc-min`` and the bounded ``ga-s`` / ``gp-m``;
``--tolerance`` (bounded workloads on ripple and device) turns on the
certified approximate mode.

The distributed engines run on one rank unless launched by ``torchrun``,
which starts one process per card; each joins the environment's process
group (NCCL on ``cuda``, gloo on ``cpu``) and the vertex partition spans
all ranks (``data`` = world size, ``model`` = 1)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.stream --engine dist \
        --workload gc-s --n 169343 --m 1166243 --updates 3000
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.api import InferenceSession, SessionConfig, engine_names
from repro_torch.core.workloads import WORKLOAD_NAMES


def join_ranks(device: str) -> bool:
    """Under ``torchrun`` (``RANK`` in the environment): one card per
    rank, and the environment's process group.  Returns whether this
    process reports (rank 0, or no launcher)."""
    if "RANK" in os.environ and not dist.is_initialized():
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo")
    return not dist.is_initialized() or dist.get_rank() == 0


def build(args) -> InferenceSession:
    return InferenceSession.build(SessionConfig(
        workload=args.workload, engine=args.engine, graph=args.graph,
        n=args.n, m=args.m, n_layers=args.layers, d_in=args.d_in,
        d_hidden=args.d_hidden, n_classes=args.classes,
        deadline_ms=args.deadline_ms, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, device=args.device,
        engine_options={"tolerance": args.tolerance} if args.tolerance
        else {}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="gc-s", choices=WORKLOAD_NAMES)
    ap.add_argument("--engine", choices=engine_names(), default="device")
    ap.add_argument("--graph", choices=["er", "powerlaw"], default="powerlaw")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=8000)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-in", type=int, default=32)
    ap.add_argument("--d-hidden", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--updates", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="straggler mitigation: split batches that exceed "
                         "this latency budget (0 = off)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="bounded workloads: certified approximate mode, "
                         "published error <= this (0 = exact)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no card is present")
    args = ap.parse_args(argv)

    reports = join_ranks(args.device)
    session = build(args)
    stream = session.make_stream(args.updates, seed=1)
    report = session.ingest(stream, batch_size=args.batch_size,
                            keep_results=bool(args.tolerance))
    if not reports:
        return
    print(f"engine={session.engine_name} workload={args.workload} "
          f"device={session.device} updates={report.n_updates} "
          f"throughput={report.throughput:.1f} up/s "
          f"median_latency={report.median_latency_ms:.2f}ms "
          f"p99={report.p99_latency_ms:.2f}ms "
          f"final_batch_size={report.final_batch_size}")
    if args.tolerance:
        bound = session.engine.error_bound()
        deferred = sum(r.deferred_rows for r in report.results)
        print(f"tolerance={args.tolerance} deferred_rows={deferred} "
              f"error_bound={float(bound.max()) if bound.size else 0.0:.3e}")


if __name__ == "__main__":
    main()
