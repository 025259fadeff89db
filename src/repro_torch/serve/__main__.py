"""Graph-serving CLI: concurrent tenants over one engine, live tail stats.

    PYTHONPATH=src python -m repro_torch.serve --engine device --tenants 4 \
        --updates 2000 --deadline-ms 5

Builds a synthetic session, splits a paper-protocol update stream across
power-law-skewed tenants, drives it closed-loop (or open-loop) through a
threaded :class:`GraphServer`, and prints p50/p99 query + ingest latency.
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import InferenceSession, SessionConfig, engine_names

from . import (ClosedLoopLoad, GraphServer, OpenLoopLoad, latency_summary,
               split_stream)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=engine_names(), default="device")
    ap.add_argument("--workload", default="gc-s")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=8000)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--skew", type=float, default=1.0,
                    help="power-law tenant traffic skew (0 = uniform)")
    ap.add_argument("--updates", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=8,
                    help="updates per submit() call")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="ingest micro-batch latency budget (0 = off)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="open-loop arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no card is present")
    args = ap.parse_args(argv)

    session = InferenceSession.build(SessionConfig(
        workload=args.workload, engine=args.engine, n=args.n, m=args.m,
        seed=args.seed, deadline_ms=args.deadline_ms, device=args.device))
    updates = list(session.make_stream(args.updates, seed=args.seed + 1))
    names = [f"t{i}" for i in range(args.tenants)]
    per = dict(zip(names, split_stream(updates, args.tenants,
                                       skew=args.skew, seed=args.seed)))
    print(f"engine={session.engine_name} device={session.device} "
          f"tenants={args.tenants} updates={len(updates)} mode={args.mode}")

    with GraphServer(session, tenants=names, max_batch=args.max_batch,
                     deadline_ms=args.deadline_ms) as server:
        cls = ClosedLoopLoad if args.mode == "closed" else OpenLoopLoad
        kw = {} if args.mode == "closed" else {"rate": args.rate}
        rep = cls(server, per, chunk=args.chunk, seed=args.seed, **kw).run()
    m = server.metrics()   # after stop(): the drained totals

    q = latency_summary(rep.query_latencies)
    ing = latency_summary(m["ingest_latencies_s"])
    print(f"throughput : {rep.achieved_rate:10.0f} updates/s "
          f"({rep.n_updates} updates, {rep.wall_s:.2f}s wall)")
    print(f"query  lat : p50 {q['p50_ms']:8.3f} ms   p99 {q['p99_ms']:8.3f} ms"
          f"   ({q['n']} queries)")
    print(f"ingest lat : p50 {ing['p50_ms']:8.3f} ms   p99 {ing['p99_ms']:8.3f}"
          f" ms   (submit -> published)")
    st = m["staleness_samples"]
    print(f"staleness  : mean {np.mean(st) if st else 0:.2f} updates, "
          f"max {max(st, default=0)}  over {len(st)} snapshot reads")
    print(f"micro-batch: {m['batches']} batches, mean size "
          f"{np.mean(m['batch_sizes']) if m['batch_sizes'] else 0:.1f}")


if __name__ == "__main__":
    main()
