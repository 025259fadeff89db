"""SERVE a GNN over a streaming graph to CONCURRENT tenants: snapshot
queries overlap ingest, read-your-writes per tenant, a live p99 printout,
and a mid-stream hot swap from the device engine to host ``ripple`` and
back without dropping a committed update.

The paper's deployment shape (near-realtime inference under a continuous
update stream, §1) through ``repro_torch.serve``: a threaded
:class:`GraphServer` multiplexes per-tenant update + query streams onto
ONE engine; queries read a published snapshot while the next micro-batch
propagates.

    PYTHONPATH=src python -m repro_torch.examples.streaming_serve        # card
    PYTHONPATH=src python -m repro_torch.examples.streaming_serve --device cpu
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.serve import (GraphServer, TenantConfig, latency_summary,
                               split_stream)

N, M, D = 3000, 40000, 64
N_UPDATES, CHUNK = 2000, 25
TENANTS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "streaming_serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no card is present")
    args = ap.parse_args(argv)

    session = InferenceSession.build(SessionConfig(
        workload="gc-s", engine="device", graph="powerlaw", n=N, m=M,
        d_in=D, d_hidden=64, n_classes=16, device=args.device,
        engine_options={"async_dispatch": True}))
    updates = list(session.make_stream(N_UPDATES, seed=1))
    names = [f"tenant{i}" for i in range(TENANTS)]
    # power-law traffic skew: tenant0 is hot, the rest probe tail latency
    per_tenant = dict(zip(names, split_stream(updates, TENANTS, skew=1.0)))

    server = GraphServer(session,
                         tenants=[TenantConfig(n, staleness="stale")
                                  for n in names],
                         max_batch=128).start()

    def tenant_loop(name, ups):
        """One tenant: stream updates in chunks, query between chunks
        (snapshot reads, never blocked by ingest)."""
        rng = np.random.default_rng(names.index(name))
        for i in range(0, len(ups), CHUNK):
            server.submit(name, ups[i:i + CHUNK])
            server.query(name, rng.integers(0, N, size=8))
            time.sleep(0.002)              # request pacing

    threads = [threading.Thread(target=tenant_loop, args=(n, u), daemon=True)
               for n, u in per_tenant.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    # live tail-latency printout while traffic flows
    while any(t.is_alive() for t in threads):
        time.sleep(0.05)
        q = latency_summary(server.query_latencies["snapshot"])
        if q["n"]:
            print(f"\r  live: {server.version:4d} batches committed, "
                  f"query p50 {q['p50_ms']:7.3f} ms  p99 {q['p99_ms']:7.3f} "
                  f"ms ({q['n']} queries)", end="", flush=True)
    for t in threads:
        t.join()
    server.drain()
    wall = time.perf_counter() - t0
    print()

    m = server.metrics()
    q = latency_summary(server.query_latencies["snapshot"])
    ing = latency_summary(m["ingest_latencies_s"])
    n_up = sum(len(u) for u in per_tenant.values())
    print(f"served {n_up} updates from {TENANTS} tenants on "
          f"{session.device} in {wall:.2f}s ({n_up / wall:.0f} up/s)")
    print(f"query  p50 {q['p50_ms']:.3f} ms  p99 {q['p99_ms']:.3f} ms "
          f"(snapshot reads, concurrent with ingest)")
    print(f"ingest p50 {ing['p50_ms']:.3f} ms  p99 {ing['p99_ms']:.3f} ms "
          f"(submit -> published)")

    # hot-swap the live server onto host ripple and back, and keep serving:
    # the committed snapshot survives, tenants never notice
    before = server.query(names[1], np.arange(16)).values
    server.swap_engine("ripple")
    server.swap_engine("device", async_dispatch=True)
    after = server.query(names[1], np.arange(16)).values
    np.testing.assert_allclose(before, after, atol=2e-3, rtol=2e-3)
    server.submit(names[1], list(session.make_stream(100, seed=2)))
    server.drain()
    r = server.query(names[1], np.arange(16))
    print(f"hot-swapped device -> ripple -> device mid-serve: snapshot "
          f"preserved, +100 updates committed (version {r.version}, "
          f"staleness {r.staleness})")
    server.stop()


if __name__ == "__main__":
    main()
