#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the hand-written CUDA kernels from this checkout's sources
with nvcc (into build/kernels/).  Phase 2 holds each kernel against its
plain PyTorch version at the main path's shapes and at the ragged shapes
of tests/test_kernels.py, and times both.  Phase 3 drives the port's main
path: a ``device``-engine session per kernel -- gc-s (delta_apply) and
gi-s (mlp_apply) -- over a synthetic power-law graph at the paper's Arxiv
scale (169,343 vertices, 1,166,243 edges), 3 layers of 128 features and
40 classes, ingesting a 3000-update paper-protocol stream in batches of
100 (the last 5 batches under torch.profiler, for the device's busy
share); it checks the launch counts and holds every layer against the
port's own full-inference oracle.

Any fault ends the run with a traceback and a non-zero exit; nothing is
caught.  Without a CUDA card, or without the repository beside this file,
it exits non-zero before printing any result.  Output ends with the card
line (nvidia-smi's name and power limit), the kernels JSON line and the
device JSON line.

Precision: TF32 is off for matmuls and cuDNN, so the SAGE self term, the
bootstrap and the oracle run in full fp32, as the 2e-3 and 1e-4 bars need.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
S_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_kernels.py bars
H_TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-3, rtol=2e-3)

DEVICE = "cuda"
MAIN_R = (64, 4096, 65536)   # cap-ladder rungs the arxiv-scale hops use
ARXIV = dict(n=169_343, m=1_166_243, n_layers=3, d_in=128, d_hidden=128,
             n_classes=40)
N_UPDATES, BATCH = 3000, 100
N_PROFILED = 500             # the stream's last 5 batches run under the profiler


def log(*parts) -> None:
    print(*parts, flush=True)


def device_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, in ms.  The calls queue
    up behind a device-side sleep, so the gaps between their events are
    device time, not host launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(iters))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def delta_work(R: int, Din: int, Dout: int) -> tuple[int, int]:
    """(bytes, flops): reads S, M, k, W, b once; writes S', h once."""
    return (4 * (R * (3 * Din + Dout + 1) + Din * Dout + Dout),
            2 * R * Din * Dout)


def mlp_work(R: int, Din: int, Dh: int, Dout: int) -> tuple[int, int]:
    """(bytes, flops): reads S, M, h_prev, k and the weights; writes S', h."""
    return (4 * (R * (4 * Din + Dout + 1) + Din * Dh + Dh + Dh * Dout + Dout),
            2 * R * (Din * Dh + Dh * Dout))


def _inputs(gen: torch.Generator, R: int, Din: int, dims: tuple[int, ...]):
    dev = torch.device(DEVICE)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    S, M, hp = rand(R, Din), rand(R, Din), rand(R, Din)
    k = torch.randint(0, 6, (R,), generator=gen).float().to(dev)
    ws = []
    for d_in, d_out in zip((Din,) + dims[:-1], dims):
        ws += [rand(d_in, d_out) / d_in ** 0.5, rand(d_out)]
    return S, M, hp, k, ws


def check_delta(gen, R, Din, Dout, mean, relu, *, timed: bool) -> dict:
    from repro_torch.kernels.delta_apply import delta_apply
    from repro_torch.kernels.delta_apply.ref import delta_apply_ref
    S, M, _, k, (W, b) = _inputs(gen, R, Din, (Dout,))
    Sk, hk = delta_apply(S, M, k, W, b, mean=mean, relu=relu)
    Sr, hr = delta_apply_ref(S, M, k, W, b, mean=mean, relu=relu)
    torch.cuda.synchronize()
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="delta_apply", R=R, Din=Din, Dout=Dout, mean=mean,
               relu=relu, err_S=(Sk - Sr).abs().max().item(),
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        x = S + M
        if mean:
            x = x / k.clamp(min=1.0)[:, None]
        nbytes, flops = delta_work(R, Din, Dout)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(
            ms=device_ms(lambda: delta_apply(S, M, k, W, b, mean=mean,
                                             relu=relu)),
            plain_ms=device_ms(lambda: delta_apply_ref(S, M, k, W, b,
                                                       mean=mean, relu=relu)),
            addmm_matmul_only_ms=device_ms(lambda: torch.addmm(b, x, W)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def check_mlp(gen, R, Din, Dh, Dout, mean, relu, *, timed: bool) -> dict:
    from repro_torch.kernels.mlp_apply import mlp_apply
    from repro_torch.kernels.mlp_apply.ref import mlp_apply_ref
    S, M, hp, k, (W1, b1, W2, b2) = _inputs(gen, R, Din, (Dh, Dout))
    eps = 0.37
    args = (S, M, hp, k, eps, W1, b1, W2, b2)
    Sk, hk = mlp_apply(*args, mean=mean, relu=relu)
    Sr, hr = mlp_apply_ref(*args, mean=mean, relu=relu)
    torch.cuda.synchronize()
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="mlp_apply", R=R, Din=Din, Dh=Dh, Dout=Dout,
               mean=mean, relu=relu, err_S=(Sk - Sr).abs().max().item(),
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        x = S + M
        if mean:
            x = x / k.clamp(min=1.0)[:, None]
        z = (1.0 + eps) * hp + x
        nbytes, flops = mlp_work(R, Din, Dh, Dout)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(
            ms=device_ms(lambda: mlp_apply(*args, mean=mean, relu=relu)),
            plain_ms=device_ms(lambda: mlp_apply_ref(*args, mean=mean,
                                                     relu=relu)),
            addmm_matmul_only_ms=device_ms(
                lambda: torch.addmm(b2, torch.addmm(b1, z, W1), W2)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def phase_kernels() -> list[dict]:
    """Every kernel against its plain version; main-path shapes timed."""
    gen = torch.Generator().manual_seed(0)
    rows = []
    for R in MAIN_R:
        for Dout in (128, 40):
            rows.append(check_delta(gen, R, 128, Dout, False, True,
                                    timed=True))
            rows.append(check_mlp(gen, R, 128, Dout, Dout, False, True,
                                  timed=True))
    for R, Din, Dout in ((64, 32, 16), (128, 128, 128), (33, 48, 7),
                         (256, 64, 200)):
        for mean, relu in ((False, True), (True, False), (True, True)):
            rows.append(check_delta(gen, R, Din, Dout, mean, relu,
                                    timed=False))
    for R, Din, Dh, Dout in ((64, 32, 32, 16), (128, 128, 128, 128),
                             (33, 48, 20, 7)):
        for mean, relu in ((False, True), (True, False)):
            rows.append(check_mlp(gen, R, Din, Dh, Dout, mean, relu,
                                  timed=False))
    for row in rows:
        log("kernel_check", json.dumps(row))
    return rows


def profile_window(session, updates) -> dict:
    """A few batches under torch.profiler: the device's busy share (its
    kernels' and copies' device time over the window's wall time, which
    the profiler's own host cost inflates), device operations per batch,
    and the largest device-time entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = session.ingest(updates, batch_size=BATCH,
                                keep_results=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        batches=report.n_batches, wall_ms=wall * 1e3,
        device_busy_ms=busy_us / 1e3 if dev else None,
        device_busy_share=busy_us * 1e-6 / wall if dev else None,
        device_ops_per_batch=sum(e.count for e in dev) / report.n_batches,
        top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
             for e in top])


def run_session(workload: str, counter) -> dict:
    """One arxiv-scale device-engine session, checked against the oracle."""
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference
    t0 = time.perf_counter()
    session = InferenceSession.build(SessionConfig(
        workload=workload, engine="device", graph="powerlaw",
        holdout_frac=0.1, seed=0, device=DEVICE, **ARXIV))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    updates = session.make_stream(N_UPDATES, seed=1).updates
    before = counter.launches
    report = session.ingest(updates[:-N_PROFILED], batch_size=BATCH,
                            keep_results=False)
    torch.cuda.synchronize()
    profiled = profile_window(session, updates[-N_PROFILED:])
    launches = counter.launches - before
    L = ARXIV["n_layers"]
    n_batches = report.n_batches + profiled["batches"]
    if report.n_batches < 20 or launches < L * n_batches:
        raise AssertionError(f"{workload}: {launches} kernel launches for "
                             f"{n_batches} batches x {L} layers")

    state = session.sync()
    x = torch.as_tensor(state.H[0], device=DEVICE)
    H_ref, _ = full_inference(session.workload, session.params, x,
                              *session.graph.coo(), session.graph.in_degree)
    layer_err, layer_tol_use = [], []
    for l in range(1, L + 1):
        got = torch.as_tensor(state.H[l], device=DEVICE)
        torch.testing.assert_close(got, H_ref[l], **ORACLE_TOL)
        err = (got - H_ref[l]).abs()
        layer_err.append(err.max().item())
        # the largest share of the allowed error any element uses (< 1)
        allowed = ORACLE_TOL["atol"] + ORACLE_TOL["rtol"] * H_ref[l].abs()
        layer_tol_use.append((err / allowed).max().item())
    final = torch.as_tensor(session.query(), device=DEVICE)
    torch.testing.assert_close(final, H_ref[L], **ORACLE_TOL)
    # predictions: every disagreement must be a near-tie of the oracle's
    # own logits (a difference within the 2e-3 bar)
    pred = torch.as_tensor(session.predict(), device=DEVICE)
    ref_pred = H_ref[L].argmax(dim=1)
    bad = (pred != ref_pred).nonzero().flatten()
    gap = (H_ref[L][bad, ref_pred[bad]] - H_ref[L][bad, pred[bad]]).abs()
    if bad.numel() and gap.max().item() > 2e-3 * (
            1 + H_ref[L][bad].abs().max().item()):
        raise AssertionError(f"{workload}: predictions disagree beyond "
                             f"ties at {bad.numel()} vertices")
    eng = session.engine.impl
    lat = sorted(report.latencies)
    p50 = statistics.median(lat) * 1e3
    result = dict(
        workload=workload, n=ARXIV["n"], edges=session.graph.num_edges,
        layers=L, width=ARXIV["d_hidden"], classes=ARXIV["n_classes"],
        updates=len(updates), timed_batches=report.n_batches, batch=BATCH,
        build_s=build_s, launches=launches, retries=eng.retries,
        hop_caps=[list(c) for c in eng._caps(0)],
        mirror_uploads=eng.out_mirror.uploads,
        steady_ups=BATCH / (p50 * 1e-3), p50_ms=p50,
        p99_ms=report.p99_latency_ms, wall_ups=report.throughput,
        max_err_per_layer=layer_err, tol_use_per_layer=layer_tol_use,
        predict_mismatch=int(bad.numel()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        profiled=profiled)
    log("session", json.dumps(result))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: the port's package is missing beside "
                 f"{Path(__file__).name} (src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_apply import delta_apply
    from repro_torch.kernels.mlp_apply import mlp_apply

    # ---- phase 1: build --------------------------------------------------
    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s into {_build.BUILD_DIR}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: kernels against their plain versions -------------------
    phase_kernels()

    # ---- phase 3: the main path ------------------------------------------
    counters = {"delta_apply": delta_apply, "mlp_apply": mlp_apply}
    for fn in counters.values():
        fn.launches = 0
    sessions = {"delta_apply": run_session("gc-s", delta_apply),
                "mlp_apply": run_session("gi-s", mlp_apply)}
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    # ---- the kernels line: timed at the main path's largest hop ----------
    gen = torch.Generator().manual_seed(1)
    kernels = []
    for name, source, replaces in (
            ("delta_apply", "src/repro_torch/kernels/csrc/delta_apply.cu",
             "src/repro/kernels/delta_apply/kernel.py:61"),
            ("mlp_apply", "src/repro_torch/kernels/csrc/mlp_apply.cu",
             "src/repro/kernels/mlp_apply/kernel.py:66")):
        R = max(r for r, _ in sessions[name]["hop_caps"])
        row = (check_delta(gen, R, 128, 128, False, True, timed=True)
               if name == "delta_apply" else
               check_mlp(gen, R, 128, 128, 128, False, True, timed=True))
        log("kernel_main", json.dumps(row))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shape=f"R={R} Din=128 Dout=128", passed=True))
    torch.cuda.synchronize()

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
