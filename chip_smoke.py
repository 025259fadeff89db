#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the hand-written CUDA kernels from this checkout's sources
with nvcc (into build/kernels/), one nvcc per source, all at once.
Phase 2 holds each kernel against its plain PyTorch version at the main
path's shapes and at the ragged shapes of tests/test_kernels.py, and times
both (embedding_bag also against F.embedding_bag, its library yardstick).
Phase 3 drives the port's main paths, one ``device``-engine session each
-- gc-s (delta_apply), gi-s (mlp_apply), the monotonic gs-max and gc-min
(extremum_apply), and the bounded-recompute gp-m (embedding_bag) and ga-s
(no kernel of its own) -- over a synthetic power-law graph at the paper's
Arxiv scale (169,343 vertices, 1,166,243 edges), 3 layers of 128 features
and 40 classes, ingesting a 3000-update paper-protocol stream in batches
of 100 (the last 5 batches under torch.profiler, for the device's busy
share).  Every launch count is set to 0 just before a session and read
just after it; each session with a kernel must have launched it on every
hop of every batch, and every session holds every layer against the
port's own full-inference oracle.  The monotonic sessions also hold S[1]
bit-equal to the oracle's and the witness invariant
S[l][v,d] == H[l-1][C[l][v,d], d] exactly, on the device, and report
their SHRINK counters and filter pass share; the bounded ones hold their
aux state A to a fresh reaggregation of the final state (sums within
2e-3, maxima bit-equal, PNA's max witnesses exact) and report the pull
and PNA's bag rectangle per hop.  Last, a ga-s run in approximate mode
(tolerance 0.1) over 10 batches of feature jitter holds every published
row within its certified bound.

Any fault ends the run with a traceback and a non-zero exit; nothing is
caught.  Without a CUDA card, or without the repository beside this file,
it exits non-zero before printing any result.  Output ends with the card
line (nvidia-smi's name and power limit), the kernels JSON line and the
device JSON line.

Precision: TF32 is off for matmuls and cuDNN, so the SAGE self term, the
bootstrap and the oracle run in full fp32, as the 2e-3 and 1e-4 bars need.
"""
from __future__ import annotations

import functools
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
S_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_kernels.py bars (extremum
#                                      S' is held bit-equal instead)
H_TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-3, rtol=2e-3)

DEVICE = "cuda"
MAIN_R = (64, 4096, 65536)   # cap-ladder rungs the arxiv-scale hops use
BAG_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),   # tests/test_kernels.py
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
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


def extremum_work(R: int, Din: int, Dout: int,
                  masked: bool) -> tuple[int, int]:
    """(bytes, flops): reads base (S or reagg, by the mask), M, the uint8
    mask when masked, W and b once; writes S', h once."""
    per_cell = 4 + 4 + 4 + (1 if masked else 0)
    return (R * Din * per_cell + 4 * (R * Dout + Din * Dout + Dout),
            2 * R * Din * Dout)


def check_extremum(gen, R, Din, Dout, maximize, masked, *,
                   timed: bool) -> dict:
    """Identity (+/-inf) rows in S and M, as tests/test_kernels.py puts
    them; with ``masked`` a ~7% shrink mask (bool, as the engine passes
    it) and its re-aggregated cells."""
    from repro_torch.kernels.extremum_apply import extremum_apply
    from repro_torch.kernels.extremum_apply.ref import extremum_apply_ref
    dev = torch.device(DEVICE)
    ident = -float("inf") if maximize else float("inf")
    S = torch.randn((R, Din), generator=gen)
    M = torch.randn((R, Din), generator=gen)
    S[torch.randperm(R, generator=gen)[:max(R // 8, 1)]] = ident
    M[torch.randperm(R, generator=gen)[:max(R // 4, 1)]] = ident
    W = torch.randn((Din, Dout), generator=gen) / Din ** 0.5
    b = torch.randn((Dout,), generator=gen)
    args = [t.to(dev) for t in (S, M, W, b)]
    kw = {}
    if masked:
        mask = torch.rand((R, Din), generator=gen) < 0.07
        kw = dict(reagg=(torch.randn((R, Din), generator=gen)
                         * mask).to(dev), mask=mask.to(dev))

    def kernel():
        return extremum_apply(*args, **kw, maximize=maximize, relu=True)

    def plain():
        return extremum_apply_ref(*args, **kw, maximize=maximize, relu=True)

    Sk, hk = kernel()
    Sr, hr = plain()
    torch.cuda.synchronize()
    if not torch.equal(Sk, Sr):
        raise AssertionError(f"extremum_apply S' differs from the plain "
                             f"version at R={R} Din={Din} Dout={Dout} "
                             f"maximize={maximize} masked={masked}")
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="extremum_apply", R=R, Din=Din, Dout=Dout,
               maximize=maximize, masked=masked, err_S=0.0,
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        nbytes, flops = extremum_work(R, Din, Dout, masked)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(ms=device_ms(kernel), plain_ms=device_ms(plain),
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


def bag_work(B: int, hot: int, d: int, kept: int,
             elem: int) -> tuple[int, int]:
    """(bytes, flops): reads the int32 index rectangle once and each kept
    lane's table row once (padding lanes read no row), writes the output
    once; one add per gathered element."""
    return 4 * B * hot + elem * d * (kept + B), kept * d


@functools.cache
def arxiv_in_degrees():
    """In-degrees of the sessions' arxiv-scale power-law graph (seed 0)."""
    from repro_torch.core.graph import powerlaw_graph
    _, dst, _ = powerlaw_graph(ARXIV["n"], ARXIV["m"], seed=0)
    return torch.bincount(torch.as_tensor(dst), minlength=ARXIV["n"])


def check_embedding_bag(seed: int, V: int, B: int, hot: int, d: int,
                        dtype=torch.float32, degs=None, *,
                        timed: bool) -> dict:
    """Without ``degs``: ids drawn over the whole table, as
    tests/test_kernels.py draws them.  With ``degs``: the engine's pattern
    -- bag r holds min(degs[r], hot) ids left-packed, the sentinel V (a
    zero row appended to the table, plus the engine's trash row) pads the
    rest, and the kernel skips it as padding_idx, as the engine calls it;
    the table is relu'd like the embeddings it gathers."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    table = torch.randn((V, d), generator=g, device=DEVICE)
    ids = torch.randint(0, V, (B, hot), generator=g, device=DEVICE,
                        dtype=torch.int32)
    pad = None
    kept = B * hot
    if degs is not None:
        table = torch.cat([table.relu(), table.new_zeros((2, d))])
        lens = torch.as_tensor(degs, device=DEVICE).clamp(max=hot)
        ids = torch.where(torch.arange(hot, device=DEVICE)[None, :]
                          < lens[:, None], ids, V)
        pad = V
        kept = int(lens.sum())
    table = table.to(dtype)

    def kernel():
        return embedding_bag(table, ids, padding_idx=pad)

    def plain():
        return embedding_bag_ref(table, ids, padding_idx=pad)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BAG_TOL[dtype])
    row = dict(kernel="embedding_bag", V=table.shape[0], B=B, hot=hot, d=d,
               dtype=str(dtype), kept_lanes=kept, padding_idx=pad,
               max_abs_err=(out.float() - ref.float()).abs().max().item())
    if pad is not None:
        # the sentinel row is zero: skipping it changes nothing
        torch.testing.assert_close(embedding_bag(table, ids), out,
                                   **BAG_TOL[dtype])
    if timed:
        nbytes, flops = bag_work(B, hot, d, kept, table.element_size())
        b_ms, b_by = bound_ms(nbytes, flops)
        slow = B * hot * d > 1 << 30   # the plain version's gather is huge
        row.update(
            ms=device_ms(kernel), rect_bytes=4 * B * hot,
            plain_ms=device_ms(plain, iters=5 if slow else 25,
                               warmup=1 if slow else 3),
            library_ms=device_ms(lambda: F.embedding_bag(
                ids, table, mode="sum", padding_idx=pad)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def phase_kernels() -> list[dict]:
    """Every kernel against its plain version; main-path shapes timed."""
    gen = torch.Generator().manual_seed(0)
    rows = []
    for V, B, hot, d in ((100, 8, 1, 16), (1000, 32, 4, 64),
                         (5000, 16, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_embedding_bag(len(rows), V, B, hot, d, dtype,
                                            timed=False))
    for V, B, hot, d in ((64, 16, 8, 16), (200, 48, 12, 32)):
        degs = torch.randint(0, hot + 1, (B,), generator=gen)
        rows.append(check_embedding_bag(len(rows), V, B, hot, d, degs=degs,
                                        timed=False))
    # the main path's shapes: bags of arxiv in-degrees, the hub's first
    indeg = arxiv_in_degrees()
    for B in (64, 2048):
        degs = indeg[torch.randint(0, ARXIV["n"], (B,), generator=gen)]
        degs[0] = indeg.max()
        for hot in (64, 4096, 262144):
            rows.append(check_embedding_bag(len(rows), ARXIV["n"], B, hot,
                                            128, degs=degs, timed=True))
    for R in MAIN_R:
        for Dout in (128, 40):
            rows.append(check_delta(gen, R, 128, Dout, False, True,
                                    timed=True))
            rows.append(check_mlp(gen, R, 128, Dout, Dout, False, True,
                                  timed=True))
            for maximize in (True, False):
                for masked in (True, False):
                    rows.append(check_extremum(gen, R, 128, Dout, maximize,
                                               masked, timed=True))
    for R, Din, Dout in ((64, 32, 16), (128, 128, 128), (33, 48, 7),
                         (256, 64, 200)):
        for maximize in (True, False):
            for masked in (True, False):
                rows.append(check_extremum(gen, R, Din, Dout, maximize,
                                           masked, timed=False))
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


def profile_window(session, updates):
    """A few batches under torch.profiler: the device's busy share (its
    kernels' and copies' device time over the window's wall time, which
    the profiler's own host cost inflates), device operations per batch,
    and the largest device-time entries.  Returns (summary, report)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = session.ingest(updates, batch_size=BATCH)
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
             for e in top]), report


def check_witnesses(eng) -> int:
    """S[l][v,d] == H[l-1][C[l][v,d], d] exactly, on the device, wherever
    C >= 0, and the identity (+/-inf) wherever C == -1; returns the number
    of witnessed cells checked."""
    n, checked = eng.n, 0
    for l in range(1, len(eng.state.S)):
        C = eng.state.C[l][:n].long()
        S = eng.state.S[l][:n]
        has = C >= 0
        got = eng.state.H[l - 1][:n].gather(0, C.clamp(min=0))
        if not torch.equal(got[has], S[has]):
            raise AssertionError(f"layer {l}: a witness does not attain "
                                 f"its extremum")
        if torch.isfinite(S[~has]).any():
            raise AssertionError(f"layer {l}: an empty cell is finite")
        checked += int(has.sum())
    return checked


def check_bounded_aux(session) -> dict:
    """The engine's aux state A against a fresh reaggregation of the final
    state on the device: sums (s1, s2, z) within 2e-3, maxima (m, mx, theta)
    bit-equal, and PNA's witnesses exact: H[l-1][mref[v,d], d] == mx[v,d]
    wherever mref >= 0, -inf wherever it is -1."""
    from repro_torch.core.full import bounded_aux
    eng = session.engine.impl
    n = eng.n
    src, dst, _ = session.graph.coo()
    fresh = bounded_aux(session.workload, [h[:n] for h in eng.state.H], src,
                        dst)
    names = session.workload.agg.aux_names
    out = dict(aux_max_err={}, witnesses_checked=0)
    for l in range(1, len(eng.state.H)):
        got = dict(zip(names, (a[:n] for a in eng.state.A[l])))
        for nm, ref in fresh[l].items():
            if nm in ("m", "mx", "theta"):
                if not torch.equal(got[nm], ref):
                    raise AssertionError(f"A[{l}][{nm}] differs from a "
                                         f"fresh reaggregation")
            elif nm != "mref":
                torch.testing.assert_close(got[nm], ref, **ORACLE_TOL)
                out["aux_max_err"][f"{l}.{nm}"] = \
                    (got[nm] - ref).abs().max().item()
        if "mref" in got:
            mref, mx = got["mref"].long(), got["mx"]
            has = mref >= 0
            hit = eng.state.H[l - 1][:n].gather(0, mref.clamp(min=0))
            if not torch.equal(hit[has], mx[has]) \
                    or torch.isfinite(mx[~has]).any():
                raise AssertionError(f"layer {l}: a PNA max witness does "
                                     f"not attain its max")
            out["witnesses_checked"] += int(has.sum())
    return out


def run_session(workload: str, counters: dict, kernel: str | None) -> dict:
    """One arxiv-scale device-engine session, checked against the oracle.
    Every launch count is set to 0 just before the session is driven and
    read just after; ``kernel`` (None for a path with no kernel of its own)
    must have run on every hop of every batch."""
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = InferenceSession.build(SessionConfig(
        workload=workload, engine="device", graph="powerlaw",
        holdout_frac=0.1, seed=0, device=DEVICE, **ARXIV))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    updates = session.make_stream(N_UPDATES, seed=1).updates
    eng = session.engine.impl
    H_start = [h.clone() for h in eng.state.H] \
        if eng.monotonic or eng.bounded else None
    for fn in counters.values():
        fn.launches = 0
    report = session.ingest(updates[:-N_PROFILED], batch_size=BATCH)
    torch.cuda.synchronize()
    profiled, report_p = profile_window(session, updates[-N_PROFILED:])
    launches = {name: fn.launches for name, fn in counters.items()}
    L = ARXIV["n_layers"]
    n_batches = report.n_batches + report_p.n_batches
    if report.n_batches < 20 or (kernel is not None
                                 and launches[kernel] < L * n_batches):
        raise AssertionError(f"{workload}: {launches} launches for "
                             f"{n_batches} batches x {L} layers")

    state = session.sync()
    x = torch.as_tensor(state.H[0], device=DEVICE)
    H_ref, S_ref = full_inference(session.workload, session.params, x,
                                  *session.graph.coo(),
                                  session.graph.in_degree)
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
    results = report.results + report_p.results
    affected = sum(int(r.affected.size) for r in results)
    if eng.monotonic:
        # a max/min over the unchanged features involves no rounding
        if not torch.equal(torch.as_tensor(state.S[1], device=DEVICE),
                           S_ref[1]):
            raise AssertionError(f"{workload}: S[1] differs from the "
                                 f"oracle's")
        result.update(
            pull=eng.pull, witnesses_checked=check_witnesses(eng),
            counters={f: sum(getattr(r, f) for r in results) for f in (
                "shrink_events", "rows_reaggregated", "dims_reaggregated",
                "recover_hits")})
    if eng.bounded:
        caps = eng._caps(0)
        result.update(
            counters={f: sum(getattr(r, f) for r in results) for f in (
                "rows_reaggregated", "deferred_rows", "bound_violations",
                "patch_events")},
            # per hop (recipients, edges, pulled lanes, largest in-degree)
            needed_per_hop_max=eng._hw.tolist(),
            # PNA's bag rectangle at the settled caps (int32 ids)
            rect_bytes_per_hop=[4 * c[0] * c[3] for c in caps])
    if eng.monotonic or eng.bounded:
        result.update(
            # share of the last hop's recipients whose embedding changed
            filter_pass_share=affected / max(int(eng.sizes_total[-1][0]),
                                             1),
            needed_per_hop_total=eng.sizes_total.tolist(),
            in_mirror_uploads=eng.in_mirror.uploads,
            # per layer: rows whose H moved over the stream, and those that
            # moved by less than 1e-5 relative -- rounding, not change
            changed_rows=[], tiny_change_rows=[])
        for l in range(1, L + 1):
            h0 = H_start[l][:eng.n]
            moved = (eng.state.H[l][:eng.n] - h0).abs().amax(dim=1)
            scale = h0.abs().amax(dim=1).clamp(min=1.0)
            result["changed_rows"].append(int((moved > 0).sum()))
            result["tiny_change_rows"].append(
                int(((moved > 0) & (moved < 1e-5 * scale)).sum()))
    log("session", json.dumps(result))
    if eng.bounded:
        # after the session line, so its numbers survive a failed check
        aux = check_bounded_aux(session)
        log("session_aux", json.dumps(dict(workload=workload, **aux)))
        result.update(aux)
    return result


def run_tolerance_session(workload: str = "ga-s", tolerance: float = 0.1,
                          n_batches: int = 10) -> dict:
    """Approximate mode at the arxiv scale: batches of 100 feature nudges
    (N(0, 1e-6) added to current features, the sensor-jitter regime in
    which interior changes fit a deferral budget).  After each batch the
    certified bound must stay within the tolerance and every published
    row's error against the oracle within its bound plus 2e-3."""
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference
    from repro_torch.core.graph import FeatureUpdate, UpdateBatch
    session = InferenceSession.build(SessionConfig(
        workload=workload, engine="device", graph="powerlaw",
        holdout_frac=0.1, seed=0, device=DEVICE,
        engine_options={"tolerance": tolerance}, **ARXIV))
    gen = torch.Generator().manual_seed(2)
    x = torch.as_tensor(session.state.H[0]).clone()
    rows, max_err, max_bound = [], 0.0, 0.0
    for _ in range(n_batches):
        vs = torch.randperm(ARXIV["n"], generator=gen)[:BATCH]
        x[vs] += 1e-6 * torch.randn((BATCH, ARXIV["d_in"]), generator=gen)
        res = session.apply_one(UpdateBatch(features=[
            FeatureUpdate(int(v), x[v].numpy().copy()) for v in vs]))
        bound = torch.as_tensor(session.engine.error_bound(), device=DEVICE)
        if bound.max().item() > tolerance + 1e-6:
            raise AssertionError(f"certified bound {bound.max().item()} "
                                 f"exceeds the tolerance {tolerance}")
        st = session.sync()
        H_ref, _ = full_inference(session.workload, session.params,
                                  torch.as_tensor(st.H[0], device=DEVICE),
                                  *session.graph.coo(),
                                  session.graph.in_degree)
        err = (torch.as_tensor(st.H[-1], device=DEVICE)
               - H_ref[-1]).abs().amax(dim=1)
        if (err > bound + ORACLE_TOL["atol"]).any():
            raise AssertionError(f"published error {err.max().item()} "
                                 f"exceeds the certified bound "
                                 f"{bound.max().item()}")
        max_err = max(max_err, err.max().item())
        max_bound = max(max_bound, bound.max().item())
        rows.append((res.deferred_rows, res.bound_violations,
                     res.rows_reaggregated))
    result = dict(workload=workload, tolerance=tolerance, batches=n_batches,
                  deferred_rows=[r[0] for r in rows],
                  bound_violations=[r[1] for r in rows],
                  rows_reaggregated=[r[2] for r in rows],
                  max_published_err=max_err, max_error_bound=max_bound,
                  eps_per_layer=session.engine.impl._eps.tolist())
    log("tolerance_session", json.dumps(result))
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
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.extremum_apply import extremum_apply
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

    # ---- phase 3: the main paths, one session each -----------------------
    counters = {"delta_apply": delta_apply, "mlp_apply": mlp_apply,
                "extremum_apply": extremum_apply,
                "embedding_bag": embedding_bag}
    sessions = [run_session(wl, counters, kernel) for wl, kernel in (
        ("gc-s", "delta_apply"), ("gi-s", "mlp_apply"),
        ("gs-max", "extremum_apply"), ("gc-min", "extremum_apply"),
        ("gp-m", "embedding_bag"), ("ga-s", None))]
    launches = {name: sum(s["launches"][name] for s in sessions)
                for name in counters}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    run_tolerance_session()

    # ---- the kernels line: timed at the main path's largest hop ----------
    gen = torch.Generator().manual_seed(1)
    kernels = []
    for name, source, replaces, check in (
            ("delta_apply", "src/repro_torch/kernels/csrc/delta_apply.cu",
             "src/repro/kernels/delta_apply/kernel.py:61",
             lambda R, D: check_delta(gen, R, 128, D, False, True,
                                      timed=True)),
            ("mlp_apply", "src/repro_torch/kernels/csrc/mlp_apply.cu",
             "src/repro/kernels/mlp_apply/kernel.py:66",
             lambda R, D: check_mlp(gen, R, 128, D, D, False, True,
                                    timed=True)),
            ("extremum_apply",
             "src/repro_torch/kernels/csrc/extremum_apply.cu",
             "src/repro/kernels/extremum_apply/kernel.py:115",
             lambda R, D: check_extremum(gen, R, 128, D, True, True,
                                         timed=True))):
        R = max(c[0] for s in sessions if s["launches"][name]
                for c in s["hop_caps"])
        rows = [check(R, D) for D in (128, 40)]
        for row in rows:
            log("kernel_main", json.dumps(row))
        row = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shape=f"R={R} Din=128 Dout=128", passed=True))
    # embedding_bag at the largest rectangle the gp-m session's hops used
    pnm = next(s for s in sessions if s["workload"] == "gp-m")
    B, hot = max(((c[0], c[3]) for c in pnm["hop_caps"]),
                 key=lambda c: c[0] * c[1])
    indeg = arxiv_in_degrees()
    degs = indeg[torch.randint(0, ARXIV["n"], (B,), generator=gen)]
    degs[0] = indeg.max()
    row = check_embedding_bag(99, ARXIV["n"], B, hot, 128, degs=degs,
                              timed=True)
    log("kernel_main", json.dumps(row))
    kernels.append(dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:47",
        launches=launches["embedding_bag"], max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=f"B={B} hot={hot} d=128 kept={row['kept_lanes']}",
        passed=True))
    torch.cuda.synchronize()

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
