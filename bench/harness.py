"""One run of one cell: set-up, the closed-loop window, the check against
the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``bench/configs/
<name>.json``: the model, the graph, the engine, the plain reference in
``bench/reference/`` and the limits of the comparison) and a traffic mix
(``bench/traffic/<name>.json``, read by ``gen/stream.py``).  With
``trace`` on, each per-layer metric the cell reports is read by
``bench/metrics/<name>.py`` from the traced window.

Set-up makes the graph, the features and the weights from the
configuration's ``inputs_seed``, bootstraps the program's session, and runs
warm-up batches of the cell's own traffic, also drawn from ``inputs_seed``,
until the program's cap ladder has settled (at least ``WARMUP_MIN``
batches and no retry in the last ``SETTLE``, at most ``WARMUP_MAX``).  The
program sizes its capacities by the largest batches it has seen and never
lowers them, so a warm-up drawn from the run's seed would give each seed
capacities of its own, and with them padded work of its own for the whole
window.  The window's batches come from the run's seed: every seed runs
the same graph, weights and capacities on another stream.  The window is one
client calling ``apply_one`` batch after batch for ``seconds``: a batch's
latency runs from just before the call to its return, its generation
counts in the window but not in its latency, and a batch still running
when the window closes is neither counted nor timed (it is applied all the
same, and the check covers it).  After the window the program's state is
read back and freed, and the reference runs on the graph and features the
stream tracked.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WARMUP_MIN = 32      # warm-up batches at least: past the program's settle
SETTLE = 10          # then it ends after this many batches without a retry
WARMUP_MAX = 120     # ... or after this many batches in all
BIG = 1e30           # a compared number that is not finite prints as this


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """``(manifest, cell, config, traffic)`` of the cell ``name``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"known: {', '.join(cells)}")
    cell = cells[name]
    cfg = json.loads((root / "bench" / "configs"
                      / f"{cell['config']}.json").read_text())
    traffic = json.loads((root / "bench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return manifest, cell, cfg, traffic


def load_reader(metric: str, root: Path = ROOT):
    """The reader module ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dims_of(cfg: dict) -> tuple[int, ...]:
    L = cfg["n_layers"]
    return (cfg["d_in"],) + (cfg["d_hidden"],) * (L - 1) + (cfg["n_classes"],)


def make_weights(shapes: list[dict], gen, device: str) -> list[dict]:
    """Every layer's weights from one draw of ``gen`` on ``device``:
    matrices N(0, 1 / rows), biases with standard deviation 0.1."""
    import torch
    sizes = [math.prod(s) for layer in shapes for s in layer.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = [], 0
    for layer in shapes:
        d = {}
        for name, shape in layer.items():
            t = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            d[name] = t / math.sqrt(shape[0]) if len(shape) == 2 else t * 0.1
        out.append(d)
    return out


@dataclass
class ReadContext:
    """What a per-layer reader may read."""

    trace: object            # trace.Trace of the window
    cfg: dict
    dims: tuple[int, ...]
    batches: list            # the window's committed gen.stream.Batch
    counters: dict           # program counters over the window
    n: int
    final_src: np.ndarray    # the tracked graph after the last batch
    final_dst: np.ndarray


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else BIG


def _window(session, stream, seconds: float, trace: bool) -> dict:
    """The closed loop: batches for ``seconds``, each generated before its
    clock starts; with ``trace`` under the profiler and the spans of
    ``bench/trace.py``.  Returns the latencies of the batches completed in
    the window, their updates, the batches started and failed, every
    committed batch, and the profile."""
    from bench import program
    with contextlib.ExitStack() as stack:
        if trace:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            from bench.trace import layer_spans
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            stack.enter_context(layer_spans())
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(record_function("bench.window"))

            def mark(label):
                return record_function(label)
        else:
            prof = None

            def mark(label):
                return contextlib.nullcontext()
        out = dict(lat=[], updates=0, started=0, failed=0, batches=[],
                   prof=prof, t_open=time.perf_counter())
        deadline = out["t_open"] + seconds
        try:
            while True:
                with mark("bench.generate"):
                    b = stream.next_batch()
                    ub = program.to_update_batch(b)
                t0 = time.perf_counter()
                if t0 >= deadline:
                    break
                out["started"] += 1
                with mark("bench.batch"):
                    session.apply_one(ub)
                t1 = time.perf_counter()
                stream.commit(b)
                out["batches"].append(b)
                if t1 <= deadline:
                    out["lat"].append(t1 - t0)
                    out["updates"] += len(b)
        except Exception:          # a batch that raised fails the run
            out["failed"] = 1
            _log(traceback.format_exc())
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT,
             t_start: float | None = None, overrides: dict | None = None,
             tamper=None, control: bool = False) -> dict:
    """Run the cell ``name`` once and return its result line as a dict.

    ``overrides`` (tests) replaces keys of the configuration
    (``"config"``) and of the traffic (``"traffic"``); ``tamper(session)``
    (tests) may break the program before the window; ``control`` adds the
    reference in TF32, judged as the program is, under ``"control"``.
    """
    import torch

    from bench import program
    from bench.gen.graph import powerlaw_graph, seed_sequence, snapshot_split
    from bench.gen.stream import ChurnStream
    from bench.reference.compare import judge, readings
    from bench.work.formulas import reached_rows

    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, cfg, traffic = load_cell(name, root)
    cfg = {**cfg, **(overrides or {}).get("config", {})}
    traffic = {**traffic, **(overrides or {}).get("traffic", {})}
    if cfg.get("dtype", "float32") != "float32" or cfg.get("tf32", False):
        raise ValueError("this harness runs fp32 with TF32 off")
    if traffic.get("loop", "closed") != "closed" \
            or traffic.get("clients", 1) != 1:
        raise ValueError("this harness drives one closed-loop client")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = importlib.import_module(f"bench.reference.{cfg['reference']}")
    dims = dims_of(cfg)
    n = cfg["n_vertices"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # ---- inputs: the model's from the configuration, the stream's from
    # the run's seed, so every seed runs the same graph and weights --------
    t_enter = time.perf_counter()
    s_graph, s_split, s_torch, s_warm = \
        seed_sequence(cfg["inputs_seed"]).spawn(4)
    src, dst = powerlaw_graph(n, cfg["n_edges"],
                              np.random.default_rng(s_graph),
                              cfg["degree_exponent"])
    snap, hold = snapshot_split(src, dst, cfg["holdout_frac"],
                                np.random.default_rng(s_split))
    t_graph = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s_torch.generate_state(1, np.uint64)[0]))
    x = torch.randn((n, cfg["d_in"]), generator=gen, device=device)
    weights = make_weights(ref.param_shapes(dims), gen, device)
    x_np = x.cpu().numpy()
    del x, src, dst

    # ---- the program's session, warmed on the cell's traffic -------------
    t_inputs = time.perf_counter()
    program.load()
    t_load = time.perf_counter()
    session = program.build_session(cfg, weights, x_np, *snap, device)
    t_session = time.perf_counter()
    stream = ChurnStream(n, snap, hold, x_np.copy(), traffic,
                         np.random.default_rng(s_warm))
    del snap, hold, x_np
    if tamper is not None:
        tamper(session)
    warm, calm, last = 0, 0, program.counters(session)["retries"]
    while warm < WARMUP_MAX and (warm < WARMUP_MIN or calm < SETTLE):
        b = stream.next_batch()
        session.apply_one(program.to_update_batch(b))
        stream.commit(b)
        warm += 1
        now = program.counters(session)["retries"]
        calm, last = (calm + 1 if now == last else 0), now
    sync()
    _log(f"set-up s: start and imports {t_enter - t_start:.2f}, graph "
         f"{t_graph - t_enter:.2f}, device inputs (CUDA start) "
         f"{t_inputs - t_graph:.2f}, program import {t_load - t_inputs:.2f}, "
         f"session {t_session - t_load:.2f}, warm-up "
         f"{time.perf_counter() - t_session:.2f} ({warm} batches, "
         f"settled: {calm >= SETTLE})")
    stream.rng = np.random.default_rng(seed_sequence(seed))

    # ---- the window ------------------------------------------------------
    before = program.counters(session)
    setup_s = time.perf_counter() - t_start
    win = _window(session, stream, seconds, trace)
    sync()
    torch.backends.cuda.matmul.allow_tf32 = False   # whatever ``tamper`` set
    failed = win["failed"]
    after = program.counters(session) if not failed else before
    lat = np.array(win["lat"]) * 1e3
    if lat.size:
        q = np.percentile(lat, [50, 90, 99, 100])
        _log(f"batches {lat.size}, latency ms p50 {q[0]:.2f} p90 {q[1]:.2f} "
             f"p99 {q[2]:.2f} max {q[3]:.2f}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # ---- read back, free, and check against the reference ----------------
    checks, control_vals = {}, None
    limits = cfg["limits"]
    if not failed:
        H_got, q_got = program.outputs(session)
    del session
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if not failed:
        e_src, e_dst = (torch.as_tensor(a.copy(), device=device)
                        for a in stream.edges)
        x_fin = torch.as_tensor(stream.x, device=device)
        reached = reached_rows(n, *stream.edges, win["batches"],
                               len(dims) - 1, cfg["self_dependent"])
        H_ref = ref.forward(x_fin, e_src, e_dst, weights)
        checks = readings(H_got, q_got, H_ref, reached)
        _log("rows reached a layer:", reached.sum(axis=1).tolist(), "of", n)
        if control:
            H_c = ref.forward(x_fin, e_src, e_dst, weights, tf32=True)
            control_vals = readings(H_c, H_c[-1], H_ref, reached)
            del H_c
        del H_ref, H_got, q_got, e_src, e_dst, x_fin
        if device == "cuda":
            torch.cuda.empty_cache()

    # ---- the result line -------------------------------------------------
    metrics = {}
    result = {"correct": (not failed) and judge(checks, limits),
              "attempted": win["started"], "failed": failed}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(peak)} \
        if device == "cuda" else {"platform": "cpu", "kind": "cpu",
                                  "count": 1, "memory_peak_bytes": 0}
    if not trace:
        metrics["updates_per_s"] = {"value": win["updates"] / seconds,
                                    "unit": "updates/s"}
        metrics["batch_p95_ms"] = {
            "value": float(np.percentile(lat, 95)) if lat.size else BIG,
            "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    elif not failed:
        from bench.trace import Trace
        tr = Trace.from_profile(win.pop("prof"))
        e_src, e_dst = stream.edges
        ctx = ReadContext(trace=tr, cfg=cfg, dims=dims,
                          batches=win["batches"],
                          counters=program.counter_delta(before, after),
                          n=n, final_src=e_src.copy(), final_dst=e_dst.copy())
        for m in manifest["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = load_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        _log("host ms in spans:", json.dumps(tr.span_ms()))
        _log("window batches:", len(win["batches"]), "counters:",
             json.dumps(ctx.counters, default=lambda a: np.asarray(a)
                        .tolist()))
    result["metrics"] = metrics
    result["device"] = dev
    result["warmup_batches"] = warm
    if control_vals is not None:
        result["control"] = {k: _finite(v) for k, v in control_vals.items()}
    result["checks"] = {k: {"value": _finite(checks.get(k, math.inf)),
                            "limit": limits[k]} for k in limits}
    return result
