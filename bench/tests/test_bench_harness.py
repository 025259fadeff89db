"""``BENCHMARK.json`` against the benchmark's format rules, the result line, the
trace reductions, the command without a card, and what a run imports."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from bench.reference import compare
from bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"config": {"n_vertices": 300, "n_edges": 1500, "d_in": 16,
                   "d_hidden": 16, "n_classes": 4}}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_manifest_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and m["command"][1] == "bench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    # 24 cells of 2 + 14 runs each, with their build time, fit in 12 hours
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "bench" / "reference"
                / f"{cfg['reference']}.py").exists()
        assert set(cfg["limits"]) <= set(compare.NAMES)
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    configs = {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    e2e = {x["name"] for x in m["end_to_end"]}
    assert e2e == {"updates_per_s", "batch_p95_ms", "setup_s"}
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
        assert x["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and UNIT.match(x["unit"])
        assert set(x.get("workloads", cells)) <= cells
        assert (ROOT / "bench" / "metrics" / f"{x['name']}.py").exists()


def test_result_line_untraced_and_traced():
    cell = "gsmax-arxiv.uniform-b100"
    r = harness.run_cell(cell, 1, 1.0, False, device="cpu", overrides=TINY)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["metrics"]) == {"updates_per_s", "batch_p95_ms", "setup_s"}
    # how many batches a loaded CPU finishes in the window varies
    assert r["metrics"]["updates_per_s"]["value"] >= 0
    assert r["metrics"]["setup_s"]["value"] > 0
    json.dumps(r)
    t = harness.run_cell(cell, 1, 1.0, True, device="cpu", overrides=TINY)
    want = {x["name"] for x in MANIFEST["per_layer"]
            if cell in x.get("workloads", [cell])}
    # no kernel launches on the CPU: the rooflines have nothing to read
    assert set(t["metrics"]) == want - {"extremum_apply_roofline"}
    assert t["device"]["window_s"] > 0 and "breakdown" in t
    assert t["metrics"]["retries_per_batch"]["unit"] == "count"


def test_trace_reductions_by_hand():
    # window [0, 100); device ops [10, 20), [15, 30), [50, 60), [95, 120)
    tr = Trace(window=(0, 100),
               spans=[("bench.batch", 8, 35), ("bench.batch", 40, 90),
                      ("DeviceEngine._route", 40, 48)],
               dev_start=np.array([10, 15, 50, 95]),
               dev_end=np.array([20, 30, 60, 120]),
               dev_name=["a", "b", "a", "c"])
    assert tr.merged.tolist() == [[10, 30], [50, 60], [95, 100]]
    assert tr.busy_s == pytest.approx(35e-9)
    assert tr.covered_ns([8, 40], [35, 90]).tolist() == [20, 10]
    assert tr.device_s(("a",)) == pytest.approx(20e-9)
    assert tr.device_s(("zzz",)) is None
    ops = tr.device_ops()
    assert [k for k, _ in ops] == ["a", "b", "c"]
    assert [v for _, v in ops] == pytest.approx([20e-9, 15e-9, 5e-9])
    # gaps [0,10) host, [30,50) route (innermost at its middle 40),
    # [60,95) batch
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"host": 10e-9, "DeviceEngine._route":
                                  20e-9, "bench.batch": 35e-9})


def _run_cli(cwd: Path):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "gsmax-arxiv.uniform-b100", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_command_fails_without_a_card_and_prints_no_result():
    p = _run_cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.harness import run_cell\n"
        f"r = run_cell('gpm-arxiv.uniform-b100', 2, 0.2, True, "
        f"device='cpu', overrides={TINY!r})\n"
        "assert r['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax_and_the_reference_no_program():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path


class _Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]


def test_trace_sorts_events_by_kind_not_name():
    evs = [_Ev("bench.window", False, 0, 100, True),
           _Ev("bench.batch", False, 10, 90, True),
           # the device range of the program's own span, named as nothing
           # the benchmark knows: covers idle time, is no operation
           _Ev("propagate_hop_1", True, 10, 90, True),
           _Ev("bench.batch", True, 10, 90, True),
           # operations, whatever they are called
           _Ev("bench.kernel_named_like_a_span", True, 20, 30),
           _Ev("void segment_max<float>(...)", True, 40, 50),
           _Ev("Memcpy DtoH (Device -> Pageable)", True, 60, 65),
           # a host op named like a span is no span
           _Ev("bench.not_an_annotation", False, 5, 95)]
    tr = Trace.from_events(evs)
    assert tr.window == (0, 100)
    assert tr.busy_s == pytest.approx(25e-9)
    assert sorted(tr.dev_name) == sorted(
        ["bench.kernel_named_like_a_span", "void segment_max<float>(...)",
         "Memcpy DtoH (Device -> Pageable)"])
    assert [s[0] for s in tr.spans] == ["bench.batch"]


def test_worst_row_over_reached_rows():
    import torch
    ref = torch.ones(4, 2)
    got = ref.clone()
    got[0, 0] += 1e-3      # a row the window did not reach
    got[2, 1] += 1e-5      # a reached row
    reached = torch.tensor([False, True, True, False])
    assert compare.row_rel_err(got, ref) == pytest.approx(1e-3, rel=1e-3)
    assert compare.row_rel_err(got, ref, reached) == pytest.approx(
        1e-5, rel=1e-2)
    assert compare.row_rel_err(got, ref, torch.zeros(4, dtype=bool)) == 0.0
    H = [ref, got, got]
    r = compare.readings(H, got, [ref, ref, ref],
                         np.array([[False, True, True, False]] * 2))
    assert r["h_err"] > 1e-4 > r["h_err_reached"]
