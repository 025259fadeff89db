"""The PyTorch port's foundations against the JAX package: graph and
stream generators, bootstrap, weight transfer, and the port's isolation
from JAX."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from repro.core import (DynamicGraph, InferenceState, erdos_renyi,
                        make_workload, params_to_numpy, powerlaw_graph)
from repro.data.streams import make_stream, snapshot_split
from repro.serve.scheduler import LatencyModel

import repro_torch.core.graph as tgraph
import repro_torch.data.streams as tstreams
from repro_torch.core.state import InferenceState as TState
from repro_torch.core.state import params_to_numpy as t_params_to_numpy
from repro_torch.core.workloads import (INVERTIBLE_WORKLOAD_NAMES,
                                        WORKLOAD_NAMES, params_from_numpy)
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.serve.scheduler import LatencyModel as TLatencyModel

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-3


def _updates(stream):
    """An update stream as plain tuples (comparable across packages)."""
    out = []
    for u in stream.updates:
        if hasattr(u, "vertex"):
            out.append(("f", u.vertex, tuple(np.asarray(u.value).tolist())))
        else:
            out.append(("e", u.src, u.dst, u.add, u.weight))
    return out


@pytest.mark.parametrize("gen", ["er", "powerlaw"])
@pytest.mark.parametrize("weighted", [False, True])
def test_graph_and_stream_identical(gen, weighted):
    ref_gen, port_gen = {"er": (erdos_renyi, tgraph.erdos_renyi),
                         "powerlaw": (powerlaw_graph,
                                      tgraph.powerlaw_graph)}[gen]
    arrays = ref_gen(300, 1500, seed=3, weighted=weighted)
    for a, b in zip(arrays, port_gen(300, 1500, seed=3, weighted=weighted)):
        np.testing.assert_array_equal(a, b)
    snap, hold = snapshot_split(*arrays, 0.1, seed=3)
    tsnap, thold = tstreams.snapshot_split(*arrays, 0.1, seed=3)
    for a, b in zip(snap + hold, tsnap + thold):
        np.testing.assert_array_equal(a, b)
    g, tg = DynamicGraph(300, *snap), tgraph.DynamicGraph(300, *tsnap)
    for a, b in zip(g.coo(), tg.coo()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.in_degree, tg.in_degree)
    for kw in ({}, {"mix": (1, 4, 1), "skew": 1.1},
               {"skew": 0.8, "feature_target": "in_degree"}):
        s = make_stream(g, hold, 60, 8, seed=1, **kw)
        ts = tstreams.make_stream(tg, thold, 60, 8, seed=1, **kw)
        assert _updates(s) == _updates(ts)


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
@pytest.mark.parametrize("n_layers", [2, 3])
def test_bootstrap_matches_reference(name, n_layers):
    wl = make_workload(name, n_layers=n_layers, d_in=8, d_hidden=16,
                       n_classes=5)
    src, dst, w = erdos_renyi(120, 600, seed=2, weighted=wl.spec.weighted)
    x = np.random.default_rng(4).normal(size=(120, 8)).astype(np.float32)
    params = wl.init_params(jax.random.PRNGKey(1))
    ref = InferenceState.bootstrap(wl, params, x, DynamicGraph(120, src, dst,
                                                               w))
    twl = t_make_workload(name, n_layers=n_layers, d_in=8, d_hidden=16,
                          n_classes=5)
    tparams = params_from_numpy(twl, params_to_numpy(params), "cpu")
    got = TState.bootstrap(twl, tparams, x,
                           tgraph.DynamicGraph(120, src, dst, w),
                           device="cpu")
    for l, (a, b) in enumerate(zip(ref.H, got.H)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=ATOL,
                                   err_msg=f"H[{l}]")
    for l, (a, b) in enumerate(zip(ref.S[1:], got.S[1:]), start=1):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=ATOL,
                                   err_msg=f"S[{l}]")
    np.testing.assert_array_equal(got.k, ref.k)


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
def test_params_round_trip(name):
    wl = make_workload(name, n_layers=2, d_in=6, d_hidden=10, n_classes=3)
    p_np = params_to_numpy(wl.init_params(jax.random.PRNGKey(7)))
    twl = t_make_workload(name, n_layers=2, d_in=6, d_hidden=10, n_classes=3)
    back = t_params_to_numpy(params_from_numpy(twl, p_np, "cpu"))
    assert [sorted(p) for p in back] == [sorted(p) for p in p_np]
    for p, q in zip(p_np, back):
        for key in p:
            np.testing.assert_array_equal(q[key], p[key])
    # the port's own generator draws layers of the same shapes
    own = twl.init_params(torch.Generator().manual_seed(0), device="cpu")
    for layer, p in zip(own, p_np):
        assert {k: tuple(v.shape) for k, v in layer.named_parameters()} \
            == {k: v.shape for k, v in p.items()}
    bad = [dict(p_np[0], w_extra=np.zeros(1))] + p_np[1:]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(twl, bad, "cpu")


def test_unported_workloads_and_aggregators_raise():
    """Every workload name of the reference and every aggregator name
    constructs in the port; only an unknown name raises (KeyError)."""
    from repro.core.aggregators import AGGREGATOR_NAMES
    from repro_torch.core.aggregators import AGGREGATORS, get_aggregator
    assert len(WORKLOAD_NAMES) == 9
    for name in WORKLOAD_NAMES:
        wl = t_make_workload(name)
        assert wl.spec.name == name and wl.agg is get_aggregator(
            wl.spec.aggregator)
    assert tuple(AGGREGATORS) == AGGREGATOR_NAMES
    for agg in AGGREGATOR_NAMES:
        assert get_aggregator(agg).name == agg
    for bad in ("median", "gc-median"):
        with pytest.raises(KeyError):
            get_aggregator(bad)
        with pytest.raises(KeyError):
            t_make_workload(bad)


def test_cuda_request_without_card_fails():
    from repro_torch.utils import resolve_device
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_latency_model_matches_reference():
    ref, port = LatencyModel(), TLatencyModel()
    for bs, s in ((10, 0.002), (40, 0.005), (25, 0.0031), (80, 0.011)):
        ref.observe(bs, s)
        port.observe(bs, s)
        assert port.batch_for(0.008, hi=200) == ref.batch_for(0.008, hi=200)
    assert port.a == pytest.approx(ref.a) and port.b == pytest.approx(ref.b)


_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch, repro_torch.api, repro_torch.launch.stream
import repro_torch.core.device_engine
import repro_torch.kernels.delta_apply, repro_torch.kernels.mlp_apply
import repro_torch.kernels.extremum_apply, repro_torch.kernels.embedding_bag
import repro_torch.kernels.segment_mm, repro_torch.core.engine
import repro_torch.core.vertexwise
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m in ("jax", "repro") or m.startswith(("jax.", "repro.")))]
assert not bad, bad
print("clean")
"""


def test_import_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)",
                        re.MULTILINE)


def test_port_sources_never_import_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT_RE.search(f.read_text())]
    assert not offenders, offenders
