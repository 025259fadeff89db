"""The port's serving API on the CPU: ``bootstrap -> ingest -> query /
predict`` against the JAX package's session on the same graph, weights
and stream, hot swap device <-> full, and the registry surface (the host
engines' sessions are in tests/test_torch_host_oracle.py)."""
import numpy as np
import pytest

import jax
import torch

from repro.api import InferenceSession as RefSession
from repro.api import engine_names as ref_engine_names
from repro.api import engine_options as ref_engine_options
from repro.core import (DynamicGraph, erdos_renyi, make_workload,
                        params_to_numpy)
from repro.data.streams import snapshot_split

import repro_torch.core.graph as tgraph
from repro_torch.api import (InferenceSession, SessionConfig, engine_names,
                             engine_options, make_engine)
from repro_torch.core.full import full_inference
from repro_torch.core.workloads import INVERTIBLE_WORKLOAD_NAMES
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy

ATOL = 2e-3


def _pair(name, engine="device", n=60, m=260):
    """A JAX session and a port session over the same graph, held-out
    split, features and weights."""
    wl = make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    params = wl.init_params(jax.random.PRNGKey(0))
    src, dst, w = erdos_renyi(n, m, seed=0, weighted=wl.spec.weighted)
    snap, hold = snapshot_split(src, dst, w, 0.1, seed=0)
    x = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    ref = RefSession.bootstrap(wl, params, x, DynamicGraph(n, *snap),
                               engine, holdout=hold)
    twl = t_make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    port = InferenceSession.bootstrap(
        twl, params_from_numpy(twl, params_to_numpy(params), "cpu"), x,
        tgraph.DynamicGraph(n, *snap), engine, device="cpu", holdout=hold)
    return ref, port


def _assert_oracle(s):
    st = s.sync()
    H, _ = full_inference(s.workload, s.params, torch.as_tensor(st.H[0]),
                          *s.graph.coo(), s.graph.in_degree)
    for l, (h, href) in enumerate(zip(st.H, H)):
        np.testing.assert_allclose(h, href.numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=f"layer {l}")
    np.testing.assert_allclose(s.query(), H[-1].numpy(), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
def test_session_matches_reference(name):
    ref, port = _pair(name)
    stream, tstream = ref.make_stream(30, seed=1), port.make_stream(30,
                                                                    seed=1)
    assert len(stream) == len(tstream) == 30
    r1 = ref.ingest(stream, batch_size=6)
    r2 = port.ingest(tstream, batch_size=6)
    assert r2.n_batches == r1.n_batches == 5
    for a, b in zip(r1.results, r2.results):
        np.testing.assert_array_equal(b.affected, a.affected)
    np.testing.assert_allclose(port.query(), ref.query(), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(port.predict(), ref.predict())
    sub = np.array([3, 0, 17])
    np.testing.assert_allclose(port.query(sub), ref.query(sub), atol=ATOL,
                               rtol=ATOL)
    _assert_oracle(port)


def test_swap_engine_device_full_device():
    ref, port = _pair("gs-s")
    stream, tstream = ref.make_stream(36, seed=2), port.make_stream(36,
                                                                    seed=2)
    flat, tflat = list(stream.updates), list(tstream.updates)
    ref.ingest(flat[:12], batch_size=6)
    port.ingest(tflat[:12], batch_size=6)
    for name in ("full", "device"):
        ref.swap_engine(name)
        port.swap_engine(name)
        assert port.engine_name == name
        i = 12 if name == "full" else 24
        ref.ingest(flat[i:i + 12], batch_size=6)
        port.ingest(tflat[i:i + 12], batch_size=6)
        _assert_oracle(port)
        np.testing.assert_allclose(port.query(), ref.query(), atol=ATOL,
                                   rtol=ATOL)


def test_build_and_deadline_on_cpu():
    s = InferenceSession.build(SessionConfig(
        workload="gi-s", engine="device", graph="er", n=50, m=220, d_in=8,
        d_hidden=12, n_classes=5, device="cpu"))
    stream = s.make_stream(40, seed=1)
    report = s.ingest(stream, batch_size=16, deadline_ms=1e-6)
    assert report.final_batch_size == 1
    assert report.n_updates == len(stream) and report.n_batches > 40 // 16
    _assert_oracle(s)
    with pytest.raises(IndexError):
        s.query([s.graph.n])


def test_registry_surface_matches_reference(tmp_path):
    assert engine_names() == ref_engine_names()
    assert engine_names(canonical_only=False) \
        == ref_engine_names(canonical_only=False)
    assert set(engine_options("device")) \
        == set(ref_engine_options("device")) | {"device"}
    for name in ("ripple", "rc"):
        assert set(engine_options(name)) == set(ref_engine_options(name))
    assert set(engine_options("vertexwise")) \
        == set(ref_engine_options("vertexwise")) | {"device"}
    wl = t_make_workload("gc-s", n_layers=2, d_in=4, d_hidden=4, n_classes=2)
    with pytest.raises(KeyError, match="device"):
        make_engine("nope", wl, [], None, None)
    with pytest.raises(TypeError, match="does not accept"):
        make_engine("full", wl, [], None, None, mesh=object())
    for name in ("dist", "dist-rc"):
        assert set(engine_options(name)) == set(ref_engine_options(name))
        with pytest.raises(TypeError, match="does not accept"):
            make_engine(name, wl, [], None, None, tolerance=0.0)
    s = InferenceSession.build(SessionConfig(
        ckpt_dir=str(tmp_path), n=40, m=160, d_in=4, d_hidden=4,
        n_classes=2, device="cpu"))
    assert s.journal.next_id == s.step == 0
    assert (tmp_path / "updates.jsonl").exists()


def test_stream_cli_on_cpu(capsys):
    from repro_torch.launch.stream import main
    main(["--device", "cpu", "--workload", "gc-m", "--n", "80", "--m", "320",
          "--updates", "40", "--batch-size", "10"])
    out = capsys.readouterr().out
    assert "engine=device" in out and "device=cpu" in out \
        and "updates=40" in out
