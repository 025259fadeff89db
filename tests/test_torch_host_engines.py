"""The port's host engines (``ripple``, ``rc``, ``vertexwise``) against the
JAX package's, and the port's ``full`` engine against the reference's.

The host engines are NumPy on both sides, so from one starting state, with
the same NumPy parameters and the same stream, every batch must agree bit
for bit: each ``BatchStats`` field, the final affected ids, and H, S, k, C,
A and eps (``np.array_equal``).  The starting state is bootstrapped once by
the port's full pass on the CPU and copied for each side.  The one
deliberate difference, ``deferral_budgets`` with two or more interior
layers (ROADMAP.md Queue 3), is kept out by running approximate mode with
two layers.  The ``full`` engine runs a float pass on each side and is held
per batch at 2e-3."""
import numpy as np
import pytest

import jax

import repro.core.graph as rgraph
from repro.api import InferenceSession as RefSession
from repro.core import InferenceState as RefState
from repro.core import RecomputeEngine as RefRecompute
from repro.core import RippleEngine as RefRipple
from repro.core import make_workload as ref_make_workload
from repro.core import params_to_numpy
from repro.core.vertexwise import VertexWiseEngine as RefVertexWise
from repro.core.workloads import Workload as RefWorkload
from repro.core.workloads import WorkloadSpec as RefWorkloadSpec

import repro_torch.core.graph as tgraph
from repro_torch.api import InferenceSession
from repro_torch.core import RecomputeEngine, RippleEngine
from repro_torch.core.state import InferenceState
from repro_torch.core.vertexwise import VertexWiseEngine
from repro_torch.core.workloads import (BOUNDED_WORKLOAD_NAMES,
                                        WORKLOAD_NAMES, Workload,
                                        WorkloadSpec, make_workload,
                                        params_from_numpy)
from repro_torch.data.streams import make_stream, snapshot_split

ATOL = 2e-3
STATS = ("affected_per_hop", "messages_per_hop", "numeric_ops",
         "shrink_events", "rows_reaggregated", "dims_reaggregated",
         "recover_hits", "patch_events", "bound_violations", "deferred_rows")
ENGINES = {"ripple": (RefRipple, RippleEngine),
           "rc": (RefRecompute, RecomputeEngine)}


def _workloads(name, n_layers):
    """The same workload in both packages; ``topk`` is the top-k
    aggregator under GraphConv, which neither package names."""
    if name == "topk":
        dims = (8,) + (12,) * (n_layers - 1) + (5,)
        return (RefWorkload(RefWorkloadSpec("gc-topk", "topk", False,
                                            n_layers, dims), "gc"),
                Workload(WorkloadSpec("gc-topk", "topk", False, n_layers,
                                      dims), "gc"))
    kw = dict(n_layers=n_layers, d_in=8, d_hidden=12, n_classes=5)
    return ref_make_workload(name, **kw), make_workload(name, **kw)


def _setup(name, n_layers=3, n=80, m=420, seed=0):
    """Workloads, NumPy params, the snapshot graph's edges, its held-out
    edges and one bootstrapped port state."""
    rwl, twl = _workloads(name, n_layers)
    params = params_to_numpy(rwl.init_params(jax.random.PRNGKey(seed)))
    src, dst, w = tgraph.powerlaw_graph(n, m, seed=seed,
                                        weighted=twl.spec.weighted)
    snap, hold = snapshot_split(src, dst, w, 0.1, seed=seed)
    x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    state = InferenceState.bootstrap(twl, params_from_numpy(twl, params,
                                                            "cpu"),
                                     x, tgraph.DynamicGraph(n, *snap),
                                     device="cpu")
    return rwl, twl, params, snap, hold, state


def _ref_state(st):
    c = st.clone()
    return RefState(H=c.H, S=c.S, k=c.k, C=c.C, A=c.A, eps=c.eps)


def _ref_batch(batch):
    return rgraph.UpdateBatch(
        edges=[rgraph.EdgeUpdate(e.src, e.dst, e.add, e.weight)
               for e in batch.edges],
        features=[rgraph.FeatureUpdate(f.vertex, np.array(f.value))
                  for f in batch.features])


def _batches(updates, size):
    out = []
    for i in range(0, len(updates), size):
        b = tgraph.UpdateBatch()
        for u in updates[i:i + size]:
            (b.edges if isinstance(u, tgraph.EdgeUpdate)
             else b.features).append(u)
        out.append(b)
    return out


def _assert_states_equal(ref, port, label):
    for l, (a, b) in enumerate(zip(ref.H, port.H)):
        assert np.array_equal(a, b), f"{label}: H[{l}] differs"
    for l, (a, b) in enumerate(zip(ref.S, port.S)):
        assert np.array_equal(a, b), f"{label}: S[{l}] differs"
    assert np.array_equal(ref.k, port.k), f"{label}: k differs"
    assert (ref.C is None) == (port.C is None)
    if ref.C is not None:
        for l, (a, b) in enumerate(zip(ref.C, port.C)):
            assert np.array_equal(a, b), f"{label}: C[{l}] differs"
    assert (ref.A is None) == (port.A is None)
    if ref.A is not None:
        for l, (a, b) in enumerate(zip(ref.A, port.A)):
            assert a.keys() == b.keys()
            for nm in a:
                assert np.array_equal(a[nm], b[nm]), \
                    f"{label}: A[{l}][{nm}] differs"
        assert np.array_equal(ref.eps, port.eps), f"{label}: eps differs"


def _run_pair(name, engine, *, n_layers=3, tolerance=0.0, updates=None,
              batch=8):
    rwl, twl, params, snap, hold, state = _setup(name, n_layers)
    ref_cls, port_cls = ENGINES[engine]
    opts = dict(tolerance=tolerance) if tolerance else {}
    g_ref = rgraph.DynamicGraph(len(state.k), *snap)
    g_port = tgraph.DynamicGraph(len(state.k), *snap)
    ref = ref_cls(rwl, params, g_ref, _ref_state(state), **opts)
    port = port_cls(twl, params, g_port, state.clone(), **opts)
    if updates is None:
        updates = list(make_stream(g_port, hold, 48, 8, seed=1,
                                   mix=(1, 1, 2), skew=1.0,
                                   feature_target="in_degree"))
    totals = dict.fromkeys(STATS[3:], 0)
    for i, b in enumerate(_batches(updates, batch)):
        a = ref.apply_batch(_ref_batch(b))
        p = port.apply_batch(b)
        label = f"{name}/{engine} batch {i}"
        for f in STATS:
            assert getattr(p, f) == getattr(a, f), f"{label}: {f}"
        np.testing.assert_array_equal(p.final_affected, a.final_affected)
        _assert_states_equal(ref.state, port.state, label)
        for f in totals:
            totals[f] += getattr(p, f)
    np.testing.assert_array_equal(np.stack(g_port.coo()),
                                  np.stack(g_ref.coo()))
    assert np.array_equal(port.error_bound(), ref.error_bound())
    return totals


@pytest.mark.parametrize("name", WORKLOAD_NAMES + ("topk",))
@pytest.mark.parametrize("engine", ["ripple", "rc"])
def test_host_engine_bit_equal_to_reference(name, engine):
    totals = _run_pair(name, engine)
    if engine == "ripple" and name in ("gs-max", "gc-min"):
        assert totals["shrink_events"] > 0
    if engine == "ripple" and (name in BOUNDED_WORKLOAD_NAMES
                               or name == "topk"):
        assert totals["patch_events"] > 0
        # attention refreshes only on a collapsed normalizer, which the
        # dominant-logit case of test_torch_host_oracle.py forces
        assert totals["rows_reaggregated"] > 0 or name == "ga-s"


@pytest.mark.parametrize("name", BOUNDED_WORKLOAD_NAMES)
def test_ripple_tolerance_bit_equal_to_reference(name):
    """Approximate mode over feature jitter (the regime where interior
    changes fit a deferral budget), two layers: one interior layer, where
    the port's budgets are the reference's."""
    _, _, _, snap, _, state = _setup(name, n_layers=2)
    rng = np.random.default_rng(8)
    updates = []
    for _ in range(6):
        for v in rng.choice(len(state.k), size=4, replace=False):
            updates.append(tgraph.FeatureUpdate(
                int(v), state.H[0][int(v)]
                + rng.normal(0, 1e-6, size=8).astype(np.float32)))
    totals = _run_pair(name, "ripple", n_layers=2, tolerance=0.1,
                       updates=updates, batch=4)
    assert totals["deferred_rows"] > 0


@pytest.mark.parametrize("name", WORKLOAD_NAMES + ("topk",))
def test_vertexwise_bit_equal_to_reference(name):
    rwl, twl, params, snap, hold, state = _setup(name, n_layers=2, n=40,
                                                 m=150)
    g = tgraph.DynamicGraph(len(state.k), *snap)
    targets = np.arange(0, len(state.k), 3)
    port = VertexWiseEngine(twl, params, g, state.H[0])
    ref = RefVertexWise(rwl, params, rgraph.DynamicGraph(len(state.k), *snap),
                        state.H[0].copy())
    out = port.infer(targets)
    assert np.array_equal(out, ref.infer(targets))
    assert port.ops == ref.ops > 0
    np.testing.assert_allclose(out, state.H[-1][targets], atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_full_engine_matches_reference_per_batch(name):
    rwl, twl, _, snap, hold, _ = _setup(name, n_layers=2, n=60, m=260)
    params = rwl.init_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    ref = RefSession.bootstrap(rwl, params, x,
                               rgraph.DynamicGraph(60, *snap), "full",
                               holdout=hold)
    port = InferenceSession.bootstrap(
        twl, params_from_numpy(twl, params_to_numpy(params), "cpu"), x,
        tgraph.DynamicGraph(60, *snap), "full", device="cpu", holdout=hold)
    for i, batch in enumerate(_batches(port.make_stream(24, seed=1).updates,
                                       6)):
        a = ref.apply_one(_ref_batch(batch))
        b = port.apply_one(batch)
        np.testing.assert_array_equal(b.affected, a.affected)
        assert b.numeric_ops == a.numeric_ops
        for l, (h, href) in enumerate(zip(port.state.H, ref.state.H)):
            np.testing.assert_allclose(h, href, atol=ATOL, rtol=ATOL,
                                       err_msg=f"batch {i} layer {l}")
