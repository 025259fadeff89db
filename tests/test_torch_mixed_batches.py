"""Batches that mix a transient edge (added and deleted again) with a plain
delete of a stored edge, on the port's engines that net each edge's
change (``DynamicGraph.net_topology``): ``ripple``, ``rc`` and ``device``
on the max-based and bounded workloads, held to the port's full-inference
oracle at atol/rtol 2e-3.  The hypothesis search mirrors the reference's
tests/test_engine_equivalence.py::test_property_incremental_exactness,
with update ids drawn from three vertices so that such batches come up;
it is derandomized, so every run draws the same examples.  Everything
runs on the CPU."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.core import RippleEngine
from repro_torch.core.full import full_inference
from repro_torch.core.graph import (DynamicGraph, EdgeUpdate, FeatureUpdate,
                                    UpdateBatch, erdos_renyi)
from repro_torch.core.state import InferenceState, params_to_numpy
from repro_torch.core.workloads import WORKLOAD_NAMES, make_workload

TOL = dict(atol=2e-3, rtol=2e-3)
HOT = 3            # update ids are drawn from vertices 0..HOT-1


def _oracle(wl, params, g, x):
    H, _ = full_inference(wl, params, torch.as_tensor(x), *g.coo(),
                          g.in_degree)
    return [h.numpy() for h in H]


def _assert_exact(state, H_ref, label):
    for l, (h, href) in enumerate(zip(state.H, H_ref)):
        np.testing.assert_allclose(h, href, **TOL,
                                   err_msg=f"{label} layer {l}")


def test_net_topology_keeps_a_plain_delete_beside_a_transient_edge():
    g = DynamicGraph(4, np.array([1]), np.array([0]),
                     np.array([1.5], dtype=np.float32))
    adds, dels = g.net_topology(*g.apply_topology(
        [EdgeUpdate(2, 3, True), EdgeUpdate(2, 3, False),
         EdgeUpdate(1, 0, False)]))
    assert adds == []
    assert [(e.src, e.dst, e.weight) for e in dels] == [(1, 0, 1.5)]
    assert not g.has_edge(1, 0) and not g.has_edge(2, 3)


@pytest.mark.parametrize("name", ["gs-max", "gc-min", "ga-s", "gp-m"])
@pytest.mark.parametrize("engine,pull", [("ripple", None), ("rc", None),
                                         ("device", "rows"),
                                         ("device", "pairs")])
def test_transient_edge_beside_a_plain_delete(name, engine, pull):
    """``[add(2,3), del(2,3), del(1,0)]`` with ``1 -> 0`` stored and
    ``2 -> 3`` absent: the batch deletes ``1 -> 0`` and nothing else.  The
    device engine runs in both pull regimes of its monotonic SHRINK (the
    bounded hop has one)."""
    s = InferenceSession.build(SessionConfig(
        workload=name, engine=engine, graph="er", n=40, m=170, d_in=8,
        d_hidden=12, n_classes=5, seed=0, device="cpu"))
    if pull is not None:
        s.engine.impl.pull = pull
    g = s.graph
    setup = []
    if not g.has_edge(1, 0):
        setup.append(EdgeUpdate(1, 0, True, 0.5))
    if g.has_edge(2, 3):
        setup.append(EdgeUpdate(2, 3, False))
    if setup:
        s.ingest(UpdateBatch(edges=setup))
    edges_before = g.num_edges
    s.ingest(UpdateBatch(edges=[EdgeUpdate(2, 3, True),
                                EdgeUpdate(2, 3, False),
                                EdgeUpdate(1, 0, False)]))
    assert g.num_edges == edges_before - 1
    assert not g.has_edge(1, 0) and not g.has_edge(2, 3)
    st_ = s.sync()
    H_ref = _oracle(s.workload, s.params, g, st_.H[0])
    _assert_exact(st_, H_ref, f"{name}/{engine}")
    np.testing.assert_allclose(s.query(), H_ref[-1], **TOL)


def _is_mixed(g: DynamicGraph, edges: list[EdgeUpdate]) -> bool:
    """True when ``edges``, about to be applied to ``g``, effectively add
    and delete one edge and also effectively delete another."""
    present = {(u, v) for u in range(HOT) for v in range(HOT)
               if g.has_edge(u, v)}
    added, deleted = set(), set()
    for e in edges:
        k = (e.src, e.dst)
        if e.add and k not in present:
            present.add(k)
            added.add(k)
        elif not e.add and k in present:
            present.remove(k)
            deleted.add(k)
    return bool(added & deleted) and bool(deleted - added)


PAIRS = [(u, v) for u in range(HOT) for v in range(HOT) if u != v]
STORED = [(u, v) for u, v in PAIRS if u > v]    # stored at the start
ABSENT = [(u, v) for u, v in PAIRS if u < v]    # absent at the start


@st.composite
def _update_sequences(draw):
    """The reference's strategy with ids from the hot vertices: each op is
    (kind, u, v, weight), kind 0 adds u -> v, 1 deletes it, 2 sets u's
    features to ``weight``.  A batch may open with a transient edge and
    the delete of another edge, an edge absent and one stored at the
    start, so that mixed batches come up often."""
    n = draw(st.integers(8, 24))
    op = st.tuples(st.integers(0, 2), st.sampled_from(PAIRS),
                   st.floats(0.1, 1.0)).map(
        lambda t: (t[0], t[1][0], t[1][1], t[2]))
    batches = []
    for _ in range(draw(st.integers(1, 3))):
        ops = draw(st.lists(op, min_size=1, max_size=6))
        if draw(st.booleans()):
            (a, b), (c, d) = (draw(st.sampled_from(ABSENT)),
                              draw(st.sampled_from(STORED)))
            ops = [(0, a, b, 0.5), (1, a, b, 0.5), (1, c, d, 0.5)] + ops
        batches.append(ops)
    return n, batches


def test_property_incremental_exactness_hot_ids():
    """The reference's property search on the port's ``ripple`` engine,
    every workload, with the hot vertices' edges ``STORED`` and ``ABSENT``
    at the start."""
    mixed = []

    @settings(max_examples=60, deadline=None, derandomize=True,
              database=None)
    @given(data=_update_sequences(), name=st.sampled_from(WORKLOAD_NAMES))
    def search(data, name):
        n, batches = data
        wl = make_workload(name, n_layers=2, d_in=6, d_hidden=8, n_classes=4)
        src, dst, w = erdos_renyi(n, 3 * n, seed=1, weighted=wl.spec.weighted)
        g = DynamicGraph(n, src, dst, w)
        for u, v in STORED:
            if not g.has_edge(u, v):
                g.add_edge(u, v, 1.0)
        for u, v in ABSENT:
            if g.has_edge(u, v):
                g.delete_edge(u, v)
        x = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
        params = wl.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
        state = InferenceState.bootstrap(wl, params, x, g, device="cpu")
        eng = RippleEngine(wl, params_to_numpy(params), g, state)
        for ops in batches:
            batch = UpdateBatch()
            for kind, u, v, weight in ops:
                if kind == 0:
                    batch.edges.append(EdgeUpdate(u, v, True, weight))
                elif kind == 1:
                    batch.edges.append(EdgeUpdate(u, v, False))
                else:
                    batch.features.append(FeatureUpdate(
                        u, np.full(6, weight, dtype=np.float32)))
            if _is_mixed(g, batch.edges):
                mixed.append(name)
            eng.apply_batch(batch)
            _assert_exact(state, _oracle(wl, params, g, state.H[0]), name)

    search()
    assert {"gs-max", "gc-min", "ga-s", "gp-m"} & set(mixed), mixed
