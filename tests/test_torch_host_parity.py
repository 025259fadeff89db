"""Session-level parity of every engine with the reference, batch by
batch, on all nine workloads (ROADMAP.md Queue 3 item 4).

Each package bootstraps with its own full pass, and the two differ by a
few ulps.  Host ``ripple`` passes a max/min (or bounded) row on to the
next hop only when its embedding changed bit for bit, so a row recomputed
one ulp away from its bootstrap bits in one package, and not in the
other, propagates in one package only.  So:

- from each package's own bootstrap, and from the reference's bootstrap
  bits copied into the port's state, values are held to 2e-3 and the
  predictions must be equal;
- from the reference's bootstrap bits, the host engines' (``ripple``,
  ``rc``, ``vertexwise``, ``full``: NumPy updates in both packages) batch
  ``affected`` ids and ``affected_per_hop`` must be equal;
- the ``device`` engines recompute rows with their own package's
  arithmetic (torch in the port, XLA in the reference), the same as their
  own full pass, so their ids are held equal from each package's own
  bootstrap (from the reference's bits the port's device engine sees the
  same one-ulp recomputations on max/min).

Shapes: ``powerlaw_graph(150, 900, seed)``, 20% held out, 3 layers
8 -> 12 -> 5, ``make_stream(120, seed=seed+1, skew=1.0, mix=(2, 2, 1))``
in batches of 24, seeds 0-2.
"""
import functools

import numpy as np
import pytest

import jax

from repro.api import InferenceSession as RefSession
from repro.core import DynamicGraph as RefGraph
from repro.core import InferenceState as RefState
from repro.core import make_workload, params_to_numpy, powerlaw_graph
from repro.data.streams import snapshot_split

import repro_torch.core.graph as tgraph
from repro_torch.api import InferenceSession
from repro_torch.core.state import InferenceState
from repro_torch.core.workloads import WORKLOAD_NAMES
from repro_torch.core.workloads import make_workload as t_make_workload
from repro_torch.core.workloads import params_from_numpy

ATOL = RTOL = 2e-3
N, M, BATCH, N_UPDATES = 150, 900, 24, 120
DIMS = dict(n_layers=3, d_in=8, d_hidden=12, n_classes=5)
ENGINES = ("ripple", "rc", "vertexwise", "full", "device")


@functools.cache
def _setup(name: str, seed: int):
    """Workloads, params, the snapshot split, features and both packages'
    bootstrap states for one (workload, seed); callers clone the states."""
    wl = make_workload(name, **DIMS)
    params = wl.init_params(jax.random.PRNGKey(seed))
    src, dst, w = powerlaw_graph(N, M, seed=seed, weighted=wl.spec.weighted)
    snap, hold = snapshot_split(src, dst, w, 0.2, seed=seed)
    x = np.random.default_rng(seed).normal(size=(N, DIMS["d_in"])) \
        .astype(np.float32)
    ref_state = RefState.bootstrap(wl, params, x, RefGraph(N, *snap))
    twl = t_make_workload(name, **DIMS)
    tparams = params_from_numpy(twl, params_to_numpy(params), "cpu")
    t_state = InferenceState.bootstrap(twl, tparams, x,
                                       tgraph.DynamicGraph(N, *snap),
                                       device="cpu")
    return wl, params, twl, tparams, snap, hold, ref_state, t_state


def _ref_bits(st) -> InferenceState:
    """The reference's bootstrap state as a port state, bit for bit."""
    copy = [np.array(a, copy=True) for a in st.H]
    return InferenceState(
        H=copy, S=[np.array(s, copy=True) for s in st.S],
        k=np.array(st.k, copy=True),
        C=None if st.C is None else [np.array(c, copy=True) for c in st.C],
        A=None if st.A is None else [{nm: np.array(v, copy=True)
                                      for nm, v in a.items()} for a in st.A],
        eps=None if st.eps is None else np.array(st.eps, copy=True))


def _run(name, engine, seed, port_state):
    wl, params, twl, tparams, snap, hold, ref_state, _ = _setup(name, seed)
    ref = RefSession(wl, params, RefGraph(N, *snap), ref_state.clone(),
                     engine, holdout=hold)
    port = InferenceSession(twl, tparams, tgraph.DynamicGraph(N, *snap),
                            port_state, engine, device="cpu", holdout=hold)
    stream = dict(seed=seed + 1, skew=1.0, mix=(2, 2, 1))
    r1 = ref.ingest(ref.make_stream(N_UPDATES, **stream), batch_size=BATCH)
    r2 = port.ingest(port.make_stream(N_UPDATES, **stream), batch_size=BATCH)
    assert r1.n_batches == r2.n_batches == N_UPDATES // BATCH
    return ref, port, r1, r2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_session_parity_from_own_bootstraps(name, engine, seed):
    t_state = _setup(name, seed)[-1]
    ref, port, r1, r2 = _run(name, engine, seed, t_state.clone())
    _assert_close(ref, port)
    if engine == "device":
        _assert_same_ids(r1, r2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_affected_ids_from_reference_bootstrap_bits(name, engine, seed):
    ref_state = _setup(name, seed)[-2]
    ref, port, r1, r2 = _run(name, engine, seed, _ref_bits(ref_state))
    _assert_close(ref, port)
    if engine != "device":
        _assert_same_ids(r1, r2)


def _assert_close(ref, port):
    np.testing.assert_allclose(port.query(), ref.query(), atol=ATOL,
                               rtol=RTOL)
    for l, (h, href) in enumerate(zip(port.sync().H, ref.sync().H)):
        np.testing.assert_allclose(h, href, atol=ATOL, rtol=RTOL,
                                   err_msg=f"layer {l}")
    np.testing.assert_array_equal(port.predict(), ref.predict())


def _assert_same_ids(r1, r2):
    for i, (a, b) in enumerate(zip(r1.results, r2.results)):
        np.testing.assert_array_equal(b.affected, a.affected,
                                      err_msg=f"batch {i}")
        assert list(b.affected_per_hop) == list(a.affected_per_hop), \
            f"batch {i}"
