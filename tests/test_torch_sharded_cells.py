"""The GNN and DLRM-RM2 cells' DTensor paths (``models/gnn/sharded.py``,
``kernels/embedding_bag/sharding.py``, ``models/recsys/dlrm.py``'s per-shard
pair pick) computed on real tensors over four gloo ranks, held against the
plain model.

The dry-run traces these paths on fake tensors, where nothing checks the
numbers; here tests/torch_sharded_cells_ranks.py runs the cells' own
functions on a 2 x 2 ``("data", "model")`` mesh, their arguments real fp32
tensors laid out by the cells' specs: each GNN's train step on a padded
graph whose rows are split over all four ranks (gathers by global ids,
scatter-sums and PNA's scatter-max across ranks, with a duplicated edge
whose tied maxima share the gradient), SchNet's graph-level loss, DLRM's
train, serve and retrieval with ids on both ends of both model ranks'
blocks of every table, and the row-sharded bag with three lanes a bag and
a padding id.  Each output is compared with the same function on plain
tensors in the same process: |sharded - plain| <= 1e-4 |plain| + 1e-4
max|plain| elementwise (fp32 sums in another order).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharded_cells_ranks as tsc  # noqa: E402

from repro_torch.configs.dlrm_rm2 import SMOKE_CONFIG  # noqa: E402

RUNNER = os.path.join(os.path.dirname(__file__),
                      "torch_sharded_cells_ranks.py")
RTOL = 1e-4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("sharded_cells"))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, RUNNER, str(r),
                               str(tsc.WORLD), run_dir], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(tsc.WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"--- rank {i} (rc {p.returncode}):\n{out[-3000:]}"
              for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return dict(np.load(os.path.join(run_dir, "port.npz")))


def _held(port, prefix: str) -> list:
    """Every ``<prefix>plain/<name>`` against ``<prefix>sharded/<name>``;
    returns the names."""
    names = [k[len(prefix) + 6:] for k in port
             if k.startswith(prefix + "plain/")]
    assert names
    for name in names:
        plain = port[f"{prefix}plain/{name}"]
        sharded = port[f"{prefix}sharded/{name}"]
        assert sharded.shape == plain.shape, name
        assert np.isfinite(sharded).all(), name
        atol = RTOL * float(np.abs(plain).max()) if plain.size else 0.0
        np.testing.assert_allclose(sharded, plain, rtol=RTOL, atol=atol,
                                   err_msg=prefix + name)
    return names


@pytest.mark.parametrize("case", [c for c, _ in tsc.GNN_CASES])
def test_gnn_train_step_matches_the_plain_model(port, case):
    names = _held(port, f"{case}/")
    # the loss, each trainable leaf's gradient and updated value
    grads = [n for n in names if n.startswith("/grads/")]
    assert "/loss" in names and "step//loss" in names
    assert len(grads) == sum(n.startswith("step//params/") for n in names
                             if not n.endswith("_zeros")) > 3
    # every graph array's rows split over both mesh dims
    assert list(port[f"{case}/layout/rows"]) == [0, 0]
    n, m, n_real, m_real = port[f"{case}/sizes"]
    assert n > n_real and m > m_real      # padded nodes and edges
    if case == "pna":
        assert port[f"{case}/repeated_edges"] >= 1


@pytest.mark.parametrize("kind", ["train", "serve", "retrieval"])
def test_dlrm_cell_matches_the_plain_model(port, kind):
    names = _held(port, f"dlrm/{kind}/")
    if kind == "train":
        assert "/loss" in names and "step//loss" in names
        assert sum(n.startswith("/grads/tables/") for n in names) == 6
    # the ids hit the first and last rows of both model ranks' blocks
    ids = port["dlrm/ids"]
    for f, v in enumerate(SMOKE_CONFIG.vocab_sizes):
        assert {0, v // 2 - 1, v // 2, v - 1} <= set(ids[:, f, 0].tolist())


@pytest.mark.parametrize("pad", ["nopad", "pad6"])
def test_row_sharded_bag_matches_the_plain_bag(port, pad):
    assert set(_held(port, f"bag/{pad}/")) == {"out", "grad"}
