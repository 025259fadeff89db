"""The LM's DTensor paths (``models/lm/sharded.py``, the attention
strategy of ``kernels/flash_attention/sharding.py``) computed on real
tensors over four gloo ranks, held against the plain model.

The dry-run traces these paths on fake tensors, where nothing checks the
numbers; here tests/torch_sharded_ranks.py runs the dry-run cells' own
functions on a 2 x 2 ``("data", "model")`` mesh, their arguments real
fp32 tensors laid out by the cells' specs: the vocabulary-parallel
embedding and loss, MoE routing and dispatch per data shard (with
dropped tokens, and under serving shardings), flash-decoding over a
sequence-sharded cache, the projections and attention replicated where
their heads split over no mesh axis, and microbatches.  Each output is
compared with the same function on plain tensors in the same process:
|sharded - plain| <= 1e-4 |plain| + 1e-4 max|plain| elementwise (fp32
sums in another order).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharded_ranks as tsr  # noqa: E402

RUNNER = os.path.join(os.path.dirname(__file__), "torch_sharded_ranks.py")
RTOL = 1e-4
LR = 3e-4          # make_train_step's default, the step the cells take


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("sharded_ranks"))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, RUNNER, str(r),
                               str(tsr.WORLD), run_dir], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(tsr.WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"--- rank {i} (rc {p.returncode}):\n{out[-3000:]}"
              for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return dict(np.load(os.path.join(run_dir, "port.npz")))


RUNS = [(case, kind) for case, _, _, kinds in tsr.CASES
        for kind, _, _ in kinds]


@pytest.mark.parametrize("case,kind", RUNS,
                         ids=[f"{c}-{k}" for c, k in RUNS])
def test_sharded_paths_match_the_plain_model(port, case, kind):
    prefix = f"{case}/{kind}/plain/"
    names = [k[len(prefix):] for k in port if k.startswith(prefix)]
    assert names
    # the vocabulary over "model"; a decode cache's sequence [L, B, S, ...]
    # over "model", and over "data" too where the batch does not split
    assert list(port[f"{case}/{kind}/layout/embed"])[1] == 0
    if kind == "decode":
        cache = list(port[f"{case}/{kind}/layout/cache"])
        assert cache[1] == 2 and cache[0] in (1, 2), cache
    if kind == "train":
        # the loss, each parameter's gradient, the step's metrics and its
        # updated parameters
        assert "/total" in names and "/loss" in names
        assert sum(n.startswith("/grads/") for n in names) == \
            sum(n.startswith("step/params/") for n in names) > 5
    for name in names:
        plain = port[prefix + name]
        sharded = port[f"{case}/{kind}/sharded/{name}"]
        assert sharded.shape == plain.shape, name
        assert np.isfinite(sharded).all(), name
        atol = RTOL * float(np.abs(plain).max()) if plain.size else 0.0
        if name.endswith("attn/b_k") and name.startswith("step/"):
            # softmax is invariant to a shift of each query's scores, so
            # b_k's gradient is zero up to rounding and AdamW's first step
            # moves it by up to LR in the direction of that noise
            atol = LR
        np.testing.assert_allclose(sharded, plain, rtol=RTOL, atol=atol,
                                   err_msg=name)
