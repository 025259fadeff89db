"""The port's partition rules and dry-run cells against the reference's:
``models/lm/sharding.py`` (parameter, optimizer-state and cache specs),
``configs/common.sanitize_spec``, ``configs/lm_common`` (``n_params``,
``model_flops``) and every LM cell's per-chip argument bytes on the two
production meshes, computed without a trace; and, once, the port's
argument bytes against XLA's own ``memory_analysis`` of the reference's
compiled train step on four virtual devices.

Meshes are stubs with the JAX mesh's ``shape`` and ``axis_names``: the
rules read nothing else, in either package.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import common as rcommon
from repro.configs import lm_common as rlm
from repro.models.lm import sharding as rsh
from repro.models.lm.model import init_cache as r_init_cache
from repro.models.lm.model import init_params as r_init_params
from repro.models.lm.steps import init_opt_state as r_init_opt

from repro_torch.configs import lm_common as tlm
from repro_torch.configs.common import Spec, sanitize_spec
from repro_torch.launch.dryrun import argument_bytes
from repro_torch.models.lm import sharding as tsh
from repro_torch.models.lm.model import param_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LMS = ("nemotron_4_15b", "phi4_mini_3_8b", "qwen2_1_5b", "olmoe_1b_7b",
       "deepseek_v3_671b")


class Mesh:
    """A mesh stub: ``shape`` by axis name and ``axis_names``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": Mesh(data=16, model=16),
          "2x16x16": Mesh(pod=2, data=16, model=16),
          "2x2": Mesh(data=2, model=2)}


def _configs():
    """label -> (reference config, port config): each LM's CONFIG and
    REDUCED, and deepseek-v3-opt's two."""
    out = {}
    for m in LMS:
        rj = importlib.import_module(f"repro.configs.{m}")
        rt = importlib.import_module(f"repro_torch.configs.{m}")
        for attr in ("CONFIG", "REDUCED"):
            out[f"{m}.{attr}"] = (getattr(rj, attr), getattr(rt, attr))
    oj = importlib.import_module("repro.configs.deepseek_v3_opt")
    ot = importlib.import_module("repro_torch.configs.deepseek_v3_opt")
    for attr in ("TRAIN_MB", "DECODE_LTP"):
        out[f"deepseek_v3_opt.{attr}"] = (getattr(oj, attr),
                                          getattr(ot, attr))
    return out


CONFIGS = _configs()


def _paths(tree, prefix=()):
    """{path: spec entries} of a spec tree (either package's)."""
    if isinstance(tree, (JP, Spec)):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    out = {}
    for i, v in enumerate(tree):
        out.update(_paths(v, prefix + (i,)))
    return out


def _abstract(cj):
    return jax.eval_shape(lambda: r_init_params(jax.random.PRNGKey(0), cj))


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_param_specs_match_reference(label, serving):
    cj, ct = CONFIGS[label]
    cj = dataclasses.replace(cj, serving_shardings=serving)
    ct = dataclasses.replace(ct, serving_shardings=serving)
    want = _paths(rsh.param_specs(cj))
    assert _paths(tsh.param_specs(ct)) == want
    # the same leaves, by path, as the reference's parameter tree
    shapes = {p: tuple(a.shape) for p, a in _paths_of_avals(_abstract(cj))}
    assert set(shapes) == set(want)


def _paths_of_avals(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths_of_avals(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("module", LMS)
def test_opt_state_specs_match_reference(module, opt):
    cj, ct = CONFIGS[f"{module}.CONFIG"]
    want = rsh.opt_state_specs(rsh.param_specs(cj), opt, _abstract(cj))
    got = tsh.opt_state_specs(tsh.param_specs(ct), opt, param_shapes(ct))
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for f in want._fields:
        assert _paths(getattr(got, f)) == _paths(getattr(want, f)), f


@pytest.mark.parametrize("batch", [1, 8, 16, 32, 128, 512])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("label", [f"{m}.CONFIG" for m in LMS]
                         + ["deepseek_v3_opt.DECODE_LTP", "latent_tp"])
def test_cache_specs_match_reference(label, mesh, batch):
    if label == "latent_tp":
        cj, ct = CONFIGS["deepseek_v3_671b.CONFIG"]
        cj = dataclasses.replace(cj, cache_latent_tp=True)
        ct = dataclasses.replace(ct, cache_latent_tp=True)
    else:
        cj, ct = CONFIGS[label]
    m = MESHES[mesh]
    assert _paths(tsh.cache_specs(ct, batch, m)) == \
        _paths(rsh.cache_specs(cj, batch, m))
    assert tsh.dp_axes(m) == rsh.dp_axes(m)


SHAPES = [(2,), (12, 128), (2, 16, 128), (28, 1536, 12, 128), (1, 64),
          (256, 7168, 2048), (61, 129280, 7168), (3, 2, 32, 48)]
SPECS = [("model",), ("data", "model"), (("data", "model"), None),
         (None, "model", None), ("data", None, "model"),
         (("pod", "data"), None), (None, ("pod", "data", "model")),
         ("model", "data"), (None, None)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sanitize_spec_matches_reference(mesh):
    m = MESHES[mesh]
    n = 0
    for shape in SHAPES:
        for entries in SPECS:
            used = {a for e in entries if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))}
            if not used <= set(m.axis_names):
                continue
            aval = jax.ShapeDtypeStruct(shape, jnp.float32)
            want = tuple(rcommon.sanitize_spec(m, JP(*entries), aval))
            got = tuple(sanitize_spec(m, Spec(*entries), shape))
            assert got == want, (shape, entries)
            n += 1
    assert n >= 40


@pytest.mark.parametrize("label", [f"{m}.CONFIG" for m in LMS]
                         + ["deepseek_v3_opt.TRAIN_MB",
                            "deepseek_v3_opt.DECODE_LTP"])
def test_n_params_and_model_flops_match_reference(label):
    cj, ct = CONFIGS[label]
    for got, want in zip(tlm.n_params(ct), rlm.n_params(cj)):
        assert got == pytest.approx(want, rel=1e-12)
    for kind, tokens in (("train", 256 * 4096), ("serve", 128)):
        assert tlm.model_flops(ct, tokens, kind) == pytest.approx(
            rlm.model_flops(cj, tokens, kind), rel=1e-12)
    assert tlm._layers(ct) == rlm._layers(cj)


def _local_bytes(mesh, spec, aval) -> int:
    spec = rcommon.sanitize_spec(mesh, spec, aval)
    n = 1
    for d, e in zip(aval.shape, tuple(spec) + (None,) * len(aval.shape)):
        n *= d // (rcommon._axis_size(mesh, e) if e is not None else 1)
    return n * jnp.dtype(aval.dtype).itemsize


def _ref_argument_bytes(cj, kind: str, seq: int, batch: int, mesh) -> int:
    """One chip's argument bytes of the reference's cell, from its
    sanitized specs and ``jax.eval_shape`` shapes.  Two differences from
    the port's arguments are taken into account here: the port's tokens
    are int64 (the reference's int32), and its decode position, one a
    stack, is a Python int (the reference's a replicated int32 scalar, 4
    bytes)."""
    params_a = _abstract(cj)
    p_spec = rsh.param_specs(cj)
    parts = [(p_spec, params_a)]
    dp = rcommon.dp_size_of(mesh)
    if kind == "train":
        opt_a = jax.eval_shape(lambda: r_init_opt(cj, params_a))
        parts.append((rsh.opt_state_specs(p_spec, cj.optimizer, params_a),
                      opt_a))
        tokens = batch * seq // dp
    elif kind == "prefill":
        tokens = batch * seq // dp
    else:
        parts.append((rsh.cache_specs(cj, batch, mesh),
                      jax.eval_shape(lambda: r_init_cache(cj, batch, seq))))
        tokens = batch
    total = 0
    for spec, aval in parts:
        leaves = jax.tree.leaves(jax.tree.map(
            lambda s, a: _local_bytes(mesh, s, a), spec, aval,
            is_leaf=lambda x: isinstance(x, JP)))
        total += sum(leaves)
    if kind == "decode":                 # the positions: Python ints
        total -= 4 * len(rsh.cache_specs(cj, batch, mesh))
    return total + tokens * 8            # int64 tokens


def _cells():
    out = []
    for m in LMS:
        arch = importlib.import_module(f"repro_torch.configs.{m}")
        rj = importlib.import_module(f"repro.configs.{m}")
        for cell in arch.CELLS:
            out.append((cell, rj.CONFIG))
    opt_t = importlib.import_module("repro_torch.configs.deepseek_v3_opt")
    opt_j = importlib.import_module("repro.configs.deepseek_v3_opt")
    for cell, cj in zip(opt_t.CELLS, (opt_j.TRAIN_MB, opt_j.DECODE_LTP)):
        out.append((cell, cj))
    return out


CELLS = _cells()


def test_every_lm_cell_is_there():
    assert len(CELLS) == 22
    assert {c.name for c, _ in CELLS} >= {
        "qwen2-1.5b/train_4k", "deepseek-v3-671b/long_500k",
        "deepseek-v3-opt/train_4k", "deepseek-v3-opt/decode_32k"}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("i", range(22))
def test_cell_argument_bytes_match_reference_shards(i, mesh):
    cell, cj = CELLS[i]
    m = MESHES[mesh]
    s = tlm.SHAPES[cell.shape]
    built = cell.build(m)
    assert built.probes == []
    assert argument_bytes(built, m) == _ref_argument_bytes(
        cj, s["kind"], s["seq"], s["batch"], m)


_XLA = """
import json
import jax
from repro.configs.lm_common import _mk_builder
from repro.configs.qwen2_1_5b import REDUCED
from repro.launch.mesh import make_local_mesh
mesh = make_local_mesh(2, 2)
b = _mk_builder(REDUCED, "train", 16, 4, with_probes=False)(mesh)
c = jax.jit(b.fn, in_shardings=b.in_shardings).lower(*b.args).compile()
print(json.dumps(c.memory_analysis().argument_size_in_bytes))
"""


def test_argument_bytes_match_xla_memory_analysis():
    """qwen2-1.5b REDUCED's train cell (batch 4, seq 16) on a 2 x 2 mesh of
    four virtual CPU devices: XLA's per-device argument size of the
    compiled reference step against the port's.  The one difference is
    the tokens' dtype: the port's are int64, the reference's int32, so the
    port holds 4 more bytes for each of a chip's 4 * 16 / 2 tokens."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _XLA], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    xla = json.loads(out.stdout.strip().splitlines()[-1])
    from repro_torch.configs.qwen2_1_5b import REDUCED
    m = MESHES["2x2"]
    port = argument_bytes(tlm._mk_builder(REDUCED, "train", 16, 4)(m), m)
    assert port == xla + 4 * (4 * 16 // 2)
    assert math.isfinite(port)
