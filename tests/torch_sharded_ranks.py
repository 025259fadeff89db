"""The LM's DTensor paths on real tensors over four ranks, for
tests/test_torch_sharded_lm.py.

    python tests/torch_sharded_ranks.py R 4 DIR   # rank R of 4, over gloo

Each rank imports ``torch`` and ``repro_torch`` only and joins a gloo
process group of CPU ranks through a file store in DIR.  On a 2 x 2
``("data", "model")`` mesh it runs the dry-run cells' own functions
(``configs/lm_common._mk_builder``) on REDUCED language models in fp32,
their arguments real tensors laid out as ``DTensor`` s by the cells' specs,
and the same functions on plain tensors: prefill logits, one decode step
against a sequence-sharded cache, and a train step's loss, gradients,
metrics and updated parameters.  Rank 0 writes both sides to
DIR/port.npz as ``<case>/<kind>/{plain,sharded}/<name>``.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

WORLD = 4
MESH = ((2, 2), ("data", "model"))

# (case, arch, config overrides, (kind, batch, seq) ...).  Each kind's
# batch sets its layout on the 2 x 2 mesh: 4 rows split over both axes in
# the projections, 2 over ``data`` only; a decode batch of 2 puts the
# cache's batch on ``data`` and its sequence on ``model``, 1 the sequence
# on both axes.
CASES = [
    ("qwen2", "qwen2-1.5b", {},
     (("prefill", 4, 16), ("decode", 2, 16), ("train", 4, 16))),
    # 3 query heads and 1 kv head split over neither mesh axis: projections
    # and attention whole on each model rank (the replicate rules)
    ("qwen2-h3", "qwen2-1.5b", dict(n_heads=3, n_kv_heads=1),
     (("prefill", 2, 16), ("decode", 1, 16), ("train", 2, 16))),
    # capacity 1.0: tokens are dropped
    ("olmoe", "olmoe-1b-7b", dict(capacity_factor=1.0),
     (("prefill", 4, 16), ("decode", 1, 16), ("train", 4, 16))),
    ("deepseek", "deepseek-v3-671b", {},
     (("prefill", 4, 16), ("decode", 2, 16), ("train", 4, 16))),
    # deepseek-v3-opt's two changes: microbatches and serving shardings
    ("deepseek-opt", "deepseek-v3-671b",
     dict(microbatch=2, serving_shardings=True),
     (("decode", 1, 16), ("train", 4, 16))),
]


def config(arch: str, overrides: dict):
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch).REDUCED
    if "capacity_factor" in overrides:
        overrides = dict(overrides)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=overrides.pop("capacity_factor")))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **overrides)


def _leaves(tree, path=""):
    import torch
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _numpy(tree, prefix: str) -> dict:
    """``{prefix + path: array}`` of every tensor leaf, ``DTensor`` s
    gathered whole (a partial sum reduced)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for path, t in _leaves(tree):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[prefix + path] = t.detach().float().numpy().copy()
    return out


def _clone(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def distribute(mesh, specs, args):
    """``args`` (real, whole tensors) laid out as the cell's ``specs`` say,
    each leaf under its sanitized spec, as the dry-run lays out its
    stand-ins; other leaves pass through."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.common import (placements, sanitize_spec,
                                            tree_map_specs)

    def make(spec, a):
        if not isinstance(a, torch.Tensor):
            return a
        spec = sanitize_spec(mesh, spec, a.shape)
        return distribute_tensor(a, mesh, placements(mesh, spec, a.dim()))

    return tuple(tree_map_specs(make, s, a) for s, a in zip(specs, args))


def run_kind(mesh, cfg, kind: str, batch: int, seq: int, params) -> dict:
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.lm_common import _mk_builder
    from repro_torch.models.lm.model import activation_sharding
    from repro_torch.models.lm.sharding import dp_axes
    from repro_torch.models.lm.steps import (init_opt_state, loss_fn,
                                             make_prefill_step)
    from repro_torch.train import value_and_grad

    built = _mk_builder(cfg, kind, seq, batch)(mesh)
    rng = np.random.default_rng(seq * 7 + batch)
    out = {}
    if kind == "train":
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
        args = (params, init_opt_state(cfg, params), tokens)
        # the gradient the step takes, before its optimizer update
        grad_fn = value_and_grad(loss_fn, has_aux=True)
        (total, mets), grads = grad_fn(params, cfg, tokens)
        out.update(_numpy({"total": total, **mets, "grads": grads},
                          "plain/"))
        sharded = distribute(mesh, built.in_shardings, args)
        with activation_sharding(mesh, dp_axes(mesh)), implicit_replication():
            (total, mets), grads = grad_fn(sharded[0], cfg, sharded[2])
        out.update(_numpy({"total": total, **mets, "grads": grads},
                          "sharded/"))
    elif kind == "prefill":
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
        args = (params, tokens)
    else:
        # a cache filled by a plain prefill of seq - 1 tokens; the cell
        # decodes one token at its last position
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
        _, caches = make_prefill_step(cfg, max_seq=seq)(params,
                                                        toks[:, :-1])
        args = (params, caches, toks[:, -1], seq - 1)
    plain = built.fn(*_clone(args))
    sharded = distribute(mesh, built.in_shardings, _clone(args))
    with implicit_replication():
        res = built.fn(*sharded)
    if kind == "train":
        res = ({"params": res[0], "metrics": res[2]})
        plain = ({"params": plain[0], "metrics": plain[2]})
    elif kind == "decode":
        # the logits and the caches the step wrote in place
        res, plain = (res[0], res[1]), (plain[0], plain[1])
    out.update(_numpy(plain, "plain/step"))
    out.update(_numpy(res, "sharded/step"))
    # the tensor dim each mesh dim shards (-1: none) of the layouts the
    # sharded paths key on: the table's vocabulary, the cache's sequence
    out["layout/embed"] = _shard_dims(sharded[0]["embed"])
    if kind == "decode":
        out["layout/cache"] = _shard_dims(next(iter(sharded[1].values()))[0])
    return out


def _shard_dims(t):
    from torch.distributed.tensor import Shard
    return np.array([p.dim if isinstance(p, Shard) else -1
                     for p in t.placements])


def run_rank(rank: int, world: int, run_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dtensor_rules
    from repro_torch.models.lm.model import init_params

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(run_dir, "store"),
        rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    dtensor_rules.register()
    out = {}
    for case, arch, overrides, kinds in CASES:
        cfg = config(arch, overrides)
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        for kind, batch, seq in kinds:
            for k, v in run_kind(mesh, cfg, kind, batch, seq,
                                 params).items():
                out[f"{case}/{kind}/{k}"] = v
    if rank == 0:
        np.savez(os.path.join(run_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
