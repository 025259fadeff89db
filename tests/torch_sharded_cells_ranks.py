"""The GNN and DLRM-RM2 cells' DTensor paths on real tensors over four
ranks, for tests/test_torch_sharded_cells.py.

    python tests/torch_sharded_cells_ranks.py R 4 DIR   # rank R of 4, gloo

Each rank imports ``torch`` and ``repro_torch`` only and joins a gloo
process group of CPU ranks through a file store in DIR.  On a 2 x 2
``("data", "model")`` mesh it runs the dry-run cells' own functions
(``configs/gnn_common.build_gnn_train``, ``configs/dlrm_rm2.build_*``) at
the SMOKE widths, their arguments real fp32 tensors laid out as
``DTensor`` s by the cells' specs, and the same functions on plain
tensors: each GNN's train step (loss, every gradient, the updated
parameters) on a padded graph (masked padding edges; PNA's padding
vertices have no real in-edge), SchNet's graph-level loss too, DLRM's
train, serve and retrieval, and the sharded bag alone with several lanes
a bag and a padding id.  Rank 0 writes both sides to DIR/port.npz as
``<case>/{plain,sharded}/<name>``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from torch_sharded_ranks import _clone, _numpy, distribute  # noqa: E402

WORLD = 4
MESH = ((2, 2), ("data", "model"))
# small node-level and graph-level shapes: n and m are padded to 512
NODE = dict(n=300, m=400, d=6, classes=5, kind="train")
GRAPHS = dict(n=12 * 8, m=20 * 8, d=6, n_graphs=8, kind="train")
GNN_CASES = [("schnet", NODE), ("pna", NODE), ("nequip", NODE),
             ("dimenet", NODE), ("schnet-graphs", GRAPHS)]
DLRM_B, DLRM_CANDIDATES = 8, 16


def gnn_case(mesh, name: str, shape: dict) -> dict:
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import gnn_common as gc
    from repro_torch.configs.registry import get_arch
    from repro_torch.train import adamw_init, value_and_grad
    arch = name.split("-")[0]
    mod = get_arch(arch)
    built = gc.build_gnn_train(
        arch, mod.SMOKE_INIT, mod.SMOKE_FORWARD, shape,
        molecular=mod.MOLECULAR, with_triplets=mod.WITH_TRIPLETS,
        d_hidden=mod.HP["d_hidden"], n_layers=mod.N_LAYERS)(mesh)
    data = gc.make_gnn_batch(shape, device="cpu", seed=3,
                             triplets=mod.WITH_TRIPLETS)
    batch = data.batch if mod.MOLECULAR else data.batch._replace(
        positions=None)
    n_graphs = shape.get("n_graphs")
    params = mod.SMOKE_INIT(torch.Generator().manual_seed(4), d_in=shape["d"],
                            d_out=shape.get("classes") or 1, device="cpu")
    train, aux = gc.split_params(params)
    args = (params, adamw_init(train), batch, data.labels,
            *((data.triplets,) if mod.WITH_TRIPLETS else ()))
    loss_fn = gc.make_gnn_loss(mod.SMOKE_FORWARD, "graph_mse" if n_graphs
                               else "node_ce", n_graphs)
    grad_fn = value_and_grad(lambda t, a, *rest: loss_fn({**t, **a}, *rest))
    out = {}
    loss, grads = grad_fn(train, aux, *args[2:])
    out.update(_numpy({"loss": loss, "grads": grads}, "plain/"))
    sharded = distribute(mesh, built.in_shardings, _clone(args))
    s_train, s_aux = gc.split_params(sharded[0])
    with implicit_replication():
        loss, grads = grad_fn(s_train, s_aux, *sharded[2:])
    out.update(_numpy({"loss": loss, "grads": grads}, "sharded/"))
    res = built.fn(*_clone(args))
    out.update(_numpy({"params": res[0], "loss": res[2]}, "plain/step/"))
    with implicit_replication():
        res = built.fn(*sharded)
    out.update(_numpy({"params": res[0], "loss": res[2]}, "sharded/step/"))
    # the rows of every graph array are split over all four ranks
    out["layout/rows"] = np.array([p.dim for p in sharded[2].src.placements])
    out["sizes"] = np.array([data.sizes["n"], data.sizes["m"],
                             data.sizes["n_real"], data.sizes["m_real"]])
    # real edges drawn twice (PNA: their messages tie for the maximum)
    m_real = data.sizes["m_real"]
    pairs = batch.src[:m_real].long() * data.sizes["n"] \
        + batch.dst[:m_real].long()
    out["repeated_edges"] = np.array(m_real - pairs.unique().numel())
    return out


def dlrm_ids(cfg, batch: int, seed: int):
    """``[batch, n_sparse, hot]`` ids: each table's first rows hit both
    ends of both model ranks' blocks, the rest uniform."""
    import torch
    rng = np.random.default_rng(seed)
    cols = []
    for v in cfg.vocab_sizes:
        ids = rng.integers(0, v, (batch, cfg.multi_hot))
        ends = np.array([0, v // 2 - 1, v // 2, v - 1])
        k = min(batch, 4)
        ids[:k, 0] = ends[:k]
        cols.append(ids)
    return torch.as_tensor(np.stack(cols, 1).astype(np.int32))


def dlrm_case(mesh) -> dict:
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import dlrm_rm2 as dc
    from repro_torch.models.recsys.dlrm import dlrm_loss, init_dlrm
    from repro_torch.train import adamw_init, value_and_grad
    cfg = dc.SMOKE_CONFIG
    gen = torch.Generator().manual_seed(5)
    params = init_dlrm(gen, cfg, device="cpu")
    dense = torch.randn((DLRM_B, cfg.n_dense), generator=gen)
    sparse = dlrm_ids(cfg, DLRM_B, 6)
    labels = torch.randint(0, 2, (DLRM_B,), generator=gen).float()
    q_dense = torch.randn((1, cfg.n_dense), generator=gen)
    # the query's fields alternate between the two blocks
    q_sparse = torch.as_tensor(np.array(
        [[[(f % 2) * (v // 2) + (v // 2 - 1) * (f % 3 == 0)]
          for f, v in enumerate(cfg.vocab_sizes)]], np.int32))
    cand = torch.randn((DLRM_CANDIDATES, cfg.embed_dim), generator=gen)
    out = {}
    grad_fn = value_and_grad(dlrm_loss)
    for kind, builder, args in (
            ("train", dc.build_train(cfg, DLRM_B),
             (params, adamw_init(params), dense, sparse, labels)),
            ("serve", dc.build_serve(cfg, DLRM_B), (params, dense, sparse)),
            ("retrieval", dc.build_retrieval(cfg, DLRM_CANDIDATES),
             (params, q_dense, q_sparse, cand))):
        built = builder(mesh)
        sharded = distribute(mesh, built.in_shardings, _clone(args))
        if kind == "train":
            loss, grads = grad_fn(params, cfg, dense, sparse, labels)
            out.update(_numpy({"loss": loss, "grads": grads},
                              f"{kind}/plain/"))
            with implicit_replication():
                loss, grads = grad_fn(sharded[0], cfg, *sharded[2:])
            out.update(_numpy({"loss": loss, "grads": grads},
                              f"{kind}/sharded/"))
        plain = built.fn(*_clone(args))
        with implicit_replication():
            res = built.fn(*sharded)
        if kind == "train":
            plain = {"params": plain[0], "loss": plain[2]}
            res = {"params": res[0], "loss": res[2]}
        out.update(_numpy(plain, f"{kind}/plain/step/"))
        out.update(_numpy(res, f"{kind}/sharded/step/"))
    out["ids"] = sparse.numpy()
    return out


def bag_case(mesh) -> dict:
    """``embedding_bag`` of a table row-sharded over ``model`` (12 rows,
    blocks of 6) with 3 lanes a bag, ids batch-sharded over ``data``: lanes
    on each block's first and last rows, several in one bag, and the
    padding id; the output and the table's gradient."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels.embedding_bag import embedding_bag
    gen = torch.Generator().manual_seed(7)
    table = torch.randn((12, 4), generator=gen)
    idx = torch.as_tensor([[0, 5, 6], [11, 11, 0], [6, 6, 6], [3, 9, 5],
                           [0, 0, 11], [7, 2, 2], [5, 6, 4], [1, 10, 8]],
                          dtype=torch.int32)
    weight = torch.randn((8, 4), generator=gen)
    out = {}
    for tag, pad in (("nopad", None), ("pad6", 6)):
        t = table.clone().requires_grad_()
        y = embedding_bag(t, idx, pad)
        (y * weight).sum().backward()
        out[f"bag/{tag}/plain/out"] = y.detach().numpy().copy()
        out[f"bag/{tag}/plain/grad"] = t.grad.numpy().copy()
        ts = distribute_tensor(table.clone(), mesh, [Replicate(), Shard(0)])
        ts.requires_grad_()
        ids = distribute_tensor(idx, mesh, [Shard(0), Replicate()])
        ws = distribute_tensor(weight, mesh, [Shard(0), Replicate()])
        with implicit_replication():
            y = embedding_bag(ts, ids, pad)
            (y * ws).sum().backward()
        out[f"bag/{tag}/sharded/out"] = y.full_tensor().detach().numpy()
        out[f"bag/{tag}/sharded/grad"] = ts.grad.full_tensor().numpy()
    return out


def run_rank(rank: int, world: int, run_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(run_dir, "store"),
        rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    out = {}
    for name, shape in GNN_CASES:
        for k, v in gnn_case(mesh, name, shape).items():
            out[f"{name}/{k}"] = v
    for k, v in dlrm_case(mesh).items():
        out[f"dlrm/{k}"] = v
    out.update(bag_case(mesh))
    if rank == 0:
        np.savez(os.path.join(run_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
