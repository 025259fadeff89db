"""Owner-partitioned SchNet on several ranks, for tests/test_torch_partitioned.py.

    python tests/torch_part_ranks.py R 4 DIR   # rank R of 4, over gloo

Each rank imports ``torch`` and ``repro_torch`` only, joins a gloo process
group of CPU ranks through a file store in DIR, and reads DIR/inputs.npz:
the graph, features, labels and SchNet parameters (the reference's, as
leaves in ``tree_flatten`` order).  It runs ``make_partitioned_schnet``
(v1, with a ``halo_cap`` that holds every message and with one that
overflows) and ``make_partitioned_schnet_v2`` on its own partition: the
loss and the all-reduced gradients, then one AdamW step.  Rank 0 writes
them to DIR/port.npz.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

N, M, D_IN, D_OUT, WORLD = 64, 400, 12, 5, 4
HP = dict(d_hidden=16, n_interactions=2, n_rbf=20, cutoff=6.0)
SMALL_HALO = 4          # far below the ~25 messages a destination owner gets


def run_rank(rank: int, world: int, run_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.models.gnn import partitioned as part
    from repro_torch.models.gnn.schnet import init_schnet
    from repro_torch.train import adamw_init

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(run_dir, "store"),
        rank=rank, world_size=world)
    data = np.load(os.path.join(run_dir, "inputs.npz"))
    template = init_schnet(torch.Generator().manual_seed(0), d_in=D_IN,
                           d_out=D_OUT, device="cpu", **HP)
    n_leaves = len(tree_flatten(template))

    def params():
        return tree_unflatten(template, [torch.as_tensor(data[f"p{i}"])
                                         for i in range(n_leaves)])

    src, dst, dist_ = data["src"], data["dst"], data["dist"]
    out = {}

    def run(tag, model, edges, n_local):
        feat = torch.as_tensor(data["feat"].reshape(world, n_local, D_IN)
                               [rank])
        labels = torch.as_tensor(data["labels"].reshape(world, n_local)
                                 [rank])
        mine = part.rank_edges(edges, rank, "cpu")
        loss, grads, ovf = model.loss_and_grads(params(), feat, mine, labels)
        p = params()
        opt = adamw_init(p)
        _, _, loss2, ovf2 = model.train_step(p, opt, feat, mine, labels)
        out[f"{tag}/loss"] = float(loss)
        out[f"{tag}/overflow"] = bool(ovf) and bool(ovf2)
        out[f"{tag}/no_overflow"] = not (bool(ovf) or bool(ovf2))
        out[f"{tag}/step_loss"] = float(loss2)
        for i, (g, q) in enumerate(zip(tree_flatten(grads),
                                       tree_flatten(p))):
            out[f"{tag}/g{i}"] = g.numpy()
            out[f"{tag}/p{i}"] = q.numpy()

    edges, n_local, e_cap = part.partition_graph_for_push(N, src, dst, dist_,
                                                          world)
    for tag, halo in (("v1", M), ("v1_small", SMALL_HALO)):
        run(tag, part.make_partitioned_schnet(
            n_local=n_local, e_cap=e_cap, halo_cap=halo, d_in=D_IN,
            d_out=D_OUT, **HP), edges, n_local)
    edges2, n_local2, cap2 = part.route_graph_for_push_v2(N, src, dst, dist_,
                                                          world)
    run("v2", part.make_partitioned_schnet_v2(
        n_local=n_local2, cap2=cap2, d_in=D_IN, d_out=D_OUT, **HP), edges2,
        n_local2)
    # every rank holds the same gradients and parameters
    check = torch.tensor([sum(float(np.abs(v).sum()) for k, v in out.items()
                              if "/g" in k or "/p" in k)], dtype=torch.float64)
    low, high = check.clone(), check.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    out["ranks_agree"] = bool(low == high)
    if rank == 0:
        np.savez(os.path.join(run_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
