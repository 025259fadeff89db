"""Does this torch's gloo backend take CUDA tensors?

    python tools/gloo_cuda_probe.py [--ranks 4]

Spawns ``--ranks`` processes that share card 0 in one gloo process group
and runs, on CUDA tensors, each collective the distributed engine uses
(``all_to_all_single``, ``all_reduce`` SUM and MAX, the single-tensor
reduce-scatter and all-gather), checking each result against its
definition.  Prints one JSON line: per collective "ok" or the error it
raised, and the torch version.  Several ranks on one card need gloo (NCCL
refuses two ranks on one GPU); a collective gloo refuses on CUDA tensors
rules that run out.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _probe(rank: int, world: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    ag = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor

    def a2a():
        x = torch.arange(world * 2, device=dev, dtype=torch.float32) \
            + 100 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.tensor([100 * p + 2 * rank + j for p in range(world)
                             for j in range(2)], dtype=torch.float32)
        return torch.equal(y.cpu(), want)

    def sum_():
        x = torch.full((3,), float(rank + 1), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x.cpu().tolist() == [world * (world + 1) / 2] * 3

    def max_():
        x = torch.full((3,), rank, device=dev, dtype=torch.int64)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x.cpu().tolist() == [world - 1] * 3

    def reduce_scatter():
        x = torch.arange(world * 2, device=dev, dtype=torch.float32)
        y = torch.empty(2, device=dev)
        rs(y, x)
        return y.cpu().tolist() == [world * (2 * rank), world * (2 * rank
                                                                 + 1)]

    def all_gather():
        x = torch.full((2,), float(rank), device=dev)
        y = torch.empty(2 * world, device=dev)
        ag(y, x)
        return y.cpu().tolist() == [float(p) for p in range(world)
                                    for _ in range(2)]

    res = {}
    for name, fn in (("all_to_all_single", a2a), ("all_reduce_sum", sum_),
                     ("all_reduce_max", max_),
                     ("reduce_scatter", reduce_scatter),
                     ("all_gather", all_gather)):
        try:
            res[name] = "ok" if fn() else "wrong result"
        except (RuntimeError, ValueError) as e:
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        mp.spawn(_probe, args=(args.ranks, os.path.join(tmp, "store"), out),
                 nprocs=args.ranks)
        with open(out) as f:
            res = json.load(f)
    print(json.dumps(dict(torch=torch.__version__, ranks=args.ranks,
                          device=torch.cuda.get_device_name(0),
                          gloo_cuda=res)))


if __name__ == "__main__":
    main()
