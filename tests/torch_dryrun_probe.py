"""The port's dry-run on the CPU, in a process of its own (the fake process
group it runs on cannot share a process with a real one): the REDUCED LM
cells on a fake 2 x 2 "cpu" mesh, the 1/2/3-layer variants of qwen2's
train step, each GNN's SMOKE widths at two shapes, DLRM-RM2's SMOKE cells
(and its serve cell's FLOPs without the bag's formula), ``schnet-part`` at
a small geometry, the counters' pins and ``schnet/ogb_products`` at full
size on the fake 16 x 16 mesh, ``build_ripple`` at a small geometry, and
the CLI with ``--arch extra``.  Writes one JSON object to the path
given.

    PYTHONPATH=src python tests/torch_dryrun_probe.py OUT.json
"""
import contextlib
import dataclasses
import io
import json
import sys

import torch


def record(rec: dict) -> dict:
    return {k: rec[k] for k in ("flops_per_chip", "bytes_per_chip",
                                "collective_bytes_per_chip", "collectives",
                                "mem_per_device", "t_compute_s",
                                "t_memory_s", "t_collective_s", "dominant")}


def lm_cells(out: dict) -> None:
    from repro_torch.configs.common import Cell
    from repro_torch.configs.lm_common import _mk_builder
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh
    mesh = make_dryrun_mesh((2, 2), ("data", "model"), "cpu")
    cells = [("qwen2-1.5b", "decode"), ("olmoe-1b-7b", "prefill"),
             ("olmoe-1b-7b", "train"), ("deepseek-v3-671b", "decode"),
             ("deepseek-v3-671b", "train")]
    base = get_arch("qwen2-1.5b").REDUCED
    layers = {}
    for n in (1, 2, 3):
        cfg = dataclasses.replace(base, n_layers=n)
        cell = Cell("qwen2-1.5b", "train", "train",
                    _mk_builder(cfg, "train", 16, 4))
        layers[n] = record(dryrun.run_cell(cell, mesh, "2x2", 4, "cpu"))
        layers[n]["expected_argument_bytes"] = dryrun.argument_bytes(
            cell.build(mesh), mesh)
    out["layers"] = layers
    out["cells"] = {"qwen2-1.5b/train": layers[2]}
    for arch, kind in cells:
        cell = Cell(arch, kind, kind,
                    _mk_builder(get_arch(arch).REDUCED, kind, 16, 4))
        rec = record(dryrun.run_cell(cell, mesh, "2x2", 4, "cpu"))
        rec["expected_argument_bytes"] = dryrun.argument_bytes(
            cell.build(mesh), mesh)
        out["cells"][f"{arch}/{kind}"] = rec


def gnn_dlrm_part(out: dict) -> None:
    """The GNN, DLRM-RM2 and schnet-part cells at small sizes on the fake
    2 x 2 mesh: ``out["small"][name]`` a record each."""
    import torch
    from torch.utils.flop_counter import flop_registry
    from repro_torch.configs import dlrm_rm2, gnn_common, schnet_part
    from repro_torch.configs.common import Cell
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh
    mesh = make_dryrun_mesh((2, 2), ("data", "model"), "cpu")
    cells = []
    for arch in ("schnet", "pna", "nequip", "dimenet"):
        mod = get_arch(arch)
        for shape in ("full_graph_sm", "molecule"):
            cells.append(Cell(arch, shape, "train", gnn_common.build_gnn_train(
                arch, mod.SMOKE_INIT, mod.SMOKE_FORWARD,
                gnn_common.SHAPES[shape], molecular=mod.MOLECULAR,
                with_triplets=mod.WITH_TRIPLETS, d_hidden=mod.HP["d_hidden"],
                n_layers=mod.N_LAYERS)))
    cfg = dlrm_rm2.SMOKE_CONFIG
    cells += [Cell("dlrm-rm2", "train", "train",
                   dlrm_rm2.build_train(cfg, 8)),
              Cell("dlrm-rm2", "serve", "serve", dlrm_rm2.build_serve(cfg, 8)),
              Cell("dlrm-rm2", "retrieval", "retrieval",
                   dlrm_rm2.build_retrieval(cfg, 16))]
    for name, fn in (("v1", schnet_part.build), ("v2", schnet_part.build_v2)):
        cells.append(Cell("schnet-part", name, "train",
                          lambda m, fn=fn: fn(m, n=256, m=2048)))
    small = {}
    for cell in cells:
        rec = record(dryrun.run_cell(cell, mesh, "2x2", 4, "cpu"))
        rec["expected_argument_bytes"] = dryrun.argument_bytes(
            cell.build(mesh), mesh)
        small[cell.name] = rec
    out["small"] = small
    # the serve cell again without the bag's FLOP formula
    op = torch.ops.repro_torch.embedding_bag
    formula = flop_registry.pop(op)
    try:
        rec = dryrun.run_cell(cells[-4], mesh, "2x2", 4, "cpu")
    finally:
        flop_registry[op] = formula
    out["dlrm_serve_flops_without_bags"] = rec["flops_per_chip"]


def schnet_full(out: dict) -> None:
    """``schnet/ogb_products`` at full size on the fake 16 x 16 mesh."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh
    mesh = make_dryrun_mesh((16, 16), ("data", "model"), "cpu")
    cell = next(c for c in get_arch("schnet").CELLS
                if c.shape == "ogb_products")
    out["schnet_full"] = record(dryrun.run_cell(cell, mesh, "pod16x16", 256,
                                                "cpu"))


def pins(out: dict) -> None:
    """Counts of known programs on the fake 16 x 16 mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh
    mesh = make_dryrun_mesh((16, 16), ("data", "model"), "cpu")
    trace = dryrun.Trace()

    def dt(shape, local, lay):
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(torch.empty(local), mesh, lay,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    with trace, dryrun._propagation_outside():
        a = dt((512, 4096), (32, 4096), [Shard(0), Replicate()])
        b = dt((4096, 1024), (4096, 64), [Replicate(), Shard(1)])
        with trace.counting():
            a @ b
        out["product_flops"] = trace.flops
        x = dt((512, 4096), (32, 4096), [Shard(0), Replicate()])
        with trace.counting():
            x.redistribute(mesh, [Replicate(), Replicate()])
        out["all_gather_bytes"] = dict(trace.coll)
        # a known live set: a 4 MiB argument; a 16 MiB temporary that
        # dies before two 4 MiB ones are made
        arg = torch.empty(1 << 20)
        base = trace.live_bytes
        with trace.counting():
            t1 = arg.repeat(4)                 # 16 MiB
            t2 = t1.sum(0, keepdim=True)       # 4 bytes
            del t1
            t3 = arg * 2                       # 4 MiB
            res = t3 + t2                      # 4 MiB
        out["toy"] = dict(base=base, peak=trace.peak_bytes,
                          live=trace.live_bytes)
        del arg, t2, t3, res


def ripple(out: dict) -> None:
    """``build_ripple`` at the geometry a small CPU ``DistEngine`` has."""
    from repro_torch.configs.ripple_stream import build_ripple
    from repro_torch.configs.common import Cell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh
    geo = json.loads(sys.argv[2]) if len(sys.argv) > 2 else None
    if geo is None:
        return
    mesh = make_dryrun_mesh((1, 1), ("data", "model"), "cpu")
    geo["caps"] = tuple(tuple(c) for c in geo["caps"])
    geo["halo_cap"] = tuple(geo["halo_cap"])
    geo["dims"] = tuple(geo["dims"])
    cell = Cell("ripple", "small", "stream",
                lambda m: build_ripple(m, **geo))
    rec = dryrun.run_cell(cell, mesh, "1x1", 1, "cpu")
    out["ripple_small"] = record(rec)


def cli(out: dict, path: str) -> None:
    from repro_torch.launch import dryrun
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--arch", "extra", "--mesh", "both", "--device",
                          "cpu", "--out", path])
    out["cli"] = dict(rc=rc, stdout=buf.getvalue())


def main() -> None:
    out = {}
    lm_cells(out)
    gnn_dlrm_part(out)
    pins(out)
    schnet_full(out)
    ripple(out)
    cli(out, sys.argv[1] + ".jsonl")
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
