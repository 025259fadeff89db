"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

The traces run in one subprocess (``tests/torch_dryrun_probe.py``): the
fake process group they need cannot share a process with the real one
other tests make.  It traces the REDUCED LM cells on a fake 2 x 2 "cpu"
mesh (where DTensor's all-to-alls appear as all-gathers: "CPU process
group does not support alltoall"), qwen2's train step at 1, 2 and 3
layers, each GNN's SMOKE widths at two shapes, DLRM-RM2's SMOKE cells and
``schnet-part`` at a small geometry there too, the counters' pins and
``schnet/ogb_products`` at full size on the fake 16 x 16 mesh, the ripple
cell at the geometry of a small CPU ``DistEngine`` built here, and the
CLI's ``--arch extra --mesh both``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.api import InferenceSession, SessionConfig
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import default_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine_call():
    """A small CPU ``dist`` gc-s session (one gloo rank) after one batch:
    the arguments its engine passes to the ripple propagate for the next
    batch, at that batch's cap rung."""
    from repro_torch.core.graph import UpdateBatch
    s = InferenceSession.build(SessionConfig(
        workload="gc-s", engine="dist", graph="er", n=3000, m=12000, d_in=16,
        d_hidden=16, n_classes=8, seed=0, device="cpu"))
    ups = list(s.make_stream(200, seed=1).updates)
    s.ingest(ups[:100], batch_size=100)
    eng = s.engine.impl
    nxt = ups[100:]
    np_b, _, _ = eng._route(UpdateBatch(
        edges=[u for u in nxt if hasattr(u, "src")],
        features=[u for u in nxt if not hasattr(u, "src")]))
    db, k = eng._upload_batch(np_b)
    caps, halo, _, _ = eng._caps(eng._rung)
    args = (eng._params, eng.H, eng.S, k, eng.out_csr.device(), db)
    tensors = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in dryrun._tensors(args)}
    geometry = dict(n_vertices=eng.n_local * eng.n_parts,
                    pool=eng.out_csr.pool, caps=[list(c) for c in caps],
                    halo_cap=list(halo), feat_cap=int(db.ints.shape[1]),
                    dims=list(eng.workload.spec.dims), donate=eng.donate)
    return sum(tensors.values()), geometry


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    engine_bytes, geometry = _engine_call()
    out = tmp / "probe.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dryrun_probe.py"),
         str(out), json.dumps(geometry)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        res = json.load(f)
    res["engine_bytes"], res["geometry"] = engine_bytes, geometry
    res["jsonl"] = str(out) + ".jsonl"
    return res


CELLS = ["qwen2-1.5b/train", "qwen2-1.5b/decode", "olmoe-1b-7b/prefill",
         "olmoe-1b-7b/train", "deepseek-v3-671b/decode",
         "deepseek-v3-671b/train"]


@pytest.mark.parametrize("cell", CELLS)
def test_reduced_cells_trace_to_finite_records(probe, cell):
    rec = probe["cells"][cell]
    mem = rec["mem_per_device"]
    for key in ("flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "t_compute_s", "t_memory_s",
                "t_collective_s"):
        assert rec[key] > 0 and rec[key] < float("inf"), key
    assert rec["dominant"] in ("compute", "memory", "collective")
    # the trace's arguments are the shards the specs give, to the byte
    assert mem["argument_bytes"] == rec["expected_argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    assert mem["temp_bytes"] == (mem["peak_bytes"] - mem["argument_bytes"]
                                 - mem["output_bytes"])
    # a "cpu" mesh: DTensor's all-to-alls come out as all-gathers
    assert rec["collectives"]["all-to-all"] == 0


SMALL = [f"{a}/{s}" for a in ("schnet", "pna", "nequip", "dimenet")
         for s in ("full_graph_sm", "molecule")] + [
    "dlrm-rm2/train", "dlrm-rm2/serve", "dlrm-rm2/retrieval",
    "schnet-part/v1", "schnet-part/v2"]


@pytest.mark.parametrize("cell", SMALL)
def test_gnn_dlrm_and_partitioned_cells_trace(probe, cell):
    """Finite records whose argument bytes are the specs' shards; the GNN
    cells' gathers and scatters appear as all-gathers and
    reduce-scatters, the parameters' gradients as all-reduces; DLRM's
    bags' partial sums over ``model`` as all-reduces; schnet-part's
    exchanges as all-to-alls (all-gathers on a "cpu" mesh)."""
    rec = probe["small"][cell]
    mem = rec["mem_per_device"]
    for key in ("flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "t_compute_s", "t_memory_s",
                "t_collective_s"):
        assert 0 < rec[key] < float("inf"), key
    assert mem["argument_bytes"] == rec["expected_argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0
    if cell.startswith(("schnet/", "pna/", "nequip/", "dimenet/")):
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    elif cell.startswith("schnet-part/"):
        assert coll["all-to-all"] > 0 and coll["all-gather"] == 0
    else:
        assert coll["all-gather"] == coll["reduce-scatter"] == 0


def test_dlrm_flops_count_the_bags(probe):
    """The serve cell (SMOKE: 6 fields, batch 8 over ``data`` = 2, one
    lane, d 16) counts B hot d for each of rank 0's bags, 6 x 4 x 1 x 16,
    on top of the products: without the custom op's formula the trace
    counts that much less."""
    with_bags = probe["small"]["dlrm-rm2/serve"]["flops_per_chip"]
    assert with_bags - probe["dlrm_serve_flops_without_bags"] == \
        6 * 4 * 1 * 16


def test_schnet_products_traces_at_full_size(probe):
    """``schnet/ogb_products`` on the fake 16 x 16 mesh: the reference's
    8,293,632 argument bytes a chip, and the all-gathers of the node rows
    that the edges read."""
    rec = probe["schnet_full"]
    assert rec["mem_per_device"]["argument_bytes"] == 8_293_632
    assert rec["collectives"]["all-gather"] > 0
    assert rec["collectives"]["reduce-scatter"] > 0
    assert 0 < rec["flops_per_chip"] < float("inf")


def test_costs_are_affine_in_depth(probe):
    """qwen2's REDUCED train step at 1, 2 and 3 layers: FLOPs, bytes and
    collective bytes grow by the same amount each layer (the premise the
    reference's probe fit rests on; the port traces every layer)."""
    lay = probe["layers"]
    for key in ("flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip"):
        a, b, c = (lay[str(n)][key] for n in (1, 2, 3))
        assert b - a > 0, key
        assert c - b == pytest.approx(b - a, rel=1e-12), key


def test_flops_count_one_chips_share(probe):
    """[512, 4096] @ [4096, 1024], Shard(0) by Shard(1) on 16 x 16: one
    chip multiplies [32, 4096] by [4096, 64] (FlopCounterMode around the
    DTensor op would report the global 4,294,967,296)."""
    assert probe["product_flops"] == 2 * 32 * 4096 * 64 == 16_777_216


def test_all_gather_counts_its_gathered_output(probe):
    """A [32, 4096] fp32 shard gathered over ``data`` (16 ranks): 8 MiB."""
    coll = probe["all_gather_bytes"]
    assert coll["all-gather"] == 16 * 32 * 4096 * 4 == 8 << 20
    assert sum(coll.values()) == coll["all-gather"]


def test_peak_follows_the_live_set(probe):
    """A 16 MiB temporary that dies before two 4 MiB ones are made: the
    peak is the 16 MiB one (and its 4-byte sum) over what lived before."""
    toy = probe["toy"]
    assert toy["peak"] - toy["base"] == (16 << 20) + 4
    assert toy["live"] - toy["base"] == (8 << 20) + 4


def test_ripple_cell_takes_the_engines_arguments(probe):
    """``build_ripple`` at a small ``DistEngine``'s geometry: its argument
    bytes, counted from the stand-ins here and from the trace in the
    probe, equal the bytes of the tensors the engine passes to its
    propagate."""
    from repro_torch.configs.ripple_stream import build_ripple
    geo = dict(probe["geometry"])
    geo["caps"] = tuple(tuple(c) for c in geo["caps"])
    geo["halo_cap"] = tuple(geo["halo_cap"])
    geo["dims"] = tuple(geo["dims"])
    mesh = default_mesh("cpu")
    built = build_ripple(mesh, **geo)
    assert built.in_shardings is None
    assert dryrun.argument_bytes(built, mesh) == probe["engine_bytes"]
    rec = probe["ripple_small"]
    assert rec["mem_per_device"]["argument_bytes"] == probe["engine_bytes"]
    assert rec["flops_per_chip"] > 0
    assert rec["collectives"]["all-reduce"] > 0


def test_cli_extra_on_both_meshes(probe):
    cli = probe["cli"]
    assert cli["rc"] == 0
    ok = [line for line in cli["stdout"].splitlines()
          if line.startswith("[OK]")]
    assert len(ok) == 2 and all("ripple-papers/stream_1k" in line
                                for line in ok)
    recs = [json.loads(line) for line in open(probe["jsonl"])]
    assert [r["mesh"] for r in recs] == ["pod16x16", "2pod 2x16x16"]
    for r in recs:
        assert "NVIDIA H100" in r["notes"]
        # the reference's ripple cell: 2 r d^2 + 2 e d a hop, every data
        # partition running its own caps
        assert r["flops_per_chip"] == 6_476_005_376
    # the reference's report renders the records as they are
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.roofline_report", probe["jsonl"]],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert "ripple-papers/stream_1k" in out.stdout


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "extra", "--device", "cuda"])


def test_registry_holds_the_dryrun_archs():
    assert get_arch("deepseek-v3-opt").__name__.endswith("deepseek_v3_opt")
    assert get_arch("ripple-papers").__name__.endswith("ripple_stream")
    assert len(get_arch("ripple-papers").CELLS) == 1
    lm = [c for a in ("nemotron-4-15b", "phi4-mini-3.8b", "qwen2-1.5b",
                      "olmoe-1b-7b", "deepseek-v3-671b")
          for c in get_arch(a).CELLS]
    assert len(lm) == 20 and len({c.name for c in lm}) == 20
    # the reference's assigned 40: the LM cells, then the four GNNs' and
    # DLRM-RM2's (tests/test_torch_dryrun_cells.py holds the names to the
    # reference's)
    assigned = [c.name for c in all_cells(include_extra=False)]
    assert len(assigned) == 40 and assigned[:20] == [c.name for c in lm]
    assert sum(n.startswith("dlrm-rm2/") for n in assigned) == 4
    extra = [c.name for c in all_cells(include_extra=True)]
    assert len(extra) == 45 and "ripple-papers/stream_1k" in extra
    assert sum(n.startswith("deepseek-v3-opt/") for n in extra) == 2
    assert sum(n.startswith("schnet-part/") for n in extra) == 2
