"""The plain references against ``repro_torch``'s session on the CPU, the
control that ``correct`` has to reject, and the faults it has to catch.

The harness's CPU entry (``run_cell(..., device="cpu")``) drives the whole
run but the look for a card: the same inputs, window, read-back and
comparison as on a card, at a tiny size.
"""
import numpy as np
import pytest
import torch

from bench import harness, program
from bench.gen.graph import powerlaw_graph, seed_sequence, snapshot_split
from bench.reference import compare, gc_pna, sage_max

TINY = {"config": {"n_vertices": 300, "n_edges": 1500, "d_in": 16,
                   "d_hidden": 16, "n_classes": 4}}
CELLS = ("gsmax-arxiv.uniform-b100", "gpm-arxiv.uniform-b100")
REFS = {"gs-max": sage_max, "gp-m": gc_pna}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only there")
    return "cuda"


def _tiny(workload: str):
    cfg = {"workload": workload, "n_layers": 3, "d_in": 16, "d_hidden": 16,
           "n_classes": 4, "n_vertices": 300, "engine": "device"}
    s_graph, s_split = seed_sequence(3).spawn(2)
    src, dst = powerlaw_graph(300, 1500, np.random.default_rng(s_graph))
    snap, _ = snapshot_split(src, dst, 0.1, np.random.default_rng(s_split))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(300, 16, generator=gen)
    ref = REFS[workload]
    w = harness.make_weights(ref.param_shapes((16, 16, 16, 4)), gen, "cpu")
    return cfg, snap, x, w, ref


@pytest.mark.parametrize("workload", sorted(REFS))
def test_reference_matches_the_programs_bootstrap(workload):
    cfg, (src, dst), x, w, ref = _tiny(workload)
    session = program.build_session(cfg, w, x.numpy(), src, dst, "cpu")
    H_got, q_got = program.outputs(session)
    H_ref = ref.forward(x, torch.as_tensor(src), torch.as_tensor(dst), w)
    got = compare.readings(H_got, q_got, H_ref)
    assert got["h_err"] < 1e-5 and got["query_err"] < 1e-5
    # empty in-neighbourhoods read 0: the max term vanishes, the bias stays
    k = np.bincount(dst, minlength=300)
    v = int(np.nonzero(k == 0)[0][0])
    if workload == "gp-m":
        want = torch.relu(w[0]["b"])
    else:
        want = torch.relu(x[v] @ w[0]["w_self"] + w[0]["b"])
    assert torch.allclose(H_ref[1][v], want, atol=1e-6)


def test_reference_pna_tower_by_hand():
    h = torch.tensor([[1.0], [3.0], [2.0]])
    src, dst = torch.tensor([0, 1]), torch.tensor([2, 2])
    x = gc_pna.tower(h, src, dst)
    # vertex 2: k 2, mean 2, std 1, max 3; vertices 0, 1: empty
    assert torch.allclose(x[2], torch.tensor([np.log(3.0) * 2, 1.0, 3.0],
                                             dtype=torch.float32))
    assert torch.equal(x[0], torch.zeros(3))


@pytest.mark.parametrize("cell", CELLS)
def test_streamed_session_is_correct(cell):
    r = harness.run_cell(cell, 2**31 + 99, 1.0, False, device="cpu",
                         overrides=TINY, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # ten times nearer the reference than the TF32 control: the limits
    # are set for the card's sizes, where gp-m's tiny rows read up to a
    # fifth of its limit (the std of a row whose inputs nearly agree)
    assert all(v["value"] < r["control"][k] / 10
               for k, v in r["checks"].items()), (r["checks"], r["control"])


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(cell, device, request):
    if device == "cuda":
        request.getfixturevalue("cuda")
    r = harness.run_cell(cell, 5, 0.3, False, device=device,
                         overrides=TINY, control=True)
    assert r["correct"]
    limits = {k: v["limit"] for k, v in r["checks"].items()}
    assert not compare.judge(r["control"], limits), r["control"]
    assert r["control"]["h_err"] > 3 * r["checks"]["h_err"]["value"]


def _unchanged(session):
    session.apply_one = lambda batch: None


def _half(session):
    from repro_torch.core.graph import UpdateBatch
    apply = session.apply_one

    def half(batch):
        return apply(UpdateBatch(edges=batch.edges[:len(batch.edges) // 2],
                                 features=batch.features[
                                     :len(batch.features) // 2]))
    session.apply_one = half


def _altered(session):
    apply = session.apply_one

    def altered(batch):
        res = apply(batch)
        H = session.engine.impl.state.H[-1]
        v = int(res.affected[0]) if res.affected.size else 0
        H[v, 0] += 0.01 * max(float(H[v].abs().max()), 1.0)
        return res
    session.apply_one = altered


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(cell, fault):
    r = harness.run_cell(cell, 21, 0.3, False, device="cpu", overrides=TINY,
                         tamper=fault)
    assert r["correct"] is False, r["checks"]


def test_warmup_is_the_same_for_every_seed():
    """The program's capacities follow the largest batches it has seen, so
    the warm-up that sets them is drawn from the configuration, and only
    the window from the run's seed."""
    seen = {}
    for seed in (7, 2**33 + 7):
        applied = seen.setdefault(seed, [])

        def record(session, applied=applied):
            apply = session.apply_one

            def logged(batch):
                applied.append(sorted((e.src, e.dst, e.add)
                                      for e in batch.edges))
                return apply(batch)
            session.apply_one = logged
        r = harness.run_cell(CELLS[0], seed, 0.3, False, device="cpu",
                             overrides=TINY, tamper=record)
        assert r["correct"] and r["warmup_batches"] >= harness.WARMUP_MIN
        seen[seed] = (r["warmup_batches"], applied)
    (w1, a1), (w2, a2) = seen.values()
    assert w1 == w2 and a1[:w1] == a2[:w2]
    assert a1[w1] != a2[w2]           # the windows' first batches differ
