"""The work formulas against hand counts, and the counts' independence of
the program's padded launch shapes."""
import numpy as np
import pytest
import torch

from bench import harness, program
from bench.gen.graph import powerlaw_graph, seed_sequence, snapshot_split
from bench.gen.stream import Batch, ChurnStream
from bench.work.formulas import (bag_work, bound_s, extremum_work,
                                 layer_flops_per_row, lhop_rows,
                                 reached_rows)

E = np.empty(0, np.int64)


def _batch(feat=(), add=(), dele=()):
    def cols(pairs):
        a = np.array(pairs, np.int64).reshape(-1, 2)
        return a[:, 0], a[:, 1]
    (a_s, a_d), (d_s, d_d) = cols(add), cols(dele)
    f = np.array(feat, np.int64)
    return Batch(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d,
                 del_pos=E, feat_idx=f,
                 feat_val=np.zeros((f.size, 1), np.float32))


# six vertices, a path 0 -> 1 -> ... -> 5 and a chord 0 -> 2
SRC = np.array([0, 1, 2, 3, 4, 0])
DST = np.array([1, 2, 3, 4, 5, 2])


@pytest.mark.parametrize("self_dep, want", [(False, [2, 2, 2]),
                                            (True, [3, 4, 5])])
def test_lhop_rows_by_hand(self_dep, want):
    rows = lhop_rows(6, SRC, DST, [_batch(feat=[0])], 3, self_dep)
    assert rows.tolist() == [want]


def test_lhop_rows_undoes_later_batches():
    # b2 adds 5 -> 0 and deletes 4 -> 5; the final graph is after b2
    b1, b2 = _batch(feat=[4]), _batch(add=[(5, 0)], dele=[(4, 5)])
    final_src = np.array([0, 1, 2, 3, 0, 5])
    final_dst = np.array([1, 2, 3, 4, 2, 0])
    rows = lhop_rows(6, final_src, final_dst, [b1, b2], 3, False)
    # b1 on the graph before b2: 4 -> 5 present, 5 -> 0 absent
    assert rows[0].tolist() == [1, 0, 0]
    # b2: edge destinations {0, 5} at every layer, and out-neighbours
    assert rows[1].tolist() == [2, 4, 5]


def test_layer_flops_by_hand():
    assert layer_flops_per_row("sage", "max", 128, 128) == 2 * 2 * 128 * 128
    assert layer_flops_per_row("gc", "pna", 128, 40) == 2 * 384 * 40
    with pytest.raises(ValueError):
        layer_flops_per_row("gat", "max", 1, 1)


def test_kernel_work_by_hand():
    # 10 rows, Din 4, Dout 2, one call, masked: 13 B a cell, h 8 B a row,
    # W and b once
    assert extremum_work(10, 4, 2, 1) == (10 * (4 * 13 + 8) + 4 * 10, 160)
    # 3 bags, 7 kept lanes, width 4: ids, rows, outputs
    assert bag_work(3, 7, 4) == (4 * 7 + 4 * 4 * 10, 28)
    assert bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 67e12) == pytest.approx(1.0)


def _engine_work(min_bucket: int):
    cfg = {"workload": "gs-max", "n_layers": 3, "d_in": 8, "d_hidden": 8,
           "n_classes": 4, "n_vertices": 300, "engine": "device"}
    s_graph, s_split, s_stream = seed_sequence(11).spawn(3)
    src, dst = powerlaw_graph(300, 1500, np.random.default_rng(s_graph))
    snap, hold = snapshot_split(src, dst, 0.1,
                                np.random.default_rng(s_split))
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(300, 8, generator=gen)
    from bench.reference import sage_max
    w = harness.make_weights(sage_max.param_shapes((8, 8, 8, 4)), gen, "cpu")
    session = program.build_session(cfg, w, x.numpy(), *snap, "cpu",
                                    {"min_bucket": min_bucket})
    stream = ChurnStream(300, snap, hold, x.numpy().copy(),
                         dict(batch=20, mix=[1, 1, 1]),
                         np.random.default_rng(s_stream))
    for _ in range(8):
        b = stream.next_batch()
        session.apply_one(program.to_update_batch(b))
        stream.commit(b)
    sizes = program.counters(session)["sizes_total"]
    work = [extremum_work(int(sizes[l, 0]), 8, 8, 8) for l in range(3)]
    return session.engine.impl._caps(0), sizes, work


def test_padded_launch_shapes_do_not_change_the_count():
    caps_a, sizes_a, work_a = _engine_work(16)
    caps_b, sizes_b, work_b = _engine_work(1024)
    assert caps_a != caps_b                  # other padded launch shapes
    assert np.array_equal(sizes_a, sizes_b)  # the same needed rows, lanes
    assert work_a == work_b


def test_reached_rows_by_hand():
    # feature update at 0 on the six-vertex graph: layer 1 {1, 2}, layer 2
    # {2, 3}, layer 3 {3, 4}; a self-dependent layer keeps its inputs
    got = reached_rows(6, SRC, DST, [_batch(feat=[0])], 3, False)
    assert [np.nonzero(r)[0].tolist() for r in got] == [[1, 2], [2, 3],
                                                        [3, 4]]
    got = reached_rows(6, SRC, DST, [_batch(feat=[0])], 3, True)
    assert [np.nonzero(r)[0].tolist() for r in got] == [
        [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3, 4]]


def test_reached_rows_cover_every_batchs_lhop_rows():
    # b1 reaches over 4 -> 5, which b2 deletes; b2 adds 5 -> 0
    b1, b2 = _batch(feat=[4]), _batch(add=[(5, 0)], dele=[(4, 5)])
    final_src = np.array([0, 1, 2, 3, 0, 5])
    final_dst = np.array([1, 2, 3, 4, 2, 0])
    got = reached_rows(6, final_src, final_dst, [b1, b2], 3, False)
    assert got[0].tolist() == [True, False, False, False, False, True]
    # at least as many rows as either batch's own recursion reaches
    per_batch = lhop_rows(6, final_src, final_dst, [b1, b2], 3, False)
    assert (got.sum(axis=1) >= per_batch.max(axis=0)).all()
    assert reached_rows(6, final_src, final_dst, [], 3, False).sum() == 0
