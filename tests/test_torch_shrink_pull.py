"""``shrink_pull``'s plain version (the CPU route of the monotonic hop's
``"pairs"`` SHRINK pull) by hand on toy in-CSRs: a tie between two
witnesses, the min aggregator, a needed row with no in-edge, a source read
through the previous hop's patch, the caps' overflow, and random cases
against a loop over the cells.  The kernel is held to this version on a
card (tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.shrink_pull import shrink_pull
from repro_torch.kernels.shrink_pull.ref import shrink_pull_ref

# in-neighbours of vertices 0..4; vertex 2 has none
IN = [[1, 2], [0, 3, 4], [], [4], [0, 1, 2, 3]]


def _csr(in_lists, slack=1):
    """A slack-pool in-CSR as the device mirror keeps it: every row's
    sources followed by ``slack`` unused slots (-1)."""
    col, start = [], []
    for srcs in in_lists:
        start.append(len(col))
        col += list(srcs) + [-1] * slack
    t = lambda a: torch.tensor(a, dtype=torch.int64)
    return t(start), t([len(s) for s in in_lists]), t(col)


def _args(in_lists, H, need, aff, *, patch=None, C_pre=None):
    """The kernel's operands over ``H [n + 1, d]`` (row n the trash row);
    ``patch`` maps vertex -> patched row.  As in the engine, the patch
    also holds a row for the sentinel id n, which no read reaches."""
    n, d = len(in_lists), H.shape[1]
    start, length, col = _csr(in_lists)
    pos = torch.full((n + 1,), -1, dtype=torch.int64)
    rows = []
    for v, row in {**(patch or {}), n: np.full(d, 99.0)}.items():
        pos[v] = len(rows)
        rows.append(row)
    patch_val = torch.tensor(np.array(rows, np.float32).reshape(-1, d))
    need = torch.tensor(need, dtype=torch.bool)
    if C_pre is None:
        C_pre = torch.arange(need.numel(), dtype=torch.int32).reshape(
            need.shape) + 100
    return (need, torch.tensor(aff, dtype=torch.int64), start, length, col,
            torch.tensor(H, dtype=torch.float32), pos, patch_val, C_pre)


def _oracle(args, sign):
    """The pull as a loop over the needed cells."""
    need, aff, start, length, col, H, pos, patch_val, C_pre = args
    RG = torch.zeros(need.shape)
    C = C_pre.clone()
    total = 0
    for r, j in zip(*np.nonzero(need.numpy())):
        v = int(aff[r])
        srcs = col[start[v]:start[v] + length[v]].tolist()
        total += len(srcs)
        best, who = -np.inf, -1
        for u in srcs:
            x = float(patch_val[pos[u], j] if pos[u] >= 0 else H[u, j])
            if sign * x > best or (sign * x == best and u > who):
                best, who = sign * x, u
        RG[r, j], C[r, j] = sign * best, who
    return need, RG, C, total


def _held(got, want):
    MK, RG, C, total = got
    assert torch.equal(MK, want[0])
    assert torch.equal(RG, want[1])       # == treats -0.0 as 0.0
    assert torch.equal(C, want[2])
    assert int(total) == want[3]


def _hand(case):
    """(operands, sign, the cells expected: (row, dim) -> (RG, C))."""
    H = np.zeros((6, 3), np.float32)
    if case == "tie":
        # v0's sources 1 and 2 tie in dim 0 (5.0) and as -0.0 / 0.0 in
        # dim 1: the larger source, 2, is the witness of both
        H[1] = [5.0, -0.0, 7.0]
        H[2] = [5.0, 0.0, 1.0]
        need = [[1, 1, 0]]
        return _args(IN, H, need, [0]), 1, {(0, 0): (5.0, 2),
                                            (0, 1): (0.0, 2)}
    if case == "min":
        # gc-min: the smallest of v4's sources 0..3, one tie at -2.0
        H[:4, 0] = [3.0, -2.0, 4.0, -2.0]
        H[:4, 2] = [-9.0, 0.5, 8.0, 1.0]
        need = [[0, 0, 0], [1, 0, 1]]
        return _args(IN, H, need, [1, 4]), -1, {(1, 0): (-2.0, 3),
                                                (1, 2): (-9.0, 0)}
    if case in ("empty_max", "empty_min"):
        sign = 1 if case == "empty_max" else -1
        need = [[0, 1, 1], [1, 0, 0]]        # v2 has no in-edge; v3 one
        H[4] = [6.0, 6.0, 6.0]
        return _args(IN, H, need, [2, 3]), sign, {
            (0, 1): (sign * -np.inf, -1), (0, 2): (sign * -np.inf, -1),
            (1, 0): (6.0, 4)}
    if case == "patch":
        # v1's sources 0, 3, 4: H says 3 wins, the patch lifts 4 above it
        H[[0, 3, 4], 0] = [1.0, 9.0, 2.0]
        H[[0, 3, 4], 2] = [1.0, 9.0, 2.0]
        need = [[1, 0, 1]]
        return (_args(IN, H, need, [1], patch={4: [10.0, 0.0, 3.0]}), 1,
                {(0, 0): (10.0, 4), (0, 2): (9.0, 3)})
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tie", "min", "empty_max", "empty_min",
                                  "patch"])
def test_shrink_pull_plain_by_hand(case):
    args, sign, cells = _hand(case)
    need, C_pre = args[0], args[-1]
    got = shrink_pull(*args, sign=sign, pd_cap=16, p_cap=64)
    MK, RG, C, total = got
    assert torch.equal(MK, need)
    for (r, j), (s, c) in cells.items():
        assert RG[r, j].item() == s and C[r, j].item() == c, (r, j)
    # cells not needed: RG 0, the witness as it was
    assert (RG[~need] == 0).all() and torch.equal(C[~need], C_pre[~need])
    _held(got, _oracle(args, sign))
    assert int(total) == sum(len(IN[int(v)]) * int(k)
                             for v, k in zip(args[1], need.sum(1)))


@pytest.mark.parametrize("over", ["pairs", "lanes"])
def test_shrink_pull_plain_flags_the_caps(over):
    """The caller's overflow rule, ``need.sum() > pd_cap`` or ``pull_total
    > p_cap``, holds for cells beyond ``pd_cap`` and lanes beyond
    ``p_cap``; with both caps wide enough the same cells fit."""
    H = np.arange(18, dtype=np.float32).reshape(6, 3)
    need = [[1, 1, 1], [1, 0, 1]]            # v4: 4 sources, v1: 3
    args = _args(IN, H, need, [4, 1])
    n_pairs = args[0].sum()
    caps = {"pairs": (4, 64), "lanes": (16, 13)}[over]
    _, _, _, total = shrink_pull(*args, sign=1, pd_cap=caps[0],
                                 p_cap=caps[1])
    assert bool((n_pairs > caps[0]) | (total > caps[1]))
    if over == "lanes":
        assert int(total) == 3 * 4 + 2 * 3
    _, _, _, fit = shrink_pull(*args, sign=1, pd_cap=5, p_cap=18)
    assert not bool((n_pairs > 5) | (fit > 18))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sign", [1, -1])
def test_shrink_pull_plain_against_a_loop(seed, sign):
    """Random in-CSRs, needs and patches, values from a small integer set
    (many ties), padding rows (the sentinel's clamp, nothing needed)."""
    rng = np.random.default_rng(seed)
    n, d, R = 30, 5, 12
    in_lists = [sorted(rng.choice(n, size=rng.integers(0, 7),
                                  replace=False).tolist()) for _ in range(n)]
    H = rng.integers(-2, 3, size=(n + 1, d)).astype(np.float32)
    aff = rng.choice(n, size=R, replace=False)
    need = rng.random((R, d)) < 0.4
    aff[-2:], need[-2:] = n - 1, False
    patch = {int(v): rng.integers(-3, 4, size=d).astype(np.float32)
             for v in rng.choice(n, size=6, replace=False)}
    args = _args(in_lists, H, need, aff, patch=patch)
    _held(shrink_pull_ref(*args, sign=sign, pd_cap=R * d,
                          p_cap=R * d * 7), _oracle(args, sign))
