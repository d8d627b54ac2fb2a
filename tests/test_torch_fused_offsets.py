"""K7's host-side logic on the CPU, at tiny shapes: the select as copies
(`ops.fused_offsets.piece_sources`, which the kernel's lane arithmetic
mirrors), which rows take the multiply-add, the work model
(`k7_work`) against a direct count, and the tile the model assumes
against the kernel source's constants. All exact: the copies move bf16
values unchanged, and the counts are integers."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from unidistill_torch.ops import fused_offsets as fo

CSRC = Path(__file__).resolve().parents[1] / "unidistill_torch" / "csrc" / "fused_offsets.cu"


def _one_hots(rng, n):
    """n rows of cases 0-3 as bf16 one-hots, with -0.0 in some zero slots
    and any value in the unused fourth slot."""
    case = rng.integers(0, 4, n)
    oh = (case[:, None] == np.arange(4)).astype(np.float32)
    neg = rng.random((n, 4)) < 0.2
    oh[neg & (oh == 0)] = -0.0
    oh[:, 3] = rng.standard_normal(n)
    return torch.from_numpy(oh).to(torch.bfloat16), case


def _window_from_pieces(g, src):
    """The window K7's copies assemble: piece j takes 8 lanes of g from
    src[j], or zeros where src[j] is -1."""
    rows, npieces = src.shape
    lanes = src[:, :, None] + torch.arange(8)  # [rows, pieces, 8]
    got = torch.gather(g.float(), 1, lanes.clamp(min=0).reshape(rows, -1)).reshape(rows, npieces, 8)
    return torch.where((src >= 0)[:, :, None], got, torch.zeros(())).reshape(rows, -1)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_piece_copies_assemble_the_case_window(C):
    """For every case 0-3 the copies give `_select_window` bit for bit;
    case 2's pieces below lane 4C and every piece of case 3 are zeros."""
    rng = np.random.default_rng(C)
    oh, case = _one_hots(rng, 64)
    assert set(case) == {0, 1, 2, 3}
    g = torch.from_numpy(rng.standard_normal((64, 10 * C))).to(torch.bfloat16)
    src, general = fo.piece_sources(oh, C)
    assert src.shape == (64, 6 * C // 8) and not general.any()
    assert torch.equal(_window_from_pieces(g, src), fo._select_window(g, oh))
    zero = src < 0
    assert zero[torch.from_numpy(case == 3)].all()
    assert torch.equal(zero[torch.from_numpy(case == 2)],
                       (torch.arange(0, 6 * C, 8) < 4 * C).expand(int((case == 2).sum()), -1))
    assert not zero[torch.from_numpy(case < 2)].any()


def test_rows_that_are_not_one_hot_take_the_multiply_add():
    """A row takes the multiply-add unless its first three one-hot values
    are one 1.0 and zeros of either sign, or all zeros; the fourth value
    is never read."""
    rows = [[1, 0, 0, 0], [0, 1, 0, 7], [-0.0, 0, 1, 0], [0, 0, 0, 1], [0, -0.0, 0, 0],
            [1, 1, 0, 0], [0.5, 0, 0, 0], [0, 0, 2, 0], [1, 0, 1e-3, 0], [-1, 0, 0, 0], [float("nan"), 0, 0, 0]]
    oh = torch.tensor(rows).to(torch.bfloat16)
    src, general = fo.piece_sources(oh, 16)
    assert general.tolist() == [False] * 5 + [True] * 6
    assert src[0, 0] == 0 and src[1, 0] == 64 and src[2, 8] == 0 and (src[3:5] < 0).all()


def _direct_work(oh, C, co4, tile_rows):
    m = oh.float().numpy()
    B, _, S, _ = m.shape
    g_lanes = window_lanes = 0
    for m0, m1, m2, _ in m.reshape(-1, 4):
        g_set, w_set = set(), set()
        if m0 != 0:
            g_set |= set(range(0, 6 * C))
            w_set |= set(range(0, 6 * C))
        if m1 != 0:
            g_set |= set(range(4 * C, 10 * C))
            w_set |= set(range(0, 6 * C))
        if m2 != 0:
            g_set |= set(range(0, 2 * C))
            w_set |= set(range(4 * C, 6 * C))
        g_lanes += len(g_set)
        window_lanes += len(w_set)
    w8 = 8 * 6 * C * co4 * 2
    return dict(g_lanes=g_lanes, window_lanes=window_lanes,
                hbm_bytes=g_lanes * 2 + oh.numel() * 2 + w8 + B * S * co4 * 4,
                ops=2 * window_lanes * co4, w8_l2_bytes=B * -(-S // tile_rows) * w8)


@pytest.mark.parametrize("tile_rows", [128, 256])
def test_k7_work_matches_a_direct_count(tile_rows):
    """The work model on one-hots of every case and on rows that are not
    one-hot, against a count lane by lane."""
    rng = np.random.default_rng(tile_rows)
    B, S, C, co4 = 2, 300, 16, 64
    oh, _ = _one_hots(rng, B * 8 * S)
    oh = oh.reshape(B, 8, S, 4).clone()
    pick = torch.from_numpy(rng.random((B, 8, S)) < 0.1)
    oh[pick] = torch.from_numpy(rng.standard_normal((int(pick.sum()), 4)) * (rng.random((int(pick.sum()), 4)) < 0.6)).to(
        torch.bfloat16)
    assert fo.k7_work(oh, C, co4, tile_rows) == _direct_work(oh, C, co4, tile_rows)


def test_tile_rows_are_the_kernels():
    """`K7_TILE_ROWS` (the work model's sites a tile) is 64 x the m64
    tiles a consumer owns x the consumer warpgroups, as the kernel source
    sets them."""
    text = CSRC.read_text()
    consumers = int(re.search(r"constexpr int kK7Consumers = (\d+);", text).group(1))
    m64 = re.search(r"constexpr int k7_m64\(int n\) \{ return n == (\d+) \? (\d+) : (\d+); \}", text)
    for co4, rows in fo.K7_TILE_ROWS.items():
        tiles = int(m64.group(2)) if co4 == int(m64.group(1)) else int(m64.group(3))
        assert rows == 64 * tiles * consumers, co4
    assert set(fo.K7_TILE_ROWS) == set(fo.K7_CO4)
