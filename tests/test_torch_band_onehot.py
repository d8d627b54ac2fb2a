"""K11's design in plain PyTorch, on the CPU: the order by slab and the
(m16 group, k16 slab) products of `ops/band_gather.onehot_slabs_plain`,
and `onehot_skip_plain`, which runs only those products.

Inputs come from numpy seeds (`mb_gather_pallas.band_layout`) at small
sizes, on layouts that stress the ordering: every row of a block at one
band position, every row clipped to the band's two edges, positions
uniform over a band much wider than R, a ragged last block (S % R, S % 16
and W % 16 nonzero), and the microbenchmark's own draws. The skip product
equals the plain gather bit for bit: each output is a sum of exact f32
products with one nonzero term, rounded once to bf16. (Against the JAX
`variant_onehot` in interpret mode: `test_torch_microbench.py`.)
"""
import numpy as np
import pytest
import torch

from unidistill_torch.experiments.mb_gather_pallas import LAYOUTS, band_layout, make_indices
from unidistill_torch.ops import band_gather as bg

SIZES = {  # layout -> (S, W, R, band)
    "published": (2048, 64, 256, 512),
    "one_position": (1000, 64, 128, 256),
    "edges": (1000, 64, 128, 256),
    "uniform": (1024, 32, 128, 1024),
    "ragged": (1000, 200, 256, 512),
}


def _layout(kind, seed=3):
    S, W, R, band = SIZES[kind]
    tab, idx, w = band_layout(kind, S, W, R, band, seed=seed)
    return tab, idx, w, R, band


def _slab(idx, w, R, band):
    lo = w.repeat_interleave(R)[: idx.shape[0]]
    return (bg.band_source_rows(idx, w, R, band) - lo).long() // bg.ONEHOT_SLAB


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("seed", [3, 4])
def test_skip_product_equals_the_gather(kind, seed):
    tab, idx, w, R, band = _layout(kind, seed)
    got = bg.onehot_skip_plain(tab, idx, w, R, band)
    ref = bg.band_gather_plain(tab, idx, w, R, band)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_order_permutes_each_block_and_its_slabs_cover_every_row(kind):
    """The order is a permutation of each block's rows, slabs ascend in
    each block, and the listed (group, slab) pairs hold every row's slab."""
    tab, idx, w, R, band = _layout(kind)
    S = idx.shape[0]
    order, groups, slabs = bg.onehot_slabs_plain(idx, w, R, band)
    slab = _slab(idx, w, R, band)
    for j in range(-(-S // R)):
        block = order[j * R:(j + 1) * R]
        assert torch.equal(block.sort().values, torch.arange(j * R, min(S, (j + 1) * R)))
        assert (slab[block].diff() >= 0).all()
    nslab = band // bg.ONEHOT_SLAB
    listed = set((groups * nslab + slabs).tolist())
    need = set((torch.arange(S) // bg.ONEHOT_SLAB * nslab + slab[order]).tolist())
    assert need == listed


@pytest.mark.parametrize("kind", LAYOUTS)
def test_products_never_exceed_the_dense_product(kind):
    """At most 16 products a group (one a row) and none past band / 16;
    the total at most the dense product's ceil(S / 16) x band / 16."""
    tab, idx, w, R, band = _layout(kind)
    S = idx.shape[0]
    _, groups, slabs = bg.onehot_slabs_plain(idx, w, R, band)
    nslab, n_groups = band // bg.ONEHOT_SLAB, -(-S // bg.ONEHOT_SLAB)
    per_group = torch.bincount(groups, minlength=n_groups)
    assert per_group.max() <= min(16, nslab) and per_group.min() >= 1
    assert groups.numel() <= n_groups * nslab
    assert ((slabs >= 0) & (slabs < nslab)).all()
    if kind == "one_position":
        assert groups.numel() == n_groups
    if kind == "edges":
        assert per_group.max() <= 2


@pytest.mark.parametrize("kind", LAYOUTS)
def test_products_do_not_depend_on_the_order_of_equal_slabs(kind):
    """The products depend only on the sequence of slabs: ordering the rows
    of one slab in any other way runs the same (group, slab) products."""
    tab, idx, w, R, band = _layout(kind)
    S = idx.shape[0]
    nslab = band // bg.ONEHOT_SLAB
    _, groups, slabs = bg.onehot_slabs_plain(idx, w, R, band)
    key = torch.arange(S) // R * nslab + _slab(idx, w, R, band)
    rng = np.random.default_rng(11)
    for _ in range(3):
        tie = torch.from_numpy(rng.permutation(S))
        order = tie[torch.sort(key[tie], stable=True).indices]
        pairs = torch.unique(torch.arange(S) // bg.ONEHOT_SLAB * nslab + key[order] % nslab)
        assert torch.equal(pairs, groups * nslab + slabs)


def test_products_at_the_published_size():
    """The microbenchmark's draws (S 65536, R 2048, band 4096): 2-4
    products a group, at least 50x fewer than the dense product."""
    idx, w = make_indices(0)
    _, groups, _ = bg.onehot_slabs_plain(idx, w, 2048, 4096)
    n_groups = 65536 // bg.ONEHOT_SLAB
    assert 2 * n_groups <= groups.numel() <= 4 * n_groups
    assert groups.numel() * 50 <= n_groups * (4096 // bg.ONEHOT_SLAB)


def test_band_layout_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="no layout"):
        band_layout("sorted", 256, 8, 128, 256)
