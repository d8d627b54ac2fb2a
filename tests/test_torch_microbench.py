"""The chunked sparse-conv microbenchmark path of the port against the JAX
package and its experiment scripts, on the CPU.

The port's kernels K7-K11 run their plain versions here (CPU tensors); the
JAX side runs the real Pallas kernels T4-T8 of `experiments/` in TPU
interpret mode. Inputs come from numpy seeds.

Tolerances: the port's voxeliser (`ops/voxelize.py` on a host frame)
against the JAX host voxeliser's coordinates exactly and its features
within 1e-6 (float32 sums in another order); the planner's tables, the
realistic inputs, the band gathers (T6 unroll 1 and 4, T7, T8; T8 also
against K11's skip product, `onehot_skip_plain`) and the smoke kernel (T5)
exactly; `fused_offsets` (T4) within 1e-5 of max |ref| (the same exact
bf16 products summed in f32 in another order; rows whose one-hot is not a
single 1.0 select in the same bf16 arithmetic in both); the chunked
subm conv in float32 within 1e-5 of max |ref| (sums in another order) and
in bfloat16 within 2e-2 of max |ref| (a sum in another order may flip a
bf16 rounding, 2^-8 of a value, and the per-offset bf16 sums carry it);
`fused_subm` against the JAX one and against the separate path within 2e-2
of max |ref|: the separate path rounds each offset's sum to bf16 (8
roundings of at most half an ulp), the fused one only the f32 total.
"""
import contextlib
import importlib
import os
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.data import native as jax_native
from unidistill_tpu.data.topology_host import plan_frame_topology_numpy
from unidistill_tpu.data.voxelize_host import voxelize_frame as jax_voxelize_frame
from unidistill_tpu.ops import sparse_conv_chunked as jscc

from unidistill_torch.configs.nuscenes import lidar_exp, tiny_model
from unidistill_torch.data.topology_host import plan_frame_topology
from unidistill_torch.experiments import mb_gather_pallas as pgather
from unidistill_torch.experiments.realistic import realistic_cloud, realistic_inputs, voxelize_frame
from unidistill_torch.ops import band_gather as bg
from unidistill_torch.ops import fused_offsets as fo
from unidistill_torch.ops import sparse_conv_chunked as scc

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
# the sibling scripts each experiment script imports by bare name
_EXPERIMENT_DEPS = {
    "mb_subm_banded": ("mb_flat_subm", "occupancy_profile"),
    "mb_pallas_fused": ("mb_flat_subm", "occupancy_profile", "mb_subm_banded"),
}


def _experiment(name):
    """Import a JAX experiment script from this checkout's `experiments/`.

    The scripts put fixed directories on `sys.path` and may set a
    compilation-cache environment default at import. Each script and the
    siblings it imports are loaded here first, in dependency order, with
    only this checkout's `experiments/` put before the path; then the path
    and the environment are taken back."""
    saved, had = list(sys.path), "JAX_COMPILATION_CACHE_DIR" in os.environ
    try:
        for dep in (*_EXPERIMENT_DEPS.get(name, ()), name):
            sys.path[:] = [str(EXPERIMENTS), *saved]
            mod = importlib.import_module(dep)
            assert Path(mod.__file__).resolve().parent == EXPERIMENTS, mod.__file__
    finally:
        sys.path[:] = saved
        if not had:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return mod


def test_experiment_scripts_load_from_this_checkout():
    """`_experiment` leaves `sys.path` as it was, and every experiment script
    it loads comes from this checkout."""
    before = list(sys.path)
    for name in ("mb_gather_pallas", "mb_subm_banded", "mb_pallas_fused"):
        _experiment(name)
    assert sys.path == before
    for name in ("mb_flat_subm", "occupancy_profile", "mb_subm_banded", "mb_pallas_fused",
                 "mb_gather_pallas"):
        assert Path(sys.modules[name].__file__).resolve().parent == EXPERIMENTS, name


def _bf16_bits(x):
    """A bf16 array of either framework as uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _to_jax(t):
    """torch tensor -> jax array of the same dtype (bf16 through f32, exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@contextlib.contextmanager
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# ---- host voxeliser and planner ----------------------------------------------


def _clouds():
    rng = np.random.RandomState(7)
    sparse = np.zeros((3000, 5), np.float32)
    sparse[:, 0:2] = rng.uniform(-52, 52, (3000, 2))
    sparse[:, 2] = rng.uniform(-4.5, 2.5, 3000)
    return {"realistic": realistic_cloud(np.random.RandomState(3)), "sparse": sparse}


@pytest.mark.parametrize("cloud", ["realistic", "sparse"])
@pytest.mark.parametrize("training", [False, True])
def test_voxelize_frame_matches_jax(cloud, training, monkeypatch):
    """The port's voxeliser (`ops.voxelize`) on one host frame against both
    paths of the JAX host voxeliser: coordinates equal; features (means of
    float32 points summed in another order) within float32 round-off."""
    pts = _clouds()[cloud]
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    cfg, jcfg = tiny_model(with_camera=False), jax_tiny_model(with_camera=False)
    feats, coords = voxelize_frame(pts, mask, cfg, training)
    assert (coords[:, 0] >= 0).sum() > 100
    for native in (True, False):
        if not native:
            monkeypatch.setattr(jax_native, "voxelize_mean_sorted_native", lambda *a, **k: None)
        jf, jc = jax_voxelize_frame(pts, mask, jcfg, training)
        np.testing.assert_array_equal(coords, jc)
        np.testing.assert_allclose(feats, jf, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cloud,s0_cap", [("realistic", None), ("sparse", None), ("realistic", 600)])
def test_planner_matches_jax(cloud, s0_cap):
    """The tiny model's grid (80x80x40, stage caps 1024/512): every table of
    the JAX numpy planner but the backward's reverse tables, integer-equal."""
    cfg = tiny_model(with_camera=False)
    _, coords = voxelize_frame(_clouds()[cloud], np.ones(len(_clouds()[cloud]), bool), cfg, False)
    caps = cfg.lidar_encoder.stage_voxel_caps
    got = plan_frame_topology(coords, cfg.grid_size, caps, s0_cap=s0_cap)
    ref = plan_frame_topology_numpy(coords, cfg.grid_size, caps, s0_cap=s0_cap)
    assert set(ref) - set(got) == {"rev2", "rev3"} and set(got) <= set(ref)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    if s0_cap is not None:
        assert int(got["s0_dropped"]) > 0


def test_realistic_inputs_match_the_jax_harness(monkeypatch):
    """`realistic_inputs` at the published size (two of the four frames)
    equals the JAX harness's `realistic_stage_inputs` bit for bit (tables,
    occupancy, features, weights), planning each frame once for both
    stages."""
    harness = _experiment("mb_subm_banded")
    monkeypatch.setattr(harness, "B", 2)
    ours, _ = realistic_inputs(lidar_exp().model, ("s0", "s2"), batch=2)
    for stage in ("s0", "s2"):
        feats, occ, ck, ch, vd, tb, w, S, C = harness.realistic_stage_inputs(stage)
        x = ours[stage]
        assert (x.S, x.C) == (S, C)
        np.testing.assert_array_equal(_bf16_bits(x.feats), _bf16_bits(feats))
        for name, a, b in (("occ", x.occ_bits, occ), ("ck", x.colkey, ck), ("ch", x.chunk, ch),
                           ("valid", x.valid, vd), ("idx", x.tables.nbr_idx, tb.nbr_idx),
                           ("case", x.tables.nbr_case, tb.nbr_case), ("w", x.weight, w)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{stage} {name}")


# ---- band gathers: T6 (fori, unroll 1 and 4), T7 (take), T8 (onehot) -----------

GATHER_SIZES = [(2048, 128, 256, 512), (1024, 64, 128, 256)]


@pytest.mark.parametrize("S,W,R,band", GATHER_SIZES, ids=["S2048", "S1024"])
def test_band_gathers_match_pallas(S, W, R, band, monkeypatch):
    jg = _experiment("mb_gather_pallas")
    for name, v in (("S", S), ("W", W), ("R", R), ("BAND", band), ("NBLK", S // R)):
        monkeypatch.setattr(jg, name, v)
    jtab, jidx, jw = jg.make_inputs()
    tab, idx, w = pgather.make_inputs(0, S, W, R, band)
    np.testing.assert_array_equal(_bf16_bits(tab), _bf16_bits(jtab))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    ref = _bf16_bits(np.asarray(jtab)[np.asarray(jidx)])
    ours = {
        "fori": bg.band_gather_fori(tab, idx, w, R, band, unroll=1),
        "fori4": bg.band_gather_fori(tab, idx, w, R, band, unroll=4),
        "take": bg.band_gather_take(tab, idx, w, R, band),
        "onehot": bg.band_gather_onehot(tab, idx, w, R, band),
    }
    pallas = {"fori": lambda: jg.variant_fori(1), "fori4": lambda: jg.variant_fori(4),
              "take": jg.variant_take, "onehot": jg.variant_onehot}
    with _interpret():
        for name, make in pallas.items():
            got = _bf16_bits(make()(jtab, jidx, jw))
            np.testing.assert_array_equal(got, ref, err_msg=f"pallas {name}")
            np.testing.assert_array_equal(_bf16_bits(ours[name]), got, err_msg=name)
            if name == "onehot":  # K11's skip product: only the (group, slab) products it runs
                np.testing.assert_array_equal(_bf16_bits(bg.onehot_skip_plain(tab, idx, w, R, band)), got,
                                              err_msg="onehot skip product")


def test_band_gather_clips_into_the_band():
    """Indices outside a block's band read its nearest band row."""
    tab = torch.arange(40 * 3, dtype=torch.float32).reshape(40, 3).to(torch.bfloat16)
    idx = torch.tensor([0, 39, 5, 12, 20, 2, 39, 33], dtype=torch.int32)
    w = torch.tensor([4, 30], dtype=torch.int32)
    out = bg.band_gather_plain(tab, idx, w, R=4, band=8)
    assert bg.band_source_rows(idx, w, 4, 8).tolist() == [4, 11, 5, 11, 30, 30, 37, 33]
    assert torch.equal(out, tab[[4, 11, 5, 11, 30, 30, 37, 33]])
    for fn in (bg.band_gather_take, bg.band_gather_onehot):
        assert torch.equal(fn(tab, idx, w, 4, 8), out)


# ---- T5: the smoke kernel -----------------------------------------------------


def test_smoke_matches_pallas(capsys):
    jf = _experiment("mb_pallas_fused")
    with _interpret():
        jf.smoke()
    assert "pallas smoke: 5.0 (want 5.0)" in capsys.readouterr().out
    assert fo.smoke("cpu") == 5.0
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 96)) * 4).to(torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((64, 96)) * 2.0 ** rng.integers(-20, 20, (64, 96))).to(
        torch.bfloat16)
    ref = _to_jax(x) * 2.0 + _to_jax(y)
    np.testing.assert_array_equal(_bf16_bits(fo.smoke_plain(x, y)), _bf16_bits(ref))
    np.testing.assert_array_equal(_bf16_bits(fo.axpy2(x, y)), _bf16_bits(ref))


# ---- T4: fused select + products ---------------------------------------------


def _fused_inputs(B, S, C, co, seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((B, 8, S, 10 * C)) * 0.1).to(torch.bfloat16)
    case = rng.integers(0, 3, (B, 8, S))
    oh = torch.from_numpy(case[..., None] == np.arange(4)).to(torch.bfloat16)
    W8 = torch.from_numpy(rng.standard_normal((8, 6 * C, 4 * co)) * 0.05).to(torch.bfloat16)
    return g, oh, W8


@pytest.mark.parametrize("B,S,C", [(1, 512, 16), (2, 1024, 32)])
def test_fused_offsets_matches_pallas(B, S, C):
    jf = _experiment("mb_pallas_fused")
    g, oh, W8 = _fused_inputs(B, S, C, C, seed=B)
    with _interpret():
        ref = np.asarray(jf.fused_offsets(_to_jax(g), _to_jax(oh), _to_jax(W8), C, C))
    got = fo.fused_offsets(g, oh, W8)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, 4 * C)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("C", [16, 32])
def test_fused_offsets_matches_pallas_on_rows_that_are_not_one_hot(C):
    """Rows whose one-hot is not a single 1.0 (random multipliers, two
    1.0s, 0.5, -1) beside one-hot rows: the plain version's select in bf16
    arithmetic, each product and sum rounded as the Pallas kernel rounds
    them, so the windows agree and only the f32 sums' order differs."""
    jf = _experiment("mb_pallas_fused")
    g, oh, W8 = _fused_inputs(1, 512, C, C, seed=C + 1)
    rng = np.random.default_rng(C)
    kinds = [rng.standard_normal(4), [1, 1, 0, 0], [0, 0.5, 0, 0], [0, 1, -1, 0], [1, 1, 1, 0]]
    pick = rng.random((1, 8, 512)) < 0.5
    oh = oh.float().numpy()
    for n, (o, s) in enumerate(zip(*np.nonzero(pick[0]))):
        oh[0, o, s] = kinds[n % len(kinds)]
    oh = torch.from_numpy(oh).to(torch.bfloat16)
    assert fo.piece_sources(oh, C)[1].sum() == pick.sum()
    with _interpret():
        ref = np.asarray(jf.fused_offsets(_to_jax(g), _to_jax(oh), _to_jax(W8), C, C))
    got = fo.fused_offsets(g, oh, W8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fused_offsets_select_is_the_case_window():
    """The multiply-add select equals the chunked layout's case select."""
    g, oh, _ = _fused_inputs(1, 64, 16, 16, seed=9)
    case = oh.float().argmax(-1)
    ref = scc._extract_subm_window(g.reshape(-1, 160), case.reshape(-1), 16)
    assert torch.equal(fo._select_window(g, oh).reshape(-1, 96).to(torch.bfloat16), ref)


# ---- the chunked subm conv: prod and fused -----------------------------------


@pytest.fixture(scope="module")
def tiny_stages():
    return realistic_inputs(tiny_model(with_camera=False), batch=2)[0]


def _jax_args(x):
    return (_to_jax(x.feats), _to_jax(x.occ_bits), _to_jax(x.colkey), _to_jax(x.chunk),
            _to_jax(x.valid), _to_jax(x.weight))


def _jax_tables(x):
    return jscc.ChunkedTables(_to_jax(x.tables.nbr_idx), _to_jax(x.tables.nbr_case), None)


def _close(got, ref, tol):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("stage", ["s0", "s2", "s3"])
@pytest.mark.parametrize("mode", ["select", "case_view"])
def test_subm_impl_matches_jax(tiny_stages, stage, mode, monkeypatch):
    """The JAX function reads its mode from the environment at trace time."""
    x = tiny_stages[stage]
    monkeypatch.setenv("UNIDISTILL_SUBM_MODE", mode)
    bias = torch.from_numpy(np.random.default_rng(1).standard_normal(x.C) * 0.1).float()
    for dtype, reverse, tol in (("float32", False, 1e-5), ("float32", True, 1e-5),
                                ("bfloat16", False, 2e-2)):
        ref = jax.jit(partial(jscc._subm_impl, dtype_str=dtype, reverse=reverse))(
            *_jax_args(x), _to_jax(bias), _jax_tables(x))
        got = scc._subm_impl(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight, bias,
                             x.tables, dtype, reverse=reverse, mode=mode)
        assert got.dtype == getattr(torch, dtype)
        _close(got, ref, tol)


def test_subm_mode_rule_matches_jax(monkeypatch):
    monkeypatch.delenv("UNIDISTILL_SUBM_MODE", raising=False)
    for S, C in ((131072, 16), (98304, 32), (57344, 64), (2048, 16), (400000, 32)):
        assert scc.subm_mode(S, C) == jscc._subm_mode(S, C)


@pytest.mark.parametrize("stage", ["s0", "s2", "s3"])
def test_fused_subm_matches_jax(tiny_stages, stage):
    """On the first frame (T4 in interpret mode takes a while a grid step)."""
    jf = _experiment("mb_pallas_fused")
    x = tiny_stages[stage]
    x = x._replace(**{k: getattr(x, k)[:1] for k in ("feats", "occ_bits", "colkey", "chunk", "valid")},
                   tables=scc.ChunkedTables(x.tables.nbr_idx[:1], x.tables.nbr_case[:1]))
    with _interpret():
        ref = jf.fused_subm(*_jax_args(x), _jax_tables(x), x.C, x.C, jnp.bfloat16)
    got = fo.fused_subm(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight, x.tables, x.C, x.C)
    assert got.dtype == torch.bfloat16
    _close(got, ref, 2e-2)
    prod = scc._subm_impl(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight, None,
                          x.tables, "bfloat16")
    _close(got, prod.float(), 2e-2)


def test_window_table_matches_jax(tiny_stages):
    x = tiny_stages["s2"]
    ref = jscc._window_table(*_jax_args(x)[:5], False, jnp.float32)
    got = scc._window_table(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    w3 = scc._w_zyx(x.weight)
    for window, zstride in ((6, 1), (9, 2)):
        ref = jscc._band_weight(_to_jax(w3), x.C, x.C, window, zstride, jnp.float32)
        np.testing.assert_array_equal(
            scc._band_weight(w3, x.C, x.C, window, zstride, torch.float32).numpy(), np.asarray(ref))
