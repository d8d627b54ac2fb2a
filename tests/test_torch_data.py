"""The port's data pipeline and scorer against the JAX package's (both numpy
on the host; no JAX step is compiled).

Frames come from the synthetic on-disk mini-nuScenes of
`tests/test_data_pipeline.py` at `tiny_model`, training and validation
splits, same seed. With both C++ point libraries switched off (the JAX
package's numpy path; the port's plain versions, `_no_native`), every array
of a frame equals the JAX one exactly but the voxel features, whose means
sum float32 points in another order (JAX: a float64 cumsum) and agree to
1e-6; with both on (each loader's default: the port's library is its own
copy of the JAX one's sources, built with the same flags), every array
equals the JAX one exactly. The JAX frames' `topo_*` planner tables have no
counterpart.
"""
import copy
import itertools
import json
import math
import pickle

import numpy as np
import pytest
import torch

from unidistill_tpu.configs.nuscenes import DataConfig as JaxDataConfig, tiny_model as jax_tiny_model
from unidistill_tpu.data import native as jax_native
from unidistill_tpu.data import detection_eval as jax_eval
from unidistill_tpu.data.collate import DataLoader as JaxDataLoader
from unidistill_tpu.data.dataset import NuScenesDataset as JaxDataset
from unidistill_tpu.data.sampler import InfiniteSampler as JaxInfiniteSampler
from unidistill_tpu.data.evaluate import generate_submission as jax_generate_submission
from unidistill_tpu.data.transforms import normalize_image as jax_normalize_image

from unidistill_torch.configs.nuscenes import CLASS_NAMES, DataConfig, tiny_model
from unidistill_torch.data import detection_eval as port_eval
from unidistill_torch.data import native as port_native
from unidistill_torch.data.collate import DataLoader
from unidistill_torch.data.dataset import NuScenesDataset
from unidistill_torch.data.evaluate import generate_submission
from unidistill_torch.data.sampler import InfiniteSampler
from unidistill_torch.data.transforms import normalize_image

import tests.test_detection_eval as jax_eval_tests
from tests.test_data_pipeline import build_synth_nusc

N_FRAMES = 4
VOXEL_FEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # float32 means summed in another order
NATIVE_TOL = dict(rtol=1e-6, atol=1e-6)  # the C++ library's own rounding (points, images)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and PyTorch's default of one thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return build_synth_nusc(tmp_path_factory.mktemp("nusc_data"), N_FRAMES)


def _datasets(root, split, seed=0, sweeps=2, cbgs=True):
    jd = JaxDataset(JaxDataConfig(root_path=root, num_lidar_sweeps=sweeps, use_cbgs=cbgs),
                    jax_tiny_model(), split, seed=seed)
    pd = NuScenesDataset(DataConfig(root_path=root, num_lidar_sweeps=sweeps, use_cbgs=cbgs),
                         tiny_model(), split, seed=seed)
    return jd, pd


def _no_native(monkeypatch):
    """Both loaders on their numpy paths: the JAX package's library off, and
    each of the port's library functions replaced by its plain version
    (the port has no switch: its loader always runs the library)."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    for name in ("transform_points", "normalize_image", "plan_frame_topology_native"):
        monkeypatch.setattr(port_native, name, getattr(port_native, name.replace("_native", "") + "_plain"))
    monkeypatch.setattr(port_native, "voxelize_mean_sorted_native", port_native.voxelize_mean_sorted_plain)


def assert_frames_equal(pf, jf, native=False):
    assert set(pf) == {k for k in jf if not k.startswith("topo_")}
    for k, jv in jf.items():
        if k.startswith("topo_"):
            continue
        pv = pf[k]
        if k == "meta":
            assert pv == jv
        elif k == "mats":
            assert set(pv) == set(jv)
            for mk in jv:
                np.testing.assert_array_equal(pv[mk], jv[mk], err_msg=mk)
        elif k == "voxel_feats" and not native:
            np.testing.assert_allclose(pv, jv, **VOXEL_FEAT_TOL)
        else:
            assert pv.dtype == jv.dtype, k
            np.testing.assert_array_equal(pv, jv, err_msg=k)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("split", ["training", "validation"])
def test_frames_match_jax(synth_root, split, native, monkeypatch):
    if not native:
        _no_native(monkeypatch)
    jd, pd = _datasets(synth_root, split, seed=3)
    assert len(pd) == len(jd)
    if split == "training":
        assert pd.use_cbgs and pd.sample_indices == jd.sample_indices
    for i in range(len(jd)):
        assert_frames_equal(pd[i], jd[i], native)


def test_eval_frames_carry_no_gt_and_no_bda(synth_root):
    _, pd = _datasets(synth_root, "validation")
    for i in range(len(pd)):
        f = pd[i]
        assert not f["gt_boxes"].any() and f["gt_boxes_raw"].shape == (0, 9)
        np.testing.assert_array_equal(f["mats"]["bda_mat"], np.eye(4, dtype=np.float32))
        # voxelised at the eval cap
        assert f["voxel_coords"].shape[0] == tiny_model().caps.max_voxels_eval


def test_short_sweep_rule(synth_root, monkeypatch):
    """A frame with fewer sweeps than asked for aggregates the ones it has
    (2 of 10 here), not duplicates: the same frame as asking for 2, and
    the same as the JAX dataset's."""
    _no_native(monkeypatch)
    jd, pd = _datasets(synth_root, "validation", sweeps=10)
    _, pd2 = _datasets(synth_root, "validation", sweeps=2)
    for i in range(len(pd)):
        f = pd[i]
        assert_frames_equal(f, jd[i])
        assert_frames_equal(f, pd2[i])
        dts = np.unique(f["points"][f["points_mask"]][:, 4])
        np.testing.assert_allclose(dts, [0.0, 0.05, 0.1], atol=1e-6)


def test_normalize_image_matches_both_jax_paths():
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    for swap in (True, False):
        got = normalize_image(img, mean, std, swap_channels=swap)
        np.testing.assert_array_equal(got, jax_normalize_image(img, mean, std, swap))
        if jax_native.available():
            np.testing.assert_allclose(got, jax_native.normalize_image(img, mean, std, swap), **NATIVE_TOL)


def _batches_equal(pb, jb, native=False):
    """With `native` (both loaders on their C++ libraries) the voxel
    features too are exact."""
    assert set(pb) == {k for k in jb if not k.startswith("topo_")}
    assert [m["token"] for m in pb["meta"]] == [m["token"] for m in jb["meta"]]
    for k in ("points", "points_mask", "imgs", "gt_boxes", "voxel_coords") + (("voxel_feats",) if native else ()):
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    np.testing.assert_allclose(pb["voxel_feats"], jb["voxel_feats"], **VOXEL_FEAT_TOL)
    for mk in jb["mats"]:
        np.testing.assert_array_equal(pb["mats"][mk], jb["mats"][mk], err_msg=mk)


@pytest.mark.parametrize("batch,shuffle,drop_last", [(3, True, True), (3, False, False), (2, True, False)])
def test_loader_batches_match_jax(synth_root, monkeypatch, batch, shuffle, drop_last):
    """num_workers=0: the same batches in the same order as the JAX loader,
    over two epochs (a new permutation each epoch when shuffling)."""
    _no_native(monkeypatch)
    jd, pd = _datasets(synth_root, "training", seed=1, cbgs=False)
    jl = JaxDataLoader(jd, batch, shuffle=shuffle, drop_last=drop_last, num_workers=0, seed=7)
    pl = DataLoader(pd, batch, shuffle=shuffle, drop_last=drop_last, num_workers=0, seed=7)
    assert len(pl) == len(jl)
    for _ in range(2):
        jbs, pbs = list(jl), list(pl)
        assert len(pbs) == len(jbs) == len(jl)
        for pb, jb in zip(pbs, jbs):
            _batches_equal(pb, jb)


def test_a_worker_reads_its_own_infos(synth_root):
    """The dataset a loader worker receives pickles without its infos and
    CBGS indices (small enough for a spawned worker's pipe) and reads them
    again: the same indices and frames."""
    _, pd = _datasets(synth_root, "training", seed=2)
    blob = pickle.dumps(pd)
    assert len(blob) < 64 * 1024
    copy_ = pickle.loads(blob)
    assert copy_.sample_indices == pd.sample_indices and len(copy_.infos) == N_FRAMES
    copy_.rng = np.random.RandomState(9)
    pd.rng = np.random.RandomState(9)
    assert_frames_equal(copy_[1], pd[1])


def test_workers_draw_their_own_augmentations(synth_root):
    """Each worker reseeds the dataset's generator once, when it starts: the
    batch of worker 0 and that of worker 1 draw different IDA and BDA (the
    JAX loader's workers all draw the same numbers), the frames of a batch
    differ, and the persistent workers' second epoch draws anew."""
    _, pd = _datasets(synth_root, "training", cbgs=False)
    torch.manual_seed(0)
    dl = DataLoader(pd, 2, shuffle=False, num_workers=2, seed=0)
    epochs = [list(dl) for _ in range(2)]
    del dl
    for batches in epochs:
        assert [m["token"] for b in batches for m in b["meta"]] == [f"tok{i}" for i in range(N_FRAMES)]
        for b in batches:
            assert not np.array_equal(b["mats"]["bda_mat"][0], b["mats"]["bda_mat"][1])
        # batch i is worker i's: without the reseed the first frame of each
        # draws the same numbers
        for key in ("ida_mats", "bda_mat"):
            assert not np.array_equal(batches[0]["mats"][key][0], batches[1]["mats"][key][0]), key
    assert not np.array_equal(epochs[0][0]["mats"]["ida_mats"], epochs[1][0]["mats"]["ida_mats"])


def test_infinite_sampler_shards_one_stream():
    """The port's one stream is the one the JAX sampler's rank shards
    interleave, shuffled or in order."""
    for shuffle in (True, False):
        stream = list(itertools.islice(InfiniteSampler(7, shuffle=shuffle, seed=3), 28))
        assert sorted(stream[:7]) == list(range(7)) and (stream[:7] != stream[7:14]) == shuffle
        assert stream == list(itertools.islice(JaxInfiniteSampler(7, shuffle=shuffle, seed=3), 28))
        shards = [iter(JaxInfiniteSampler(7, shuffle=shuffle, seed=3, rank=r, world_size=2)) for r in range(2)]
        assert [int(next(shards[i % 2])) for i in range(28)] == stream


# ---- submission and scorer ----------------------------------------------------


LABEL = {"vehicle.car": 0, "vehicle.truck": 1, "human.pedestrian.adult": 8, "movable_object.barrier": 5,
         "movable_object.trafficcone": 9, "vehicle.bicycle": 7}  # 0-based labels of CLASS_NAMES


def _random_infos_and_preds(seed, n_frames=5):
    rng = np.random.RandomState(seed)
    names = ["vehicle.car", "vehicle.truck", "human.pedestrian.adult", "movable_object.barrier",
             "movable_object.trafficcone", "vehicle.bicycle", "animal"]
    attrs = {"vehicle.car": "vehicle.parked", "vehicle.truck": "vehicle.moving",
             "human.pedestrian.adult": "pedestrian.moving", "vehicle.bicycle": "cycle.with_rider"}
    infos, preds = [], []
    for i in range(n_frames):
        n = rng.randint(3, 12)
        gt = np.concatenate([rng.uniform(-45, 45, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                             rng.uniform(0.5, 5, (n, 3)), rng.uniform(-3, 3, (n, 1)),
                             rng.normal(0, 1, (n, 2))], 1)
        gt_names = rng.choice(names, n)
        info = jax_eval_tests._synth_info(f"tok{seed}_{i}", gt, gt_names,
                                          [attrs.get(str(x), "") for x in gt_names],
                                          yaw_ego=rng.uniform(-3, 3), t_ego=tuple(rng.uniform(-100, 100, 3)))
        info["num_lidar_pts"] = rng.randint(0, 3, n)
        infos.append(info)
        m = rng.randint(0, 15)
        of = rng.randint(0, n, m)  # the GT box each prediction is drawn near
        near = gt[of] + np.concatenate(
            [rng.normal(0, 0.7, (m, 3)), rng.normal(0, 0.2, (m, 3)), rng.normal(0, 0.3, (m, 3))], 1)
        near[:, 3:6] = np.abs(near[:, 3:6]) + 0.1
        labels = np.array([LABEL.get(str(gt_names[j]), 0) for j in of], np.int64)
        wrong = rng.rand(m) < 0.2
        labels[wrong] = rng.randint(0, len(CLASS_NAMES), wrong.sum())
        preds.append(dict(boxes=near, scores=rng.uniform(0.05, 1, m), labels=labels))
    return infos, preds


def _same(a, b, path="metrics"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (jax_eval.MetricData, port_eval.MetricData)):
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_submission_and_scores_match_jax(seed, tmp_path):
    infos, preds = _random_infos_and_preds(seed)
    path = generate_submission(preds, infos, str(tmp_path / "port"))
    jpath = jax_generate_submission(preds, infos, str(tmp_path / "jax"))
    with open(path) as f, open(jpath) as g:
        text = f.read()
        assert text == g.read()
    assert sum(len(v) for v in json.loads(text)["results"].values()) == sum(len(p["scores"]) for p in preds)
    got = port_eval.evaluate_submission_native(path, infos, output_path=str(tmp_path / "m.json"))
    _same(got, jax_eval.evaluate_submission_native(path, infos))
    assert got["mean_ap"] > 0


def _checked(name):
    """The port's scorer function `name`, run beside the JAX one on a deep
    copy of the same inputs; the two results must be equal."""
    jfn, pfn = getattr(jax_eval, name), getattr(port_eval, name)

    def both(*args, **kwargs):
        copies = copy.deepcopy((args, kwargs))
        ref = jfn(*args, **kwargs)
        _same(pfn(*copies[0], **copies[1]), ref, name)
        return ref
    return both


@pytest.mark.parametrize("case", sorted(k for k in vars(jax_eval_tests) if k.startswith("test_")))
def test_scorer_cases_match_jax(case, monkeypatch, tmp_path):
    """Every case of the JAX scorer's tests, with each scorer call checked
    against the port's on the same inputs."""
    for name in ("accumulate", "calc_ap", "calc_tp", "evaluate_detection", "evaluate_submission_native",
                 "gt_from_infos", "quaternion_yaw"):
        monkeypatch.setattr(jax_eval_tests, name, _checked(name))
    fn = getattr(jax_eval_tests, case)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()
