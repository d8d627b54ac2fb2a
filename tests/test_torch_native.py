"""The port's host C++ library (`unidistill_torch/data/native.py`, built
from `unidistill_torch/csrc/host/`) against the JAX package's
`data/native.py` with its own library built (`runtime/`), and against the
port's plain versions, on seeded clouds and images:

  * against the JAX library every function is bit-equal (the same sources,
    compiled with the same flags);
  * against its plain version, each as the JAX tests hold the C++ to numpy
    (`tests/test_native_runtime.py`, `tests/test_voxelize_host.py`,
    `tests/test_topology_host.py`): the box test, the planner, the voxel
    coordinates and the range filter's mask exact; transformed points 1e-5,
    voxel means 1e-6, normalised images 1e-4;
  * the loader over a synthetic nuScenes (`serving.synthetic.write_nuscenes`,
    two frames) gives the JAX loader's batches, every array exact;
  * the build: concurrent builders make one library; a source that does
    not compile raises.
"""
import multiprocessing

import numpy as np
import pytest
import torch

from unidistill_tpu.configs.nuscenes import DataConfig as JaxDataConfig, tiny_model as jax_tiny_model
from unidistill_tpu.data import native as jax_native
from unidistill_tpu.data.collate import DataLoader as JaxDataLoader
from unidistill_tpu.data.dataset import NuScenesDataset as JaxDataset

from unidistill_torch.configs.nuscenes import DataConfig, tiny_model
from unidistill_torch.data import native
from unidistill_torch.data.collate import DataLoader
from unidistill_torch.data.dataset import NuScenesDataset
from unidistill_torch.kernels import build
from unidistill_torch.ops.voxelize import voxelize_frame

from tests.test_torch_data import _batches_equal

CFG = tiny_model(with_camera=False)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    assert jax_native.available(), "the JAX package's library must build for these comparisons"
    assert native.available()


def cloud(seed, n=6000, width=5):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, width), np.float32)
    pts[:, 0:2] = rng.uniform(-60, 60, (n, 2))
    pts[:, 2] = rng.uniform(-5, 3, n)
    pts[:, 3] = rng.uniform(0, 255, n)
    if width > 4:
        pts[:, 4] = rng.choice(np.arange(10) * 0.05, n)
    return pts


def pose(seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-np.pi, np.pi)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = rng.uniform(-5, 5, 3)
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_points(seed):
    pts, m = cloud(seed), pose(seed)
    got = native.transform_points(pts.copy(), m, 0.35)
    np.testing.assert_array_equal(got, jax_native.transform_points(pts.copy(), m, 0.35))
    np.testing.assert_allclose(got, native.transform_points_plain(pts.copy(), m, 0.35), rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 4] == np.float32(0.35))


@pytest.mark.parametrize("cap", [2000, 10000])
def test_range_filter_pad(cap):
    pts, rng = cloud(2), CFG.point_cloud_range
    out, mask, n = native.range_filter_pad(pts, rng, cap)
    ref = jax_native.range_filter_pad(pts, rng, cap)
    np.testing.assert_array_equal(out, ref[0])
    np.testing.assert_array_equal(mask, ref[1])
    assert n == ref[2]
    p_out, p_mask, p_n = native.range_filter_pad_plain(pts, rng, cap)
    assert n == p_n and (n == cap) == (cap == 2000)
    np.testing.assert_array_equal(mask, p_mask)
    np.testing.assert_allclose(out[:n], p_out[:n])
    assert np.abs(out[n:]).sum() == 0


def test_points_in_rbbox():
    pts = cloud(3)
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.uniform(-40, 40, (30, 2)), rng.uniform(-2, 0, (30, 1)),
                            rng.uniform(1, 8, (30, 3)), rng.uniform(-np.pi, np.pi, (30, 1)),
                            rng.randn(30, 2)], 1).astype(np.float32)
    got = native.points_in_rbbox(pts, boxes)
    assert got.shape == (30, len(pts)) and got.sum() > 0
    np.testing.assert_array_equal(got, jax_native.points_in_rbbox(pts, boxes))
    np.testing.assert_array_equal(got, native.points_in_rbbox_plain(pts, boxes))


def test_host_voxelizer():
    pts = cloud(5, n=3000)
    args = (CFG.point_cloud_range, CFG.voxel_size, CFG.grid_size, 500, 4)
    got = native.HostVoxelizer(*args)(pts)
    ref = jax_native.HostVoxelizer(*args)(pts)
    plain = native.HostVoxelizer(*args).plain(pts)
    assert len(got[1]) == 500  # the cap binds
    for a, b, c in zip(got, ref, plain):
        np.testing.assert_array_equal(a, b)
    for i, (a, c) in enumerate(zip(got, plain)):
        (np.testing.assert_allclose if i == 0 else np.testing.assert_array_equal)(a, c)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("n", [6000, 100])
def test_voxelize_mean_sorted(n, training):
    from unidistill_tpu.data.voxelize_host import voxelize_frame as jax_voxelize_frame

    pts = cloud(6 + n, n=n)
    mask = np.ones(n, bool)
    mask[::5] = False
    feats, coords = voxelize_frame(pts, mask, CFG, training)
    jf, jc = jax_voxelize_frame(pts, mask, jax_tiny_model(with_camera=False), training)
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(coords, jc)
    caps = CFG.caps
    cap = caps.max_voxels_train if training else caps.max_voxels_eval
    for cap, max_pts in ((cap, caps.max_points_per_voxel), (64, 3)):  # the frame's caps, then binding ones
        args = (pts[mask], CFG.point_cloud_range, CFG.voxel_size, CFG.grid_size, cap, max_pts)
        (nf, nc), (pf, pc) = native.voxelize_mean_sorted_native(*args), native.voxelize_mean_sorted_plain(*args)
        np.testing.assert_array_equal(nc, pc)
        np.testing.assert_allclose(nf, pf, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s0_cap", [None, 600])
def test_plan_frame_topology(s0_cap):
    from unidistill_torch.data.topology_host import plan_frame_topology

    _, coords = voxelize_frame(cloud(7, n=4000), np.ones(4000, bool), CFG, False)
    caps = CFG.lidar_encoder.stage_voxel_caps
    got = native.plan_frame_topology_native(coords, CFG.grid_size, caps, s0_cap=s0_cap)
    ref = jax_native.plan_frame_topology_native(coords, CFG.grid_size, caps, s0_cap=s0_cap)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    plain = native.plan_frame_topology_plain(coords, CFG.grid_size, caps, s0_cap=s0_cap)
    assert set(got) - set(plain) == {"rev2", "rev3"}
    for k, v in plain.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    wired = plan_frame_topology(coords, CFG.grid_size, caps, s0_cap=s0_cap)
    assert set(wired) == set(plain)
    assert (int(got["s0_dropped"]) > 0) == (s0_cap is not None)


@pytest.mark.parametrize("swap", [True, False])
def test_normalize_image(swap):
    img = np.random.RandomState(8).randint(0, 256, (900, 1600, 3)).astype(np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    got = native.normalize_image(img, mean, std, swap)
    np.testing.assert_array_equal(got, jax_native.normalize_image(img, mean, std, swap))
    np.testing.assert_allclose(got, native.normalize_image_plain(img, mean, std, swap), rtol=1e-5, atol=1e-4)
    f = img.astype(np.float32)  # not uint8: the numpy path, as in JAX
    np.testing.assert_array_equal(native.normalize_image(f, mean, std, swap),
                                  native.normalize_image_plain(f, mean, std, swap))


@pytest.fixture(scope="module")
def full_width_root(tmp_path_factory):
    from unidistill_torch.serving.synthetic import write_nuscenes

    return write_nuscenes(str(tmp_path_factory.mktemp("nusc_native")), 2, 1, 0)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_loader_frames_equal_the_jax_loaders(full_width_root, split):
    """A synthetic nuScenes frame at full width (a 10-sweep cloud, two of
    its six 900×1600 images at the tiny model's input), each loader on its
    library: the batches are equal, every array exact."""
    train = split == "training"
    dcfg = dict(root_path=full_width_root, num_lidar_sweeps=10, use_cbgs=False)
    jl = JaxDataLoader(JaxDataset(JaxDataConfig(**dcfg), jax_tiny_model(), split, seed=1), 1, shuffle=train,
                       num_workers=0, seed=7)
    pl = DataLoader(NuScenesDataset(DataConfig(**dcfg), tiny_model(), split, seed=1), 1, shuffle=train, seed=7)
    n = 0
    for pb, jb in zip(pl, jl):
        _batches_equal(pb, jb, native=True)
        assert pb["points_mask"].sum() == tiny_model().caps.max_points  # the 10-sweep cloud fills the cap
        n += 1
    assert n == len(jl) == (2 if train else 1)


def test_concurrent_builds_make_one_library(tmp_path):
    """Three processes build into one empty directory at once: one
    library, no temporary file left."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        names = pool.map(_build_and_load, [tmp_path] * 3)
    assert len(set(names)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([names[0], "hostprep.lock"])


def _build_and_load(build_dir):
    build.BUILD_DIR = build_dir
    build.host_library()
    return build.host_library_path().name


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in build.HOST_SOURCES:
        (src / f"{name}.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "HOST_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_HOST_LIB", {})
    with pytest.raises(RuntimeError, match="failed to build"):
        build.host_library()
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())
