"""The port's data parallelism against the JAX package's `dp` mesh, on the
CPU: the port's side runs on two gloo ranks spawned by
`parallel.launch.run_ranks` (rank-side functions in
`tests/test_torch_parallel_cli.py`, which imports no JAX), the JAX side
`shard_map`'d over `make_mesh(dp=2)`, two of the eight virtual CPU devices
that `tests/conftest.py` forces.

  * the six loss normalisers (focal, box regression, IoU; feature, BEV
    relation, response): a batch of 4 split 2 + 2; each rank's loss from
    its half equals the JAX device's under `pmean`, rtol 1e-5 (the pattern
    of `tests/test_losses_decode.py`); cases with positives on both halves,
    none on one half, and (focal) none at all;
  * the camera<-LiDAR distill step, tiny, float32, BatchNorms tamed (the
    case of `tests/test_torch_distill.py` at batch 4), one JAX compile: the
    loss and every metric rtol 1e-4 (the loss `pmean`'d; the others rank
    0's and device 0's); the averaged gradients within 2e-3 of their scale;
    rank 0's BatchNorm statistics rtol 1e-4, atol 1e-5; both ranks'
    parameters bit-equal;
  * the loader: rank r's frames are rows [r·b, (r+1)·b) of the JAX loader's
    global batches of b × 2, shuffled or not, over two epochs; a short last
    global batch loses no frame and repeats none; the rank-striding sampler
    equals the JAX one (numpy oracles, no compile);
  * the eval gather's interleave and passthrough equal the JAX package's.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from unidistill_tpu.configs.nuscenes import AssignerConfig as JaxAssignerConfig
from unidistill_tpu.configs.nuscenes import DISTILL_VARIANTS as JAX_VARIANTS
from unidistill_tpu.configs.nuscenes import DataConfig as JaxDataConfig, tiny_model as jax_tiny_model
from unidistill_tpu.data.collate import DataLoader as JaxDataLoader
from unidistill_tpu.data.dataset import NuScenesDataset as JaxDataset
from unidistill_tpu.data.sampler import InfiniteSampler as JaxInfiniteSampler
from unidistill_tpu.losses import det as jdet
from unidistill_tpu.losses import distill as jdist
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.parallel import mesh as jax_mesh
from unidistill_tpu.targets.assigner import assign_targets as jax_assign
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import TASKS, DataConfig, TrainConfig, tiny_model
from unidistill_torch.data.collate import DataLoader
from unidistill_torch.data.dataset import NuScenesDataset
from unidistill_torch.data.sampler import InfiniteSampler
from unidistill_torch.parallel import mesh as parallel
from unidistill_torch.parallel.launch import run_ranks
from unidistill_torch.training.jax_weights import state_dict_from_jax

from tests.test_data_pipeline import build_synth_nusc
from tests.test_torch_assigner_losses import CFG, random_gt, random_heads
from tests.test_torch_data import _no_native, assert_frames_equal
from tests.test_torch_lidar_detector import RAISED_CAPS, point_batch
from tests.test_torch_parallel_cli import (
    THREADS, WORLD_TIMEOUT_S, distill_step_on_ranks, from_numpy, rank_losses, to_numpy)
from tests.test_torch_train_step import CLIP, LR, WD, capturing, grad_scales, jax_params, train_batch_np
from tests.test_torch_weights import randomize

RTOL, ATOL = 1e-5, 1e-6
B, RANK_B = 4, 2
PAIR = ("lidar", "camera")
CASES = ("both_halves", "one_half_empty")
SPLIT_FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def mesh2():
    return jax_mesh.make_mesh(dp=2)


def per_device(fn, *args):
    """`fn` under `shard_map` on the 2-device `dp` mesh, each argument split
    on axis 0; returns each device's result, stacked on a leading axis."""
    f = jax.jit(jax.shard_map(lambda *a: jax.tree.map(lambda x: x[None], fn(*a)), mesh=mesh2(),
                              in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    return jax.tree.map(np.asarray, f(*jax.tree.map(jnp.asarray, args)))


# ---- (a) the six normalisers -------------------------------------------------


@functools.lru_cache(maxsize=None)
def loss_inputs(case):
    """Numpy inputs of the six losses at batch 4 (NHWC, the JAX layout);
    `one_half_empty`: rows 2 and 3 hold no positive and no GT box."""
    rng = np.random.RandomState(CASES.index(case))
    gt = random_gt(rng, B, 16, 3, 12)
    hm = (rng.rand(B, 10, 10, 3) < 0.05).astype(np.float32)
    hm_pred = rng.uniform(1e-4, 1 - 1e-4, (B, 10, 10, 3)).astype(np.float32)
    if case == "one_half_empty":
        gt[2:] = 0.0
        hm[2:] = 0.0
    targets = jax.tree.map(np.asarray, jax_assign(jnp.asarray(gt), JaxAssignerConfig(max_pos=128), TASKS,
                                                  CFG.grid_size, CFG.point_cloud_range, CFG.voxel_size))
    tid = int(np.argmax([t["mask"].sum() for t in targets]))
    tg = targets[tid]
    target = tg["box_encoding"].copy()
    target[0, 0, 3] = np.nan  # the reg loss masks non-finite targets
    pred = (0.5 * rng.randn(B, 10, 10, 11)).astype(np.float32)
    fs, ft = (rng.randn(B, 10, 10, 16).astype(np.float32) for _ in range(2))
    corners = np.asarray(jdist.gt_corners_bev(jnp.asarray(gt), CFG.point_cloud_range, CFG.voxel_size, 8))
    student = random_heads(rng, B=B)
    for h in student:  # the student's heatmap arrives sigmoided and clamped
        h["hm"] = np.clip(1 / (1 + np.exp(-h["hm"])), 1e-4, 1 - 1e-4).astype(np.float32)
    teacher = random_heads(rng, B=B, scale=2.0)
    return dict(focal=(hm_pred, hm), reg=(pred[..., :10], tg["mask"], tg["ind"], target),
                iou=(pred, tg["box_encoding"], tg["ind"], tg["mask"]),
                feature=(fs, ft, corners, np.abs(gt).sum(-1) > 0),
                bev_rel=(fs, ft, corners, np.abs(gt).sum(-1) > 0),
                response=(student, teacher, gt))


RESPONSE_ARGS = (CFG.point_cloud_range, CFG.voxel_size, 8, 2.0, 1e-4)
JAX_LOSSES = dict(
    focal=lambda p, g: jdet.focal_loss(p, g, 0.25, 2.0, "dp"),
    reg=lambda p, m, i, t: jdet.reg_loss(p, m, i, t, "dp"),
    iou=lambda p, e, i, m: jdet.iou_losses(p, e, i, m, 8, CFG.voxel_size[:2], "dp"),
    feature=lambda s, t, c, m: jdist.feature_distill_loss(s, t, c, m, "dp"),
    bev_rel=lambda s, t, c, m: jdist.bev_distill_loss(s, t, c, m, "dp"),
    response=lambda s, t, g: jdist.response_distill_loss(s, t, g, *RESPONSE_ARGS, axis_name="dp"),
)


@functools.lru_cache(maxsize=1)
def port_losses():
    inputs = {case: loss_inputs(case) for case in CASES}
    hm_pred, _ = inputs["both_halves"]["focal"]
    inputs["no_positive"] = dict(focal=(hm_pred, np.zeros_like(hm_pred)))
    return run_ranks(rank_losses, 2, (inputs, RANK_B, CFG.voxel_size[:2], RESPONSE_ARGS),
                     timeout_s=WORLD_TIMEOUT_S, threads=THREADS)


@pytest.mark.parametrize("name", list(JAX_LOSSES))
@pytest.mark.parametrize("case", CASES)
def test_normalisers_match_jax_pmean(case, name):
    args = loss_inputs(case)[name]
    ref = per_device(JAX_LOSSES[name], *args)
    ref = np.stack(ref, -1) if isinstance(ref, tuple) else ref  # per device: (a, b) pairs as [2]
    got = port_losses()
    for r in range(2):
        np.testing.assert_allclose(got[r][case, name], ref[r], rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")
    if case == "one_half_empty" and name != "focal":
        # the empty half's loss is 0, yet the other's is normalised by the mean count
        assert np.all(got[1][case, name] == 0) and np.all(got[0][case, name] != 0)


def test_focal_with_no_positive_anywhere_matches_jax():
    """No positive on either rank: both take the negatives-only branch, as
    the global count (the `where` on the `pmean`'d count) decides."""
    hm_pred, _ = loss_inputs("both_halves")["focal"]
    ref = per_device(JAX_LOSSES["focal"], hm_pred, np.zeros_like(hm_pred))
    got = port_losses()
    for r in range(2):
        np.testing.assert_allclose(got[r]["no_positive", "focal"], ref[r], rtol=RTOL, atol=ATOL)
        assert got[r]["no_positive", "focal"] > 0


# ---- (b) the camera<-LiDAR step over two ranks ---------------------------------


@functools.lru_cache(maxsize=1)
def step_case():
    s_j = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    base = jax_tiny_model(with_camera=False)
    t_j = dataclasses.replace(base, compute_dtype="float32",
                              lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    s_p = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    t_p = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    batch = dict(train_batch_np(s_p, B=B, seed=15), **point_batch(t_p, B, 1500, seed=16))
    s_params, s_stats = jax_params(s_j, batch, seed=18)
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), t_j, training=False)
    shapes = jax.eval_shape(lambda: JaxModel(t_j).init(jax.random.PRNGKey(0), **kw, train=False))
    rng = np.random.RandomState(19)
    t_params, t_stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    t_params["det_head"]["out_kernel"] = t_params["det_head"]["out_kernel"] * np.float32(0.05)
    return (s_j, t_j, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch


@functools.lru_cache(maxsize=1)
def jax_dp_step():
    """JAX `distill_train_step` shard_map'd over the 2-device mesh (the
    Trainer's `_compile_train_step`): new params and stats (device 0's),
    metrics (device 0's; the loss pmean'd), the pmean'd gradients."""
    (s_j, t_j, _, _), (s_params, s_stats, t_params, t_stats), batch = step_case()
    tx = capturing(jax_make_optimizer(LR, WD, CLIP))
    state = create_train_state({"params": s_params, "batch_stats": s_stats}, tx)
    fn = functools.partial(jax_steps.distill_train_step, student_model=JaxModel(s_j), teacher_model=JaxModel(t_j),
                           tx=tx, student_cfg=s_j, teacher_cfg=t_j, dcfg=JAX_VARIANTS[PAIR], axis_name="dp")
    step = jax.jit(jax.shard_map(fn, mesh=mesh2(), in_specs=(P(), P(), P(), P("dp")), out_specs=(P(), P()),
                                 check_vma=False))
    new_state, metrics = step(state, t_params, t_stats, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new_state.params, new_state.batch_stats, metrics, new_state.opt_state[0]))


@functools.lru_cache(maxsize=1)
def port_dp_step():
    (_, _, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch = step_case()
    s_sd = to_numpy(state_dict_from_jax(s_params, s_stats, s_p))
    t_sd = to_numpy(state_dict_from_jax(t_params, t_stats, t_p))
    return run_ranks(distill_step_on_ranks, 2,
                     (s_p, t_p, s_sd, t_sd, batch, PAIR, TrainConfig(lr=LR, weight_decay=WD, grad_clip_value=CLIP),
                      RANK_B),
                     timeout_s=WORLD_TIMEOUT_S, threads=THREADS)


def test_dp_distill_step_metrics_match_jax():
    _, _, ref, _ = jax_dp_step()
    got = port_dp_step()
    m = got[0]["metrics"]
    for k in ("loss", "loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg"):
        assert np.isfinite(m[k]) and m[k] > 0, k
    for k, v in ref.items():
        np.testing.assert_allclose(m[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    # the logged loss is the mean of the ranks' totals; the ranks' own terms differ
    totals = [g["local_total"] for g in got]
    np.testing.assert_allclose(m["loss"], np.mean(totals), rtol=1e-6)
    assert got[1]["metrics"]["loss"] == m["loss"] and totals[0] != totals[1]
    assert got[1]["metrics"]["loss_det"] != m["loss_det"]


def test_dp_distill_step_gradients_match_jax():
    (_, _, s_p, _), _, _ = step_case()
    _, _, _, ref_grads = jax_dp_step()
    got = port_dp_step()
    ref = state_dict_from_jax(ref_grads, {}, s_p)
    grads = from_numpy(got[0]["grads"])
    assert set(ref) == set(grads)
    scales = grad_scales(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k].numpy() / scales[k], r.numpy() / scales[k], atol=2e-3,
                                   err_msg=f"grad {k}")
        np.testing.assert_array_equal(got[1]["grads"][k], got[0]["grads"][k], err_msg=k)
    assert all(all(g["teacher_grads"]) for g in got)  # the teacher gets none


def test_dp_distill_step_rank0_batch_stats_match_jax_device0():
    (_, _, s_p, _), _, _ = step_case()
    ref_params, ref_stats, _, _ = jax_dp_step()
    got = port_dp_step()
    ref = state_dict_from_jax(ref_params, ref_stats, s_p)
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[0]["state"][k], ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    # rank 1 keeps the statistics of its own rows
    assert any(not np.array_equal(got[1]["state"][k], got[0]["state"][k]) for k in stats)


def test_dp_distill_step_ranks_hold_equal_parameters():
    got = port_dp_step()
    params = got[0]["grads"].keys()
    for k in params:
        np.testing.assert_array_equal(got[1]["state"][k], got[0]["state"][k], err_msg=k)
    (_, _, s_p, _), (s_params, s_stats, _, _), _ = step_case()
    start = to_numpy(state_dict_from_jax(s_params, s_stats, s_p))
    assert any(not np.array_equal(got[0]["state"][k], start[k]) for k in params)


# ---- (c) the loader and the sampler --------------------------------------------


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return build_synth_nusc(tmp_path_factory.mktemp("nusc_dp_loader"), SPLIT_FRAMES)


def frame(batch, i):
    return {k: ({mk: mv[i] for mk, mv in v.items()} if k == "mats" else v[i]) for k, v in batch.items()}


# arrays a frame draws from the dataset's generator at eval too: the point
# subsample over the cap, and what is voxelised from it
DRAWN_AT_EVAL = ("points", "points_mask", "voxel_feats", "voxel_coords")


@pytest.mark.parametrize("split,shuffle", [("validation", False), ("validation", True), ("training", True),
                                           ("training", False)])
def test_rank_rows_are_rows_of_the_jax_global_batches(synth_root, monkeypatch, split, shuffle):
    """Global batches of 2 × 2 over the split's frames: `drop_last` for
    training (as the CLIs load it), not at eval, where the last global batch
    is one frame and rank 1's share of it is empty. The tokens (the
    CBGS-resampled, shuffled order) of every global batch are the ranks'
    tokens in rank order. A frame's random draws come from its rank's
    generator (the JAX loader draws the global batch's in one stream), so:
    rank 0's first batch equals the JAX rows array for array; at eval every
    frame equals its JAX row but for the arrays of its point subsample."""
    _no_native(monkeypatch)
    train = split == "training"
    dcfg = dict(root_path=synth_root, num_lidar_sweeps=2, use_cbgs=train)
    jd = JaxDataset(JaxDataConfig(**dcfg), jax_tiny_model(), split, seed=1)
    jl = JaxDataLoader(jd, B, shuffle=shuffle, drop_last=train, num_workers=0, seed=7)
    pls = [DataLoader(NuScenesDataset(DataConfig(**dcfg), tiny_model(), split, seed=1), RANK_B, shuffle=shuffle,
                      drop_last=train, seed=7, rank=r, world_size=2) for r in range(2)]
    assert len(pls[0]) == len(pls[1]) == len(jl) == (len(jd) // B if train else -(-len(jd) // B))
    for epoch in range(2):
        jbs, pbs = list(jl), [list(pl) for pl in pls]
        assert len(pbs[0]) == len(pbs[1]) == len(jbs)
        for j, (jb, rank_batches) in enumerate(zip(jbs, zip(*pbs))):
            tokens = [m["token"] for m in jb["meta"]]
            assert [m["token"] for b in rank_batches if b for m in b["meta"]] == tokens
            for r, pb in enumerate(rank_batches):
                n = len(pb["meta"]) if pb else 0
                assert n == len(tokens[r * RANK_B : (r + 1) * RANK_B])
                for i in range(n):
                    got, ref = frame(pb, i), frame(jb, r * RANK_B + i)
                    if epoch == j == r == 0:
                        assert_frames_equal(got, ref)
                    elif not train:
                        assert_frames_equal({k: v for k, v in got.items() if k not in DRAWN_AT_EVAL},
                                            {k: v for k, v in ref.items() if k not in DRAWN_AT_EVAL})
    if not train:
        assert [bool(b) for b in list(pls[1])] == [True, False]  # 5 frames: [0-3], [4]


def test_rank_streams_draw_their_own_augmentations(synth_root, monkeypatch):
    """Rank 0 draws as the one-process loader does; rank 1 from its own
    generator, so rows 2 and 3 of a global batch do not repeat rows 0 and 1's
    augmentations."""
    _no_native(monkeypatch)
    dcfg = DataConfig(root_path=synth_root, num_lidar_sweeps=2, use_cbgs=False)
    one = next(iter(DataLoader(NuScenesDataset(dcfg, tiny_model(), "training", seed=1), B, seed=7)))
    r0, r1 = (next(iter(DataLoader(NuScenesDataset(dcfg, tiny_model(), "training", seed=1), RANK_B, seed=7,
                                   rank=r, world_size=2))) for r in range(2))
    for key in ("ida_mats", "bda_mat"):
        np.testing.assert_array_equal(r0["mats"][key], one["mats"][key][:RANK_B], err_msg=key)
        assert not np.array_equal(r1["mats"][key], r0["mats"][key]), key
    assert [m["token"] for m in r0["meta"] + r1["meta"]] == [m["token"] for m in one["meta"]]


@pytest.mark.parametrize("world", [2, 3])
def test_rank_striding_sampler_matches_jax(world):
    for shuffle, rank in itertools.product((True, False), range(world)):
        got = list(itertools.islice(InfiniteSampler(7, shuffle=shuffle, seed=3, rank=rank, world_size=world), 20))
        ref = itertools.islice(JaxInfiniteSampler(7, shuffle=shuffle, seed=3, rank=rank, world_size=world), 20)
        assert got == [int(i) for i in ref]


def test_gather_helpers_match_jax():
    per = [[{"t": 0}, {"t": 2}], [{"t": 1}, {"t": 3}]]
    for total in (None, 3):
        assert parallel.interleave_process_results(per, total) == jax_mesh.interleave_process_results(per, total)
    local = [{"t": 5}, {"t": 6}]
    assert parallel.all_gather_host_objects(local, 1) == jax_mesh.all_gather_host_objects(local, 1)
