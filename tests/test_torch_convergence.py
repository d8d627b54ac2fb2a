"""The convergence gate on the port: training must learn.

`unidistill_torch/experiments/convergence.py` carries the JAX gate
(`tests/test_convergence.py`) over to the port's own train, distill and
eval steps. The fast tests hold each of its helpers against the JAX test's
own, imported from that file:
  * `scene_batch`: points, mask, GT boxes, voxel features and coordinates
    (and images and camera matrices) exactly equal to `_scene_batch`'s,
    LiDAR only and with both modalities;
  * `random_scene`, `ab_scenes`, `ang_diff` and `matched_score` exactly
    equal to theirs on fixed decodes; `box_hits` (the JAX test's inline
    scorer) on constructed decodes with known counts;
  * `exact_batch_stats` on the tiny LiDAR detector carried from the JAX
    init (`PRNGKey(0)`, the G1 batch, float32, the JAX stage caps raised so
    that none binds): every BatchNorm's running statistics equal the f64
    mean and biased variance of its own input (rtol 1e-5, atol 1e-6), and
    `_exact_batch_stats`'s on the JAX model, means within rtol 1e-4, atol
    1e-5, variances within rtol 5e-3: the JAX side solves for them by an
    Aitken step from two f32 moving averages, which at momentum 0.99
    divides by (1 - m)^2 (a - x) and leaves its variances a few 1e-3 off;
  * the gate's learning-rate schedule equal to the JAX gate's optax
    schedule at every step (it falls 10x at step 10 and again at 15);
  * the pass/fail bars at the JAX gate's thresholds;
  * G1's frames overflow the JAX tiny encoder's stage caps at s2 and s3.
The slow tests (`-m slow`) run G1-G3 on the port from the JAX gate's own
initial weights (`PRNGKey(0)`, `(42)`, `(1)`, carried by
`state_dict_from_jax`), at bf16 (the gate's dtype) and at float32, and
assert the JAX thresholds. They print each gate's margins (`-s`).
"""
import dataclasses
import functools
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state
from unidistill_tpu.training.train_state import make_optimizer as jax_make_optimizer
from unidistill_tpu.training.train_state import multistep_lr as jax_multistep_lr

from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, tiny_model
from unidistill_torch.experiments import convergence as cv
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.train_state import make_optimizer

from tests import test_convergence as jax_gate
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_lidar_detector import RAISED_CAPS

STATS_TOL = dict(rtol=1e-4, atol=1e-5)
AITKEN_VAR_RTOL = 5e-3  # the JAX gate's variances from f32 moving averages (test_exact_batch_stats_matches_jax)


def jax_cfg(with_lidar=True, with_camera=True, **encoder):
    cfg = jax_tiny_model(with_lidar=with_lidar, with_camera=with_camera)
    if encoder:
        cfg = dataclasses.replace(cfg, lidar_encoder=dataclasses.replace(cfg.lidar_encoder, **encoder))
    return cfg


def jax_init(jcfg, key: int, batch, train: bool):
    """The JAX gate's `model.init(PRNGKey(key), ...)` on the first frame of
    `batch` (a `_scene_batch`), as numpy trees."""
    model = JaxModel(jcfg)
    kw = jax_steps.model_inputs(jax.tree.map(lambda x: jnp.asarray(x[:1]), batch), jcfg, training=train)
    v = jax.jit(lambda k, kw: model.init(k, **kw, train=train))(jax.random.PRNGKey(key), kw)
    return jax.device_get(v)


def port_model(variables, pcfg):
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables.get("batch_stats", {}), pcfg),
                          strict=True)
    return model


def _equal_trees(got, ref):
    assert set(got) <= set(ref), set(got) - set(ref)
    for k, v in got.items():
        if isinstance(v, dict):
            _equal_trees(v, ref[k])
        else:
            assert v.dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("modality, B, seed, scene", [
    ("lidar", 2, 0, cv.SCENE2), ("lidar", 1, 1, None), ("both", 2, 3, cv.SCENE2B), ("both", 1, 0, None)])
def test_scene_batch_matches_jax(modality, B, seed, scene):
    both = modality == "both"
    got = cv.scene_batch(tiny_model(with_camera=both), B, seed, scene=scene)
    ref = jax_gate._scene_batch(jax_cfg(with_camera=both), B=B, seed=seed, scene=scene)
    assert set(ref) - set(got) == {k for k in ref if k.startswith("topo_")}
    _equal_trees(got, ref)
    assert ("imgs" in got) == both


def test_scenes_match_jax():
    assert cv.CENTERS == jax_gate.CENTERS
    assert cv.SCENE2 == jax_gate.SCENE2 and cv.SCENE2B == jax_gate.SCENE2B
    for seed in (0, 7, 11):
        got, ref = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(4):
            assert cv.random_scene(got) == jax_gate._random_scene(ref)
    rng = np.random.RandomState(7)
    train = [jax_gate._random_scene(rng) for _ in range(4)]
    assert cv.ab_scenes() == (train, [jax_gate._random_scene(rng) for _ in range(2)])


def _decodes(rng, scene, R=40, near=10):
    """Fixed decodes of one frame: `near` candidates scattered within 8 m of
    the scene's boxes, the rest anywhere, random scores (some tied)."""
    boxes = rng.uniform(-40, 40, (1, R, 9)).astype(np.float32)
    idx = rng.randint(0, len(scene), near)
    boxes[0, :near, :2] = np.array([scene[i][:2] for i in idx]) + rng.uniform(-8, 8, (near, 2))
    scores = rng.choice([0.1, 0.35, 0.5, 0.9], (1, R)).astype(np.float32) * rng.uniform(0.5, 1, (1, R))
    scores[0, ::7] = 0.5
    return dict(boxes=boxes, scores=scores.astype(np.float32), labels=rng.randint(1, 11, (1, R)).astype(np.int32))


def test_matched_score_and_ang_diff_match_jax():
    rng = np.random.RandomState(3)
    a, b = rng.uniform(-10, 10, 64), rng.uniform(-10, 10, 64)
    np.testing.assert_array_equal(cv.ang_diff(a, b), jax_gate._ang_diff(a, b))
    for i in range(20):
        scene = cv.random_scene(rng)
        res = _decodes(rng, scene)
        tensors = {k: torch.from_numpy(v) for k, v in res.items()}
        assert cv.matched_score(res, scene) == jax_gate._matched_score(res, scene)
        assert cv.matched_score(tensors, scene) == jax_gate._matched_score(res, scene)


def test_box_hits_counts_constructed_decodes():
    """Frame 0: box 0 decoded exactly (a full hit), box 1 with the wrong
    class, box 2 with its yaw 0.5 rad off, box 3 missed (5.5 m away).
    Frame 1: box 0 with vy 0.9 off; box 1 only with score 0.29 (below the
    bar); box 2 hit, but a better-scoring decode with the wrong class is
    what the attributes are read from; box 3 decoded right, but outside
    the 16 best decodes, behind 16 far from every box (which also push out
    box 2's right decode). With those 16 at score 0, box 3 is a full hit."""
    scenes = [cv.SCENE2, cv.SCENE2B]
    boxes = np.zeros((2, 24, 9), np.float32)
    boxes[..., :2] = 200.0  # far from everything
    scores = np.zeros((2, 24), np.float32)
    labels = np.ones((2, 24), np.int32)

    def put(b, j, box, score, **change):
        cx, cy, yaw, vx, vy, cls = box
        vals = dict(cx=cx, cy=cy, yaw=yaw, vx=vx, vy=vy, cls=cls)
        vals.update(change)
        boxes[b, j, [0, 1, 6, 7, 8]] = [vals["cx"], vals["cy"], vals["yaw"], vals["vx"], vals["vy"]]
        scores[b, j], labels[b, j] = score, vals["cls"]

    s0, s1 = scenes
    put(0, 0, s0[0], 0.9)
    put(0, 1, s0[1], 0.9, cls=9)
    put(0, 2, s0[2], 0.9, yaw=s0[2][2] + 0.5)
    put(0, 3, s0[3], 0.9, cx=s0[3][0] + 5.5)
    put(1, 0, s1[0], 0.9, vy=s1[0][4] + 0.9)
    put(1, 1, s1[1], 0.29)
    put(1, 2, s1[2], 0.5)
    put(1, 3, s1[2], 0.8, cx=s1[2][0] + 3.0, cls=1)
    for j in range(4, 20):
        scores[1, j] = 0.6
    put(1, 20, s1[3], 0.55)
    res = dict(boxes=boxes, scores=scores, labels=labels)
    assert cv.box_hits(res, scenes) == (5, 1)
    scores[1, 4:20] = 0.0
    assert cv.box_hits(res, scenes) == (6, 2)


def test_failures_hold_the_jax_bars():
    keys = [f"task_{t}/{n}_loss" for t in cv.USED_TASKS for n in ("hm", "loc")]
    first = {k: 1.0 for k in keys}

    def result(loc, hm, hits, attr):
        last = {k: (loc if k.endswith("loc_loss") else hm) for k in keys}
        return dict(first=first, last=last, ratio=last, hits=hits, attr_hits=attr, n=8)

    assert cv.overfit_failures(result(0.29, 0.49, 5, 3)) == []
    assert len(cv.overfit_failures(result(0.3, 0.49, 5, 3))) == 3  # loc must fall below 0.3x
    assert len(cv.overfit_failures(result(0.29, 0.5, 5, 3))) == 3  # hm below 0.5x
    assert len(cv.overfit_failures(result(0.29, 0.49, 4, 3))) == 1  # 5 of 8 boxes
    assert len(cv.overfit_failures(result(0.29, 0.49, 8, 5))) == 1  # 3/4 of the hits (6 of 8)
    assert len(cv.overfit_failures(result(float("nan"), 0.49, 8, 6))) == 6  # 3 non-finite, 3 ratios
    terms = dict(zip(cv.DISTILL_TERMS, (1.0, 2.0, 3.0, 4.0)))
    assert cv.distill_failures(dict(first=terms, last={k: v * 0.99 for k, v in terms.items()})) == []
    assert len(cv.distill_failures(dict(first=terms, last=dict(terms)))) == 4


def test_pooled_totals_only_hits_and_scores():
    """Over several seeds only G1's hits and G2's scores are totalled; G1's
    loss ratios and attribute hits, and G3's terms, hold for each seed at
    the JAX gate's bar for one run."""
    keys = [f"task_{t}/{n}_loss" for t in cv.USED_TASKS for n in ("hm", "loc")]

    def g1(first, hm, hits, attr):
        first = {k: first for k in keys}
        last = {k: first[k] * (hm if k.endswith("hm_loss") else 0.1) for k in keys}
        return dict(first=first, last=last, ratio={k: last[k] / first[k] for k in keys}, hits=hits,
                    attr_hits=attr, n=8)

    ok = {0: g1(1.0, 0.4, 5, 4), 1: g1(1.0, 0.4, 6, 5)}
    assert cv.pooled("g1", ok)["failures"] == []
    # seed 1's hm ratio 0.55 is over 0.5, though the ratio of the seeds'
    # summed losses (0.4 * 10 + 0.55) / 11 = 0.41 is not
    got = cv.pooled("g1", {0: g1(10.0, 0.4, 5, 4), 1: g1(1.0, 0.55, 6, 5)})["failures"]
    assert len(got) == 3 and all(f.startswith("seed 1: task_") and "hm_loss" in f for f in got), got
    # attribute hits per seed: seed 0's 2 of 6 is under its bar of 4, though
    # the sums (2 + 8 of 6 + 8, bar 4 + 6) pass
    got = cv.pooled("g1", {0: g1(1.0, 0.4, 6, 2), 1: g1(1.0, 0.4, 8, 8)})["failures"]
    assert len(got) == 1 and got[0].startswith("seed 0: only 2/6"), got
    # hits on the totals: 4 + 6 of 16 is under 10, though seed 1 passes alone
    r = cv.pooled("g1", {0: g1(1.0, 0.4, 4, 3), 1: g1(1.0, 0.4, 6, 5)})
    assert (r["hits"], r["n"], r["bar_hits"]) == (10, 16, 10) and r["failures"] == []
    r = cv.pooled("g1", {0: g1(1.0, 0.4, 3, 3), 1: g1(1.0, 0.4, 6, 5)})
    assert len(r["failures"]) == 1 and r["failures"][0].startswith("only 9/16"), r
    # G2 on the totals, G3 per seed
    assert cv.pooled("g2", {0: dict(score_d=0.5, score_p=1.0), 1: dict(score_d=2.0, score_p=1.0)})["failures"] == []
    assert cv.pooled("g2", {0: dict(score_d=1.0, score_p=1.0), 1: dict(score_d=1.0, score_p=1.0)})["failures"]
    terms = dict(zip(cv.DISTILL_TERMS, (1.0, 2.0, 3.0, 4.0)))
    fell = dict(first=terms, last={k: v * 0.5 for k, v in terms.items()})
    rose = dict(first=terms, last=dict(fell["last"], loss_feature=1.01))
    got = cv.pooled("g3", {0: fell, 1: rose})["failures"]
    assert len(got) == 1 and got[0].startswith("seed 1: loss_feature"), got


def test_gate_learning_rate_is_the_jax_schedule():
    for lr in (cv.LR_OVERFIT, cv.LR_STUDENT, cv.LR_DISTILL):
        cfg = cv.train_config(lr)
        assert (cfg.weight_decay, cfg.grad_clip_value) == (1e-7, 0.1)
        opt = make_optimizer(torch.nn.Linear(2, 2), cfg)
        ref = jax_multistep_lr(lr, (10, 15), 0.1, 1)
        got = [opt.lr(s) for s in range(cv.N_OVERFIT_STEPS)]
        np.testing.assert_allclose(got, [float(ref(s)) for s in range(cv.N_OVERFIT_STEPS)], rtol=1e-6)
        assert got[9] == lr and got[10] == pytest.approx(lr / 10) and got[15] == pytest.approx(lr / 100)
    # the JAX gate's optimizer runs that schedule inside AdamW
    tx = optax.adamw(jax_multistep_lr(1.0, (10, 15), 0.1, 1), weight_decay=0.0, eps=0.0)
    p, g = jnp.ones(()), jnp.ones(())
    state = tx.init(p)
    steps = []
    for _ in range(16):
        u, state = tx.update(g, state, p)
        steps.append(float(-u))
    np.testing.assert_allclose(steps, [1.0] * 10 + [0.1] * 5 + [0.01], rtol=1e-4)  # Adam in f32


@functools.lru_cache(maxsize=1)
def _g1_case():
    jcfg = jax_cfg(with_camera=False)
    jb = jax.tree.map(lambda a, b: np.concatenate([a, b], axis=0),
                      jax_gate._scene_batch(jcfg, B=1, seed=0, scene=jax_gate.SCENE2),
                      jax_gate._scene_batch(jcfg, B=1, seed=1, scene=jax_gate.SCENE2B))
    return jb, jax_init(jcfg, 0, jb, train=True)


def test_exact_batch_stats_matches_jax():
    _, variables = _g1_case()
    jcfg = dataclasses.replace(jax_cfg(with_camera=False, **RAISED_CAPS), compute_dtype="float32")
    pcfg = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    # the loader-side topology of the raised caps
    jb = jax.tree.map(lambda a, b: np.concatenate([a, b], axis=0),
                      jax_gate._scene_batch(jcfg, B=1, seed=0, scene=jax_gate.SCENE2),
                      jax_gate._scene_batch(jcfg, B=1, seed=1, scene=jax_gate.SCENE2B))

    class State:
        params, batch_stats = variables["params"], variables["batch_stats"]

    ref_stats = jax_gate._exact_batch_stats(JaxModel(jcfg), State, jax.tree.map(jnp.asarray, jb), jcfg)
    ref = state_dict_from_jax(variables["params"], jax.device_get(ref_stats), pcfg)
    model = port_model(variables, pcfg)
    inputs = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_pre_hook(lambda m, a, name=name: inputs.__setitem__(name, a[0].detach().double()))
    cv.exact_batch_stats(model, cv.concat_batches(cv.scene_batch(pcfg, 1, 0, scene=cv.SCENE2),
                                                  cv.scene_batch(pcfg, 1, 1, scene=cv.SCENE2B)), pcfg)
    assert not model.training
    got = model.state_dict()
    assert len(inputs) == 37  # the BatchNorms of the tiny LiDAR detector
    for name, x in inputs.items():
        # exact: the f64 statistics of each BatchNorm's own input (flax's biased variance)
        x = x.transpose(0, 1).reshape(x.shape[1], -1)
        torch.testing.assert_close(got[f"{name}.running_mean"].double(), x.mean(1), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[f"{name}.running_var"].double(), x.var(1, unbiased=False), rtol=1e-5,
                                   atol=1e-6)
        # the JAX gate's Aitken step solves for them from two f32 moving
        # averages; it divides by 2b - a - c = (1 - m)^2 (a - x), so at
        # momentum 0.99 its variances carry errors of a few 1e-3
        torch.testing.assert_close(got[f"{name}.running_mean"], ref[f"{name}.running_mean"], **STATS_TOL)
        torch.testing.assert_close(got[f"{name}.running_var"], ref[f"{name}.running_var"], rtol=AITKEN_VAR_RTOL,
                                   atol=1e-5)


def test_jax_gate_caps_bind_on_the_overfit_frames():
    """G1's two frames hold more sites at s2 and s3 than the JAX tiny
    encoder's fixed-shape stage caps (1024, 512): the JAX gate's model
    drops sites there, the port's keeps them all, so the two frameworks'
    G1 are not the same model."""
    from unidistill_torch.layers.lidar_encoder import build_rulebooks, stage_shapes
    from unidistill_torch.training.steps import model_inputs

    cfg = tiny_model(with_camera=False)
    batch = cv.concat_batches(cv.scene_batch(cfg, 1, 0, scene=cv.SCENE2), cv.scene_batch(cfg, 1, 1, scene=cv.SCENE2B))
    kw = model_inputs(batch, cfg, "cpu", training=True)
    rb = build_rulebooks(kw["voxel_feats"], kw["voxel_coords"], stage_shapes(cfg.grid_size))
    sites = [torch.bincount(st.coords[:, 0], minlength=2).max().item() for st in rb.sites]
    assert sites == [832, 1325, 711, 221, 196]
    assert jax_cfg().lidar_encoder.stage_voxel_caps == (1024, 512, 256, 256)


# ---- slow: G1-G3 from the JAX gate's initial weights ---------------------

DTYPES = ("bfloat16", "float32")


def _report(name, dtype, r):
    print(json.dumps(dict(cv.summary(name, r), dtype=dtype, init="jax")))


@pytest.mark.slow
@pytest.mark.parametrize("dtype", DTYPES)
def test_overfit_from_jax_init(dtype):
    _, variables = _g1_case()
    cfg = cv.tiny_configs(dtype)["lidar"]
    r = cv.overfit_gate(port_model(variables, cfg), cfg)
    _report("g1", dtype, r)
    assert cv.overfit_failures(r) == [], cv.summary("g1", r)


@pytest.mark.slow
@pytest.mark.parametrize("dtype", DTYPES)
def test_distill_ab_from_jax_init(dtype):
    cfgs = cv.tiny_configs(dtype)
    train, _ = cv.ab_scenes()
    jb = jax_gate._scene_batch(jax_cfg(), B=1, seed=0, scene=train[0])
    teacher = port_model(jax_init(jax_cfg(), 0, jb, train=True), cfgs["fusion"])
    sv = jax_init(jax_cfg(with_camera=False), 42, jb, train=True)
    r = cv.ab_gate(teacher, port_model(sv, cfgs["lidar"]), port_model(sv, cfgs["lidar"]), cfgs["fusion"],
                   cfgs["lidar"], DISTILL_VARIANTS[("fusion", "lidar")])
    _report("g2", dtype, r)
    assert r["score_d"] > r["score_p"], cv.summary("g2", r)


@pytest.mark.slow
@pytest.mark.parametrize("dtype", DTYPES)
def test_distill_losses_decrease_from_jax_init(dtype):
    cfgs = cv.tiny_configs(dtype)
    jb = jax_gate._scene_batch(jax_cfg())
    sv = jax_init(jax_cfg(with_lidar=False), 0, jb, train=True)
    tv = jax_init(jax_cfg(with_camera=False), 1, jb, train=False)
    batch = cv.scene_batch(cfgs["fusion"])
    r = cv.distill_gate(port_model(sv, cfgs["camera"]), port_model(tv, cfgs["lidar"]), cfgs["camera"],
                        cfgs["lidar"], DISTILL_VARIANTS[("lidar", "camera")], batch)
    _report("g3", dtype, r)
    assert cv.distill_failures(r) == [], cv.summary("g3", r)


def jax_params_from_port(template, sd, pcfg):
    """The inverse of `state_dict_from_jax` on parameters: a tree shaped as
    the JAX `template` holding the port's state dict `sd`. Each leaf's
    layout transform is a permutation, found by carrying an index array
    of that leaf alone through `state_dict_from_jax`."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(template)[0]:
        keys = [p.key for p in path]
        single = idx = np.arange(leaf.size, dtype=np.float32).reshape(leaf.shape)
        for k in reversed(keys):
            single = {k: single}
        (name, carried), = state_dict_from_jax(single, {}, pcfg).items()
        flat = np.empty(leaf.size, np.float32)
        flat[carried.numpy().astype(np.int64).ravel()] = sd[name].float().numpy().ravel()
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = flat.reshape(idx.shape)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_jax_gate_from_port_init(seed):
    """The JAX package's own G1 (its train and eval steps, its
    `_exact_batch_stats`, its tiny configuration) from the port's seeded
    init at the seeds the card runs, carried to JAX by
    `jax_params_from_port`: tells init sensitivity from a fault of the
    port. Prints the JAX gate's margins; asserts that the carried weights
    come back exactly and that the JAX losses stay finite. The JAX tiny
    encoder's stage caps bind on these frames (s2 1325 sites a frame
    against 1024, s3 711 against 512; the port keeps every site), so the
    two frameworks' G1 models differ from the first step."""
    jb, variables = _g1_case()
    jcfg = jax_cfg(with_camera=False)
    pcfg = cv.tiny_configs("bfloat16")["lidar"]
    sd = cv.seeded_model(pcfg, seed, "cpu").state_dict()
    params = jax_params_from_port(variables["params"], sd, pcfg)
    back = state_dict_from_jax(params, {}, pcfg)
    assert all(torch.equal(back[k], sd[k].float()) for k in back)

    model = JaxModel(jcfg)
    tx = jax_make_optimizer(cv.LR_OVERFIT, 1e-7, 0.1)
    state = create_train_state({"params": params, "batch_stats": variables["batch_stats"]}, tx)
    step = jax.jit(functools.partial(jax_steps.train_step, model=model, cfg=jcfg, tx=tx))
    batch = jax.tree.map(jnp.asarray, jb)
    keys = [f"task_{t}/{n}_loss" for t in cv.USED_TASKS for n in ("hm", "loc")]
    for i in range(cv.N_OVERFIT_STEPS):
        state, m = step(state, batch)
        if i == 0:
            first = {k: float(m[k]) for k in keys}
    last = {k: float(m[k]) for k in keys}
    state = state.replace(batch_stats=jax_gate._exact_batch_stats(model, state, batch, jcfg))
    res = jax.device_get(jax.jit(functools.partial(jax_steps.eval_step, model=model, cfg=jcfg))(state, batch))
    r = dict(first=first, last=last, ratio={k: last[k] / first[k] for k in keys}, n=8)
    r["hits"], r["attr_hits"] = cv.box_hits(res, [cv.SCENE2, cv.SCENE2B])
    r["failures"] = cv.overfit_failures(r)
    print(json.dumps(dict(cv.summary("g1", r), seed=seed, init="port", steps="jax")))
    assert np.isfinite(list(last.values())).all(), last


# (gate, compute dtype, torch threads): each gate as the card runs it (bf16),
# and G1 also at float32 and on one thread, to tell bf16 rounding from the
# order of a threaded sum where the CPU and the card disagree
PORT_INIT_RUNS = [("g1", "bfloat16", 2), ("g1", "bfloat16", 1), ("g1", "float32", 2), ("g1", "float32", 1),
                  ("g2", "bfloat16", 2), ("g3", "bfloat16", 2)]
PORT_INIT_SEEDS = (0, 1, 2)


@pytest.mark.slow
@pytest.mark.parametrize("gate, dtype, threads", PORT_INIT_RUNS)
def test_gate_from_port_init(gate, dtype, threads):
    """The port's gates from its own seeded init (`run_gate`) at seeds 0-2,
    the card's seeds, on the CPU. Prints each seed's margins and the
    seeds held as one (`pooled`), as the card's [convergence] does; asserts
    that every loss and score is finite. The gate itself is not asserted:
    from these inits G1's outcome moves with the torch thread count on the
    CPU (ROADMAP Queue C)."""
    torch.set_num_threads(threads)
    results = {s: cv.run_gate(gate, s, "cpu", dtype) for s in PORT_INIT_SEEDS}
    for s, r in results.items():
        print(json.dumps(dict(cv.summary(gate, r), seed=s, dtype=dtype, threads=threads, init="port")))
    total = cv.pooled(gate, results)
    print(json.dumps(dict(cv.summary(gate, total), seeds=list(PORT_INIT_SEEDS), dtype=dtype, threads=threads,
                          init="port")))
    for r in results.values():
        values = [v for part in ("first", "last") for v in r.get(part, {}).values()]
        values += [r[k] for k in ("score_d", "score_p") if k in r]
        assert values and np.isfinite(values).all(), cv.summary(gate, r)
