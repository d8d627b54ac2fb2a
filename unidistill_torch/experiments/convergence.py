"""The convergence gate: training must learn, on the port's own steps.

The port's counterpart of the JAX package's `tests/test_convergence.py`,
the stand-in for the reference's "train 20 epochs and eval on nuScenes"
QA loop. Its scenes, batches and scorers, and three gates that use
`training.steps.train_step`, `distill_train_step` and `eval_step` as they
are:

  * `overfit_gate` (G1): the LiDAR detector overfits two frames of planted
    boxes (`SCENE2`, `SCENE2B`: classes of tasks 0, 3 and 5, rotated boxes,
    nonzero velocities) for 220 steps at lr 1e-2. Tasks 0/3/5's `loc`
    losses must fall below 0.3x their first value and their `hm` losses
    below 0.5x; after `exact_batch_stats`, the decodes must recover at
    least 5/8 of the boxes, and at least 3/4 of those with the right class,
    yaw and velocity.
  * `ab_gate` (G2): a fusion teacher trains 120 steps on four random
    scenes; two LiDAR students from one initial state train 120 steps each
    on the same data, one plain and one distilled from the teacher. On two
    held-out scenes the distilled student's `matched_score` must beat the
    plain one's.
  * `distill_gate` (G3, and G4 at full width): a student trains 60 distill
    steps on one fixed batch from a frozen teacher; the four distill terms
    must each end below where they started.

Every optimizer is `train_config(lr)`: AdamW at weight decay 1e-7, the
gradients clipped to a global norm of 0.1, and the `TrainConfig` default
milestones (10, 15) with one step an epoch, so the learning rate falls 10x
after step 10 and again after step 15, as the JAX gate's
`make_optimizer(lr, 1e-7, 0.1)` does. The thresholds and radii are the JAX
gate's, measured at the tiny configuration's bf16 compute dtype; 5.4 m is
half of its 10.8 m head cell.

The batches are made with numpy from a seed and voxelised on the host by
`ops/voxelize.voxelize_frame` (the C++ host library) at the train voxel cap,
as the JAX gate's `_scene_batch` does; the port's per-voxel encoder needs
none of the JAX chunked encoder's `topo_*` keys.

Where a gate runs at several seeds of the port's own init (`run_gate`),
`pooled` holds them as one: only G1's hits and G2's scores are totalled.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unidistill_torch.configs.nuscenes import DistillConfig, ModelConfig, TrainConfig
from unidistill_torch.serving.synthetic import calibrate_batchnorm
from unidistill_torch.training.steps import distill_train_step, eval_step, metrics_to_host, model_inputs, train_step
from unidistill_torch.training.train_state import TrainState, make_optimizer

N_OVERFIT_STEPS = 220
N_TEACHER_STEPS = 120
N_STUDENT_STEPS = 120
N_DISTILL_STEPS = 60
LR_OVERFIT, LR_TEACHER, LR_STUDENT, LR_DISTILL = 1e-2, 1e-2, 3e-3, 1e-3
USED_TASKS = (0, 3, 5)  # car / barrier / pedestrian task groups
LOC_RATIO, HM_RATIO = 0.3, 0.5
MATCH_RADIUS_M = 5.4  # half the tiny configuration's 10.8 m head cell
MIN_SCORE = 0.3
TOP_K = 16
YAW_TOL, VEL_TOL = 0.45, 0.8
DISTILL_TERMS = ("loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg")

CENTERS = [(-15.0, -10.0), (12.0, 8.0), (20.0, -18.0), (-20.0, 16.0)]
# (cx, cy, yaw, vx, vy, class_id): classes of tasks 0 (car = 1), 3
# (barrier = 6) and 5 (pedestrian = 9)
SCENE2 = [
    (-15.0, -10.0, 0.8, 1.5, -1.0, 1),
    (12.0, 8.0, -2.2, -0.5, 2.0, 6),
    (20.0, -18.0, 2.6, 0.0, 0.0, 9),
    (-20.0, 16.0, -0.4, 2.0, 1.0, 1),
]
# the second frame: another layout, so that B = 2 is not one frame twice
SCENE2B = [
    (-18.0, 12.0, 1.9, -1.0, 0.5, 1),
    (15.0, -14.0, -0.9, 0.0, 0.0, 6),
    (-10.0, -20.0, 0.3, 1.0, 1.5, 9),
    (22.0, 18.0, -2.8, 0.0, 0.0, 1),
]

Scene = Sequence[Tuple[float, float, float, float, float, int]]
OnStep = Callable[[str, int, Dict], None]


def train_config(lr: float) -> TrainConfig:
    """The gate's optimizer settings (see the module docstring)."""
    return TrainConfig(lr=lr, weight_decay=1e-7, grad_clip_value=0.1)


def scene_batch(cfg: ModelConfig, B: int = 1, seed: int = 0, clutter: int = 300,
                scene: Optional[Scene] = None) -> Dict:
    """Frames with planted boxes (numpy): LiDAR points sampled on the
    (rotated) 6 x 4 x 2 m boxes, 250 a box, plus `clutter` ground points;
    with the camera, normal random images and identity camera matrices
    (focal 500). `scene`: (cx, cy, yaw, vx, vy, cls) a box; by default four
    axis-aligned cars at `CENTERS`."""
    if scene is None:
        scene = [(cx, cy, 0.0, 0.0, 0.0, 1) for cx, cy in CENTERS]
    from unidistill_torch.ops.voxelize import voxelize_frame

    rng = np.random.RandomState(seed)
    P, G = cfg.caps.max_points, cfg.caps.max_gt_boxes
    pts = np.zeros((B, P, 5), np.float32)
    mask = np.zeros((B, P), bool)
    gt = np.zeros((B, G, 10), np.float32)
    for b in range(B):
        pts[b, :clutter, 0:2] = rng.uniform(-45, 45, (clutter, 2))
        pts[b, :clutter, 2] = rng.uniform(-2.0, -1.8, clutter)
        k = clutter
        for gi, (cx, cy, yaw, vx, vy, cls) in enumerate(scene):
            w, l, h, npb = 4.0, 6.0, 2.0, 250
            lx = rng.uniform(-l / 2, l / 2, npb)
            ly = rng.uniform(-w / 2, w / 2, npb)
            c, s = np.cos(yaw), np.sin(yaw)
            pts[b, k:k + npb, 0] = cx + c * lx - s * ly
            pts[b, k:k + npb, 1] = cy + s * lx + c * ly
            pts[b, k:k + npb, 2] = rng.uniform(-1.5, 0.5, npb)
            k += npb
            gt[b, gi] = [cx, cy, -0.5, l, w, h, yaw, vx, vy, cls]
        pts[b, :k, 3] = 128.0
        mask[b, :k] = True
    vfs, vcs = zip(*(voxelize_frame(pts[b], mask[b], cfg, True) for b in range(B)))
    out = {"points": pts, "points_mask": mask, "gt_boxes": gt,
           "voxel_feats": np.stack(vfs), "voxel_coords": np.stack(vcs)}
    if cfg.with_camera:
        ncam = cfg.camera_encoder.num_cams
        Hc, Wc = cfg.camera_encoder.final_dim
        out["imgs"] = rng.randn(B, ncam, Hc, Wc, 3).astype(np.float32)
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (B, ncam, 4, 4)).copy()
        intrin = eye.copy()
        intrin[..., 0, 0] = intrin[..., 1, 1] = 500.0
        intrin[..., 0, 2] = Wc / 2
        intrin[..., 1, 2] = Hc / 2
        out["mats"] = dict(sensor2ego_mats=eye, intrin_mats=intrin, ida_mats=eye.copy(),
                           bda_mat=np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy())
    return out


def concat_batches(*batches: Dict) -> Dict:
    """The batches' frames in one batch, in order."""
    out = {}
    for k, v in batches[0].items():
        out[k] = (concat_batches(*(b[k] for b in batches)) if isinstance(v, dict)
                  else np.concatenate([b[k] for b in batches], axis=0))
    return out


def random_scene(rng: np.random.RandomState, n_boxes: int = 4) -> List:
    """Boxes at random centres at least 15 m apart, random yaw and class
    (car, barrier or pedestrian), no velocity: a pattern that transfers to
    unseen layouts."""
    centers: List[Tuple[float, float]] = []
    while len(centers) < n_boxes:
        c = rng.uniform(-35, 35, 2)
        if all(np.hypot(c[0] - x, c[1] - y) > 15.0 for x, y in centers):
            centers.append(tuple(c))
    return [(cx, cy, rng.uniform(-np.pi, np.pi), 0.0, 0.0, int(rng.choice([1, 6, 9])))
            for cx, cy in centers]


def ang_diff(a, b):
    return np.abs(np.arctan2(np.sin(a - b), np.cos(a - b)))


@torch.no_grad()
def exact_batch_stats(model, batch: Dict, cfg: ModelConfig) -> None:
    """Set every BatchNorm's running statistics to the exact statistics of
    `batch` under the model's current weights (one train-mode forward in
    the cumulative mode), and leave the model in eval mode. After a few
    hundred steps the moving averages still lag the batch's (by
    exp(-steps/100) at momentum 0.99), which ruins an overfit's eval; the
    JAX gate recovers the same statistics from two forwards
    (`_exact_batch_stats`)."""
    device = next(model.parameters()).device
    calibrate_batchnorm(model, model_inputs(batch, cfg, device, training=True))


def _host(res: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(np.asarray(res[k].cpu() if isinstance(res[k], torch.Tensor) else res[k])
                 for k in ("boxes", "scores", "labels"))


def box_hits(res: Dict, scenes: Sequence[Scene]) -> Tuple[int, int]:
    """(hits, attr_hits) of the decodes `res` (boxes [B, R, 9], scores,
    labels, 1-based) against frame b's planted boxes `scenes[b]`: a box is
    hit when one of the frame's 16 best decodes lies within 5.4 m of its
    centre with a score above 0.3; the best-scoring such decode must then
    carry the box's class, its yaw within 0.45 rad and each velocity
    component within 0.8 for an attribute hit."""
    boxes, scores, labels = _host(res)
    hits = attr_hits = 0
    for b, scene in enumerate(scenes):
        top = np.argsort(-scores[b])[:TOP_K]
        for cx, cy, yaw, vx, vy, cls in scene:
            d = np.hypot(boxes[b, top, 0] - cx, boxes[b, top, 1] - cy)
            sc = scores[b, top]
            cand = (d < MATCH_RADIUS_M) & (sc > MIN_SCORE)
            if not np.any(cand):
                continue
            hits += 1
            j = top[cand][np.argmax(sc[cand])]
            attr_hits += int(labels[b, j] == cls and ang_diff(boxes[b, j, 6], yaw) < YAW_TOL
                             and abs(boxes[b, j, 7] - vx) < VEL_TOL and abs(boxes[b, j, 8] - vy) < VEL_TOL)
    return hits, attr_hits


def matched_score(res: Dict, scene: Scene) -> float:
    """Σ over the planted boxes of frame 0 of the best score among the 16
    best decodes within 5.4 m of the box's centre."""
    boxes, scores, _ = _host(res)
    boxes, scores = boxes[0], scores[0]
    top = np.argsort(-scores)[:TOP_K]
    total = 0.0
    for cx, cy, *_ in scene:
        m = np.hypot(boxes[top, 0] - cx, boxes[top, 1] - cy) < MATCH_RADIUS_M
        if np.any(m):
            total += float(scores[top][m].max())
    return total


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _train(stage: str, step: Callable[[], Dict], n_steps: int, keys: Sequence[str], device,
           on_step: Optional[OnStep] = None) -> Dict:
    """`n_steps` calls of `step`; the metrics `keys` of the first and the
    last step, read back only there. `on_step(stage, i, metrics)`, if
    given, runs after every step with its metrics (device tensors)."""
    _sync(device)
    t0 = time.perf_counter()
    first = m = None
    for i in range(n_steps):
        m = step()
        if on_step is not None:
            on_step(stage, i, m)
        if i == 0:
            first = {k: v for k, v in metrics_to_host(m).items() if k in keys}
    last = {k: v for k, v in metrics_to_host(m).items() if k in keys}
    seconds = time.perf_counter() - t0
    return dict(first=first, last=last, seconds=seconds, s_per_step=seconds / n_steps, steps=n_steps)


def overfit_gate(model, cfg: ModelConfig, n_steps: int = N_OVERFIT_STEPS, on_step=None) -> Dict:
    """G1 on an initialised LiDAR detector (trained in place). Returns the
    first and last loss terms, their ratios, hits and attribute hits of
    `n` boxes, and the training seconds."""
    device = next(model.parameters()).device
    scenes = [SCENE2, SCENE2B]
    batch = concat_batches(scene_batch(cfg, 1, seed=0, scene=SCENE2), scene_batch(cfg, 1, seed=1, scene=SCENE2B))
    opt = make_optimizer(model, train_config(LR_OVERFIT))
    state = TrainState()
    keys = [f"task_{t}/{n}_loss" for t in USED_TASKS for n in ("hm", "loc")]
    out = _train("overfit", lambda: train_step(state, batch, model, opt, cfg), n_steps, keys, device, on_step)
    out["ratio"] = {k: out["last"][k] / out["first"][k] for k in keys}
    exact_batch_stats(model, batch, cfg)
    out["hits"], out["attr_hits"] = box_hits(eval_step(model, batch, cfg), scenes)
    out["n"] = sum(len(s) for s in scenes)
    return out


def _bars(r: Dict) -> Tuple[int, int]:
    """G1's bars on hits and attribute hits: 5/8 of the boxes and 3/4 of
    the hits, rounded down; a pooled result carries their sums over the
    seeds (`pooled`), of which only the hits' is held."""
    return r.get("bar_hits", (5 * r["n"]) // 8), r.get("bar_attr", 3 * r["hits"] // 4)


def _loss_failures(r: Dict) -> List[str]:
    """G1's loss terms that are not finite or did not fall below their bar
    times their first value."""
    bad = [k for k, v in r["last"].items() if not np.isfinite(v)]
    for t in USED_TASKS:
        for name, bar in (("loc", LOC_RATIO), ("hm", HM_RATIO)):
            k = f"task_{t}/{name}_loss"
            if not r["last"][k] < bar * r["first"][k]:
                bad.append(f"{k} ratio {r['ratio'][k]:.4f} >= {bar}")
    return bad


def _hit_failures(r: Dict) -> List[str]:
    bar_hits, _ = _bars(r)
    return [] if r["hits"] >= bar_hits else [f"only {r['hits']}/{r['n']} planted boxes recovered (bar {bar_hits})"]


def _attr_failures(r: Dict) -> List[str]:
    _, bar_attr = _bars(r)
    return [] if r["attr_hits"] >= bar_attr else [
        f"only {r['attr_hits']}/{r['hits']} recovered boxes have the right class/yaw/velocity (bar {bar_attr})"]


def overfit_failures(r: Dict) -> List[str]:
    """What G1's result `r` fails of the JAX gate's thresholds."""
    return _loss_failures(r) + _hit_failures(r) + _attr_failures(r)


def ab_scenes() -> Tuple[List, List]:
    """G2's four training and two held-out scenes (`RandomState(7)`)."""
    rng = np.random.RandomState(7)
    train = [random_scene(rng) for _ in range(4)]
    return train, [random_scene(rng) for _ in range(2)]


def ab_gate(teacher, student_plain, student_dist, t_cfg: ModelConfig, s_cfg: ModelConfig,
            dcfg: DistillConfig, n_teacher: int = N_TEACHER_STEPS, n_student: int = N_STUDENT_STEPS,
            on_step=None) -> Dict:
    """G2 on `ab_scenes` (training frames at seeds 0-3, held-out ones at
    100-101, both modalities): trains the fusion `teacher` (in place), then
    the two LiDAR students, which must hold the same initial state, plain
    and distilled; each student's `exact_batch_stats` on each held-out
    batch, then `matched_score`. `on_step` as for `_train`, with the stages
    "teacher", "plain" and "distilled". Returns both scores and each
    stage's seconds."""
    device = next(teacher.parameters()).device
    train, held = ab_scenes()
    train_b = [scene_batch(t_cfg, 1, seed=i, scene=sc) for i, sc in enumerate(train)]
    held_b = [scene_batch(t_cfg, 1, seed=100 + i, scene=sc) for i, sc in enumerate(held)]
    nb = len(train_b)
    # each stage's step i trains on training frame i mod 4 (`TrainState.step` counts them)
    t_opt, t_state = make_optimizer(teacher, train_config(LR_TEACHER)), TrainState()
    out = {"teacher": _train("teacher", lambda: train_step(t_state, train_b[t_state.step % nb], teacher, t_opt,
                                                           t_cfg),
                             n_teacher, ("loss",), device, on_step)}
    teacher.eval().requires_grad_(False)

    p_opt, p_state = make_optimizer(student_plain, train_config(LR_STUDENT)), TrainState()
    out["plain"] = _train("plain", lambda: train_step(p_state, train_b[p_state.step % nb], student_plain, p_opt,
                                                      s_cfg),
                          n_student, ("loss",), device, on_step)
    d_opt, d_state = make_optimizer(student_dist, train_config(LR_STUDENT)), TrainState()
    out["distilled"] = _train(
        "distilled", lambda: distill_train_step(d_state, train_b[d_state.step % nb], student_dist, teacher, d_opt,
                                                s_cfg, t_cfg, dcfg),
        n_student, ("loss",) + DISTILL_TERMS, device, on_step)

    out["score_p"] = out["score_d"] = 0.0
    for hb, scene in zip(held_b, held):
        for name, model in (("score_p", student_plain), ("score_d", student_dist)):
            exact_batch_stats(model, hb, s_cfg)
            out[name] += matched_score(eval_step(model, hb, s_cfg), scene)
    return out


def distill_gate(student, teacher, s_cfg: ModelConfig, t_cfg: ModelConfig, dcfg: DistillConfig,
                 batch: Dict, n_steps: int = N_DISTILL_STEPS, lr: float = LR_DISTILL, on_step=None) -> Dict:
    """G3 (G4 at full width): `n_steps` distill steps of `student` from the
    frozen `teacher` on one batch. Returns the first and last distill terms
    and their ratios."""
    device = next(student.parameters()).device
    teacher.eval().requires_grad_(False)
    opt, state = make_optimizer(student, train_config(lr)), TrainState()
    out = _train("distill", lambda: distill_train_step(state, batch, student, teacher, opt, s_cfg, t_cfg, dcfg),
                 n_steps, DISTILL_TERMS, device, on_step)
    out["ratio"] = {k: out["last"][k] / out["first"][k] for k in DISTILL_TERMS}
    return out


def distill_failures(r: Dict) -> List[str]:
    """The distill terms that did not end below where they started."""
    return [f"{k}: {r['first'][k]:.6g} -> {r['last'][k]:.6g}" for k in DISTILL_TERMS
            if not r["last"][k] < r["first"][k]]


GATES = ("g1", "g2", "g3")


def seeded_model(cfg: ModelConfig, seed: int, device):
    """A detector with the port's own seeded initial weights
    (`training.loop.init_params`, as the `Trainer` draws them)."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training.loop import init_params
    return init_params(BEVFusionCenterHead(cfg), seed).to(device)


def tiny_configs(dtype: str = "bfloat16") -> Dict[str, ModelConfig]:
    """The tiny LiDAR, camera and fusion configurations at `dtype`."""
    from unidistill_torch.configs.nuscenes import tiny_model
    cfgs = dict(lidar=tiny_model(with_camera=False), camera=tiny_model(with_lidar=False), fusion=tiny_model())
    return {k: dataclasses.replace(c, compute_dtype=dtype) for k, c in cfgs.items()}


def run_gate(gate: str, seed: int, device, dtype: str = "bfloat16", on_step: Optional[OnStep] = None) -> Dict:
    """One tiny gate from the port's own init: G1's detector at `seed`; G2's
    teacher at `seed` and both students at `seed + 42`; G3's student at
    `seed` and teacher at `seed + 1` (the JAX gate's keys 0, 42 and 1 at
    seed 0). The result carries `failures`, empty when the gate holds."""
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS
    cfgs = tiny_configs(dtype)
    if gate == "g1":
        r = overfit_gate(seeded_model(cfgs["lidar"], seed, device), cfgs["lidar"], on_step=on_step)
        r["failures"] = overfit_failures(r)
    elif gate == "g2":
        r = ab_gate(seeded_model(cfgs["fusion"], seed, device), seeded_model(cfgs["lidar"], seed + 42, device),
                    seeded_model(cfgs["lidar"], seed + 42, device), cfgs["fusion"], cfgs["lidar"],
                    DISTILL_VARIANTS[("fusion", "lidar")], on_step=on_step)
        r["failures"] = [] if r["score_d"] > r["score_p"] else [
            f"distilled student {r['score_d']:.4f} does not beat plain {r['score_p']:.4f}"]
    elif gate == "g3":
        batch = scene_batch(cfgs["fusion"])  # both modalities: what the student and the teacher read
        r = distill_gate(seeded_model(cfgs["camera"], seed, device), seeded_model(cfgs["lidar"], seed + 1, device),
                         cfgs["camera"], cfgs["lidar"], DISTILL_VARIANTS[("lidar", "camera")], batch,
                         on_step=on_step)
        r["failures"] = distill_failures(r)
    else:
        raise ValueError(f"unknown gate {gate!r}; one of {GATES}")
    return r


def pooled(gate: str, results: Dict[int, Dict]) -> Dict:
    """Several seeds' results of one gate (`{seed: result}`) held as one.
    Only what the JAX gate counts is totalled: G1's hits, at least Σ 5/8 of
    the boxes, and G2's scores, Σ score_d above Σ score_p. Everything else
    holds for each seed alone, at the JAX gate's bar for one run: G1's
    loss ratios and attribute hits, G3's distill terms."""
    def each(failures):
        return [f"seed {s}: {f}" for s, r in results.items() for f in failures(r)]

    if gate == "g2":
        r = dict(score_d=sum(x["score_d"] for x in results.values()),
                 score_p=sum(x["score_p"] for x in results.values()))
        r["failures"] = [] if r["score_d"] > r["score_p"] else [
            f"distilled students {r['score_d']:.4f} do not beat plain {r['score_p']:.4f} over the seeds"]
    elif gate == "g1":
        r = {k: sum(x[k] for x in results.values()) for k in ("hits", "attr_hits", "n")}
        r.update(bar_hits=sum(_bars(x)[0] for x in results.values()),
                 bar_attr=sum(_bars(x)[1] for x in results.values()))
        r["failures"] = each(lambda x: _loss_failures(x) + _attr_failures(x)) + _hit_failures(r)
    elif gate == "g3":
        r = dict(failures=each(distill_failures))
    else:
        raise ValueError(f"unknown gate {gate!r}; one of {GATES}")
    return r


def summary(gate: str, r: Dict) -> Dict:
    """The margins of a gate's result, rounded for a log line."""
    out: Dict = {"gate": gate}
    if "ratio" in r:
        out.update(first={k: round(v, 6) for k, v in r["first"].items()},
                   last={k: round(v, 6) for k, v in r["last"].items()},
                   ratio={k: round(v, 4) for k, v in r["ratio"].items()})
    if "hits" in r:
        bar_hits, bar_attr = _bars(r)
        out.update(hits=r["hits"], attr_hits=r["attr_hits"], n=r["n"], bar_hits=bar_hits, bar_attr=bar_attr)
    if "score_d" in r:
        out.update(score_d=round(r["score_d"], 4), score_p=round(r["score_p"], 4),
                   margin=round(r["score_d"] - r["score_p"], 4))
        if "distilled" in r:
            out.update(distilled_first={k: round(v, 6) for k, v in r["distilled"]["first"].items()},
                       distilled_last={k: round(v, 6) for k, v in r["distilled"]["last"].items()},
                       s_per_step={s: round(r[s]["s_per_step"], 4) for s in ("teacher", "plain", "distilled")})
    elif "s_per_step" in r:
        out["s_per_step"] = round(r["s_per_step"], 4)
    out["failures"] = r.get("failures", [])
    return out
