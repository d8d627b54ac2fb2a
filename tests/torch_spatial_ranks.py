"""Rank-side functions of the spatial tests (`tests/test_torch_spatial.py`),
in a module that imports no JAX: a rank spawned by
`parallel.launch.run_ranks` imports the module that holds its function.

Every function builds the tiny models from numpy state dicts, runs one
step of the (dp, bev) path on the default gloo group of the world and
returns numpy results.
"""
import numpy as np
import torch

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.parallel import mesh as parallel


_GROUPS = None


def dp_rows(batch, dp_rank, per_shard):
    """Rows [d·b, (d+1)·b) of every array of a batch (nested dicts)."""
    if isinstance(batch, dict):
        return {k: dp_rows(v, dp_rank, per_shard) for k, v in batch.items()}
    return batch[dp_rank * per_shard : (dp_rank + 1) * per_shard]


def _model(cfg, sd):
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead

    model = BEVFusionCenterHead(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model


def _state(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _grads(model, metrics, opt):
    """The step's gradients before the clip (`.grad` holds the clipped ones)."""
    unclip = max(1.0, metrics["grad_norm"] / opt.grad_clip)
    return {k: (p.grad * unclip).numpy() for k, p in model.named_parameters()}


def rank_spatial_kinds(rank, kinds, *args):
    """`rank_spatial` for each of `kinds` in turn, in one world: {kind: result}."""
    return {kind: rank_spatial(rank, kind, *args) for kind in kinds}


def rank_spatial(rank, kind, bev, cfg, sd, batch, train_cfg=None, t_cfg=None, t_sd=None, pair=None):
    """One spatial step of `kind` ("eval", "train" or "distill") on this
    rank's dp shard of `batch`, `bev` ranks a shard. Returns the rank's
    (dp, bev) place and row blocks, and its ROIs and whole maps (eval) or
    host metrics, gradients before the clip and new state (train,
    distill)."""
    from unidistill_torch.parallel import spatial
    from unidistill_torch.training.steps import metrics_to_host
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    global _GROUPS
    if _GROUPS is None:  # one set of subgroups a world
        _GROUPS = parallel.spatial_groups(parallel.init_from_env("cpu"), bev)
    groups = _GROUPS
    per_shard = len(batch["gt_boxes"]) // groups.dp_size
    mine = dp_rows(batch, groups.dp_rank, per_shard)
    model = _model(cfg, sd)
    stride = int(np.prod(model.bev_encoder.layer_strides))
    out = dict(place=(groups.dp_rank, groups.bev_rank),
               blocks=spatial.RowSplit(groups, cfg.grid_size[1] // cfg.out_size_factor, stride).coarse)
    if kind == "eval":
        model.eval()
        rois = spatial.eval_step_spatial(model, mine, cfg, groups)
        with torch.no_grad():
            maps = spatial.forward_spatial(model, mine, cfg, groups)
        out["rois"] = {k: v.numpy() for k, v in rois.items()}
        out["maps"] = dict(bev_feature=maps["bev_feature"].numpy(),
                           hm=np.concatenate([h["hm"].numpy() for h in maps["multi_head_features"]], 1))
        return out
    opt = make_optimizer(model, train_cfg)
    if kind == "train":
        m = spatial.train_step_spatial(TrainState(), mine, model, opt, cfg, groups)
    else:
        teacher = _model(t_cfg, t_sd).requires_grad_(False)
        m = spatial.distill_train_step_spatial(TrainState(), mine, model, teacher, opt, cfg, t_cfg,
                                               cfgs.DISTILL_VARIANTS[pair], groups)
    m = metrics_to_host(m)
    out.update(metrics=m, state=_state(model), grads=_grads(model, m, opt))
    return out


def one_process_step(kind, cfg, sd, batch, train_cfg, t_cfg=None, t_sd=None, pair=None):
    """The port's one-process step on the whole batch: (host metrics, new
    state, gradients before the clip); for `kind` "eval", the whole maps
    of the eval forward."""
    from unidistill_torch.training.steps import distill_train_step, metrics_to_host, train_step
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    model = _model(cfg, sd)
    if kind == "eval":
        from unidistill_torch.training.steps import model_inputs

        model.eval()
        with torch.no_grad():
            maps = model(**model_inputs(batch, cfg, "cpu", training=False))
        return dict(bev_feature=maps["bev_feature"].numpy(),
                    hm=np.concatenate([h["hm"].numpy() for h in maps["multi_head_features"]], 1))
    opt = make_optimizer(model, train_cfg)
    if kind == "train":
        m = train_step(TrainState(), batch, model, opt, cfg)
    else:
        teacher = _model(t_cfg, t_sd).requires_grad_(False)
        m = distill_train_step(TrainState(), batch, model, teacher, opt, cfg, t_cfg,
                               cfgs.DISTILL_VARIANTS[pair])
    m = metrics_to_host(m)
    return m, _state(model), _grads(model, m, opt)



def trainer_predict_and_step(root, out_dir, spatial_bev, batch):
    """The tiny camera detector's `Trainer` (float32, `train.spatial_bev`)
    over the synthetic mini-nuScenes at `root`, its loaders made as the
    launchers make them (`-b batch`): `predict` on the validation split,
    then one `train_step` on the first training batch. Joins the process
    group of its process, if there is one."""
    import dataclasses

    from unidistill_torch.exps.base_cli import build_parser, make_loader
    from unidistill_torch.training.loop import Trainer
    from unidistill_torch.training.steps import metrics_to_host

    exp = cfgs.ExpConfig(
        exp_name="tiny_camera",
        model=dataclasses.replace(cfgs.tiny_model(with_lidar=False), compute_dtype="float32"),
        data=cfgs.DataConfig(root_path=root, num_lidar_sweeps=2, use_cbgs=False),
        train=cfgs.TrainConfig(batch_size_per_device=batch, max_epochs=1, spatial_bev=spatial_bev))
    args = build_parser().parse_args(["--num_workers", "0", "--device", "cpu"])
    trainer = Trainer(exp, output_dir=out_dir, device="cpu")
    try:
        _, val = make_loader(exp, exp.model, "validation", args, trainer)
        _, train = make_loader(exp, exp.model, "training", args, trainer)
        state = trainer.init_state(len(train))
        preds = trainer.predict(val)
        first = next(iter(train))
        metrics = metrics_to_host(trainer.train_step(state, first))
        return dict(preds=preds, tokens=[m["token"] for m in first["meta"]], metrics=metrics,
                    state=_state(trainer.model))
    finally:
        trainer.close()


def rank_trainer(rank, root, out_dir, spatial_bev, batch):
    return trainer_predict_and_step(root, out_dir, spatial_bev, batch)


def rank_global_batch_norm(rank, shapes, seed):
    """For each shape ([N, C] or [N, C, H, W]): a `layers.common.BatchNorm`
    in training over this rank's rows of a seeded input (rank 0 the first
    `rows0`, rank 1 the rest), its statistics over both ranks. Returns the
    outputs, the running statistics, the input's and the affine
    parameters' gradients (the latter summed over the ranks) of a fixed
    linear loss."""
    from unidistill_torch.layers.common import BatchNorm

    group = parallel.init_from_env("cpu")
    out = {}
    for shape, rows0 in shapes:
        x, w = _bn_case(shape, seed)
        mine = slice(0, rows0) if rank == 0 else slice(rows0, shape[0])
        bn = BatchNorm(shape[1], eps=1e-3, momentum=0.9)
        bn.stats_group = group
        xs = x[mine].clone().requires_grad_(True)
        y = bn(xs)
        (y * w[mine]).sum().backward()
        grads = torch.cat([bn.weight.grad, bn.bias.grad])
        torch.distributed.all_reduce(grads, group=group)
        out[shape] = dict(y=y.detach().numpy(), gx=xs.grad.numpy(), gparams=grads.numpy(),
                          stats=np.stack([bn.running_mean.numpy(), bn.running_var.numpy()]))
    return out


def _bn_case(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0 + 1.5
    return x, torch.randn(shape, generator=g)
