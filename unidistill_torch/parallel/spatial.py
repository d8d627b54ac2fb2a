"""BEV-grid spatial sharding over a (dp, bev) world of ranks; the port's
counterpart of the JAX package's `parallel/spatial.py`.

The JAX path pins the encoders' map (`model_output`) and `bev_feature` to
`P(dp, bev)` inside one GSPMD program: the dense BEV backbone and the
CenterHead run split by grid rows, XLA inserts the halos, and every loss
normaliser, BatchNorm statistic and gradient is a reduction over the global
batch. The port runs one process a rank (`parallel.mesh.spatial_groups`):

  * each rank loads its dp shard's rows of the global batch, runs the
    encoders (and the fusion encoder's gate, a mean over the whole map) on
    them, then keeps its own block of BEV rows (`RowSplit.split`);
  * the backbone's and the head's convs read their halo rows from the bev
    neighbours (`RowSplit.conv`: an all-gather of each block's edge rows,
    whose backward sends each halo's gradient back to the rows it came
    from); a transposed conv with kernel = stride needs none;
  * `bev_feature` and the head's maps are all-gathered over bev
    (`RowSplit.gather`), so the losses, decode and NMS read whole maps;
  * every BatchNorm takes its statistics over the global batch
    (`global_batch_stats`): the backbone's and the head's over the whole
    world, the encoders' (replicated on the b peers of a dp shard) over
    dp, and with one dp shard from the rank's own rows, which are the
    whole batch; the running statistics are the same on every rank. (The
    backward of a reduction over dp alone is right too: each bev peer
    backpropagates its share of the statistics' gradient, and the
    parameter gradients are summed over the world.)
  * eval decodes and runs NMS on each dp shard's whole maps, as JAX does;
  * in training the maps, the encoders' map and the GT boxes are gathered
    over dp too (`global_batch`), and every rank computes the one loss of
    the global batch, its normalisers the global counts, as the JAX step
    with `axis_name=None` does (the data-parallel step's per-rank
    normalisers differ from it: a task with no positive sums its negatives
    per rank). The gathers' backward takes the rank's own rows, and a
    tensor the loss reads whole (the encoders' map, `awl_params`) passes
    1/b (1/(b·dp)) of its gradient (`scale_grad`), so each rank's
    parameter gradients are its share of the global one; they are summed
    over the world (`reduce_gradients`).

Row blocks: the map's rows at the backbone's coarsest stride are split as
evenly as they go (90 rows over 4: 23, 23, 22, 22), and each block is that
many coarse rows at every finer stride, so a strided conv's output block
is whole. Every collective is an all-gather or an all-reduce (both taken by
gloo on CUDA tensors and by NCCL).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from unidistill_torch.parallel.mesh import SpatialGroups, average_gradients


def row_blocks(rows: int, parts: int) -> List[int]:
    """`rows` split into `parts` blocks as evenly as they go, the larger
    ones first (`np.array_split`)."""
    if rows < parts:
        raise ValueError(f"{rows} coarse BEV rows cannot be split over {parts} ranks")
    return [len(a) for a in np.array_split(np.arange(rows), parts)]


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


class _Halo(torch.autograd.Function):
    """[B, C, h, W] -> [B, C, top + h + bottom, W]: the peer above's last
    `top` rows and the peer below's first `bottom` rows around the block
    (zeros past the map's edges)."""

    @staticmethod
    def forward(ctx, x, top, bottom, group, rank):
        (B, C, h, W), n = x.shape, dist.get_world_size(group)
        ctx.top, ctx.bottom, ctx.h, ctx.group, ctx.rank = top, bottom, h, group, rank
        peers = _all_gather(torch.cat([x[:, :, :bottom], x[:, :, h - top :]], 2), group)
        up = peers[rank - 1][:, :, bottom:] if rank > 0 else x.new_zeros(B, C, top, W)
        down = peers[rank + 1][:, :, :bottom] if rank < n - 1 else x.new_zeros(B, C, bottom, W)
        return torch.cat([up, x, down], 2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, h, rank = ctx.top, ctx.bottom, ctx.h, ctx.rank
        peers = _all_gather(torch.cat([g[:, :, :top], g[:, :, top + h :]], 2), ctx.group)
        gx = g[:, :, top : top + h].clone()
        if rank > 0 and bottom:  # the peer above's bottom halo was my first rows
            gx[:, :, :bottom] += peers[rank - 1][:, :, top:]
        if rank < len(peers) - 1 and top:  # the peer below's top halo was my last rows
            gx[:, :, h - top :] += peers[rank + 1][:, :, :top]
        return gx, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """Every peer's block [B, C, counts[j], W] -> the whole map; backward:
    this rank's rows of the map's gradient (every peer holds the same)."""

    @staticmethod
    def forward(ctx, x, counts, group, rank):
        hmax = max(counts)
        pad = F.pad(x, (0, 0, 0, hmax - x.shape[2]))
        blocks = _all_gather(pad, group)
        ctx.start, ctx.h = sum(counts[:rank]), counts[rank]
        return torch.cat([b[:, :, :c] for b, c in zip(blocks, counts)], 2)

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.start : ctx.start + ctx.h].contiguous(), None, None, None


class _GatherBatch(torch.autograd.Function):
    """Every dp shard's rows [b, ...] -> the global batch [dp·b, ...];
    backward: this shard's rows of the gradient (every rank holds the
    same)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        return torch.cat(_all_gather(x, group), 0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows[0] : ctx.rows[1]].contiguous(), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """`x`, with its gradient multiplied by `scale` on the way back."""
    return _ScaleGrad.apply(x, scale)


class RowSplit:
    """This rank's block of a map of `rows` BEV rows in its dp shard's bev
    group. `coarse` [b]: every block's rows at the backbone's coarsest
    stride `stride`."""

    def __init__(self, groups: SpatialGroups, rows: int, stride: int):
        if rows % stride:
            raise ValueError(f"{rows} BEV rows do not divide by the backbone's stride {stride}")
        self.group, self.rank, self.size = groups.bev, groups.bev_rank, groups.bev_size
        self.coarse = row_blocks(rows // stride, self.size)

    def counts(self, x: torch.Tensor) -> List[int]:
        """Every block's rows at the resolution of `x`, this rank's block."""
        f = x.shape[2] // self.coarse[self.rank]
        return [c * f for c in self.coarse]

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole map [B, C, H, W]."""
        f = x.shape[2] // sum(self.coarse)
        start = sum(self.coarse[: self.rank]) * f
        return x[:, :, start : start + self.coarse[self.rank] * f]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from every peer's block of it."""
        return _GatherRows.apply(x, self.counts(x), self.group, self.rank)

    def conv(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """`conv` (a `layers.common` Conv2d or ConvTranspose2d) on this
        rank's block: the block's rows of the conv over the whole map."""
        if isinstance(conv, nn.ConvTranspose2d):
            if conv.kernel_size[0] != conv.stride[0] or conv.padding[0] or conv.output_padding[0]:
                raise ValueError(f"a row-split transposed conv needs kernel = stride, got {conv}")
            return conv(x)
        (k, _), (s, _), (p, pw), (d, _) = conv.kernel_size, conv.stride, conv.padding, conv.dilation
        if d != 1 or x.shape[2] % s:
            raise ValueError(f"cannot row-split {conv} over blocks of {x.shape[2]} rows")
        # output rows [o0, o1) = input rows [o0·s, o1·s) read [o0·s − p, (o1 − 1)·s − p + k)
        top, bottom = p, k - s - p
        if bottom < 0:
            x = x[:, :, : x.shape[2] + bottom]
            bottom = 0
        if top or bottom:
            x = _Halo.apply(x, top, bottom, self.group, self.rank)
        dt = conv.compute_dtype
        bias = None if conv.bias is None else conv.bias.to(dt)
        return F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride, (0, pw), 1, conv.groups)


# the model's modules that run before the split, on the whole map, the same
# on every bev peer of a dp shard
BEFORE_SPLIT = ("lidar_encoder", "camera_encoder", "fusion_encoder")


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, groups: SpatialGroups):
    """While the context is open, every `layers.common.BatchNorm` of
    `model` takes its training statistics over the global batch: the
    encoders' over the dp ranks of this rank's bev index (none with one dp
    shard: the rank's rows are the batch), the rest over the world."""
    from unidistill_torch.layers.common import BatchNorm

    before = groups.dp if groups.dp_size > 1 else None
    bns = []
    for name, child in model.named_children():
        for m in child.modules():
            if isinstance(m, BatchNorm):
                m.stats_group = before if name in BEFORE_SPLIT else groups.world
                bns.append(m)
    try:
        yield
    finally:
        for m in bns:
            m.stats_group = None


def forward_spatial(model: nn.Module, batch: Dict[str, Any], cfg, groups: SpatialGroups,
                    train: bool = False) -> Dict:
    """The model's forward with the dense BEV pipeline split by rows over
    the bev peers (see the module docstring); in train mode every
    BatchNorm's statistics are global. Returns the model's output dict:
    whole maps on every rank."""
    from unidistill_torch.training.steps import model_inputs

    device = next(model.parameters()).device
    kw = model_inputs(batch, cfg, device, training=train)
    if not train:
        return model(**kw, spatial=groups)
    with global_batch_stats(model, groups):
        return model(**kw, spatial=groups)


@torch.no_grad()
def eval_step_spatial(model: nn.Module, batch: Dict[str, Any], cfg, groups: SpatialGroups):
    """`training.steps.eval_step` through `forward_spatial`: decode and NMS
    on the gathered maps, the same ROIs on every peer of a dp shard."""
    from unidistill_torch.decode.proposals import generate_proposals

    if model.training:
        raise ValueError("eval_step_spatial needs the model in eval mode (model.eval())")
    out = forward_spatial(model, batch, cfg, groups, train=False)
    return generate_proposals(out["multi_head_features"], cfg.proposal, cfg.tasks, cfg.point_cloud_range[:2],
                              cfg.voxel_size[:2], cfg.out_size_factor, training=False)


def global_batch(out: Dict, gt_boxes: torch.Tensor, groups: SpatialGroups):
    """`forward_spatial`'s output and the GT boxes of the rank's dp shard
    -> those of the global batch, gathered over dp, as the JAX step's loss
    reads them: every rank then computes the one global loss. A map's
    backward takes the shard's rows; `awl_params` (read by every rank)
    passes 1/dp of its gradient, on top of the model's 1/b."""
    if groups.dp_size == 1:
        return out, gt_boxes

    def cat(x):
        return _GatherBatch.apply(x, groups.dp, groups.dp_rank)

    heads = [{k: cat(v) for k, v in h.items()} for h in out["multi_head_features"]]
    return dict(model_output=cat(out["model_output"]), bev_feature=cat(out["bev_feature"]),
                multi_head_features=heads,
                awl_params=scale_grad(out["awl_params"], 1.0 / groups.dp_size)), cat(gt_boxes)


def reduce_gradients(params, groups: SpatialGroups) -> None:
    """Each rank holds its share of the gradient of the one global loss:
    they are summed over the world."""
    average_gradients(params, groups.world, divisor=1)


def train_step_spatial(state, batch: Dict[str, Any], model: nn.Module, optimizer, cfg,
                       groups: SpatialGroups) -> Dict[str, torch.Tensor]:
    """`training.steps.train_step` with the forward through
    `forward_spatial` and the loss on the global batch (`global_batch`),
    its normalisers the global counts (JAX's `axis_name=None`); the
    gradients summed over the world. Every rank returns the same metrics."""
    from unidistill_torch.training.steps import _tensor, _update, detector_loss

    model.train()
    out = forward_spatial(model, batch, cfg, groups, train=True)
    out, gt = global_batch(out, _tensor(batch["gt_boxes"], out["awl_params"].device), groups)
    loss, metrics, _ = detector_loss(out, gt, cfg)
    return _update(state, loss, optimizer, metrics, None, lambda ps: reduce_gradients(ps, groups))


def distill_train_step_spatial(state, batch: Dict[str, Any], student: nn.Module, teacher: nn.Module,
                               optimizer, student_cfg, teacher_cfg, dcfg,
                               groups: SpatialGroups) -> Dict[str, torch.Tensor]:
    """`training.steps.distill_train_step` with both forwards through
    `forward_spatial` (the teacher's in eval mode, under no_grad) and the
    losses on the global batch, as `train_step_spatial`."""
    from unidistill_torch.training.steps import _tensor, _update, distill_loss

    teacher.eval()
    with torch.no_grad():
        t_out = forward_spatial(teacher, batch, teacher_cfg, groups, train=False)
    student.train()
    out = forward_spatial(student, batch, student_cfg, groups, train=True)
    gt = _tensor(batch["gt_boxes"], out["awl_params"].device)
    out, gt_all = global_batch(out, gt, groups)
    with torch.no_grad():
        t_out, _ = global_batch(t_out, gt, groups)
    total, metrics = distill_loss(out, t_out, dict(gt_boxes=gt_all), student_cfg, dcfg)
    return _update(state, total, optimizer, metrics, None, lambda ps: reduce_gradients(ps, groups))
