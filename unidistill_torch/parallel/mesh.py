"""Ranks, the process group and the data-parallel collectives; the port's
counterpart of the JAX package's `parallel/mesh.py`.

The reference's only parallelism is DDP over NCCL. The JAX package runs it
as one program over a `dp` mesh: the global batch split on axis 0, the
parameters replicated, the loss normalisers and the gradients `pmean`'d
inside the step. The port runs one process a rank, as `torchrun` starts
them, each on its own device with its own rows of the global batch; the
`pmean`s become all-reduces over the process group (`pmean`,
`average_gradients`), the eval gather `all_gather_object`.

`group` is the process group (`init_from_env`), or None for one process:
every function is then the identity or a passthrough.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a rank waits in a collective (or for its peers to join) before it
# fails: a rank that dies leaves the others blocked
GROUP_TIMEOUT_S = 600
# gradients are all-reduced in flat buckets of about this many bytes
BUCKET_BYTES = 25 * 2**20


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in `group` (the default group when None); 0
    without a process group."""
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None) -> int:
    """The number of ranks in `group`; 1 without a process group."""
    return dist.get_world_size(group) if is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """The rank's device: `cuda:LOCAL_RANK` for "cuda" (LOCAL_RANK as
    `torchrun` sets it, 0 when unset), any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_from_env(device="cuda"):
    """The data-parallel group. The process group already initialised, if
    there is one (a caller may make its own, e.g. gloo on CUDA tensors);
    else, where `torchrun`'s environment is set (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), a new one: NCCL for a CUDA device, gloo for
    the CPU; else None (one process). A group that will not initialise
    raises."""
    if is_initialized():
        return dist.group.WORLD
    if "WORLD_SIZE" not in os.environ:
        return None
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.group.WORLD


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (`jax.lax.pmean`): a sum
    all-reduce of a detached copy, divided by the world size; no gradient
    flows through it. `x` itself where `group` is None."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / dist.get_world_size(group)


def _buckets(params: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Parameters in order, cut into runs of one dtype and device of about
    `BUCKET_BYTES` each."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for p in params:
        last = out[-1][-1] if out else None
        if last is None or size >= BUCKET_BYTES or (p.dtype, p.device) != (last.dtype, last.device):
            out.append([])
            size = 0
        out[-1].append(p)
        size += p.numel() * p.element_size()
    return out


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Replace each parameter's gradient by its mean over the ranks of
    `group` (the JAX step's `pmean` of the gradients), in flat bucketed
    all-reduces, all started before the first is waited on. A parameter
    without a gradient gets a zero one first, as every leaf has one in JAX.
    Every rank ends with the same bits. Nothing where `group` is None."""
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    n = dist.get_world_size(group)
    pending = []
    for bucket in _buckets(params):
        grads = [p.grad for p in bucket]
        flat = torch.cat([g.reshape(-1) for g in grads])
        pending.append((grads, flat, dist.all_reduce(flat, group=group, async_op=True)))
    for grads, flat, work in pending:
        work.wait()
        flat.div_(n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def broadcast_object(obj: Any, group) -> Any:
    """Rank 0's `obj` on every rank (`broadcast_object_list`); `obj` where
    `group` is None."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def broadcast_stamp(stamp: str, group) -> str:
    """Rank 0's timestamp on every rank, so that all ranks share one output
    directory (the JAX package's `training/loop.py` `_broadcast_stamp`)."""
    return broadcast_object(stamp, group)


def interleave_process_results(per_process: Sequence[Sequence], total: Optional[int] = None) -> list:
    """Per-rank result lists interleaved [p0[0], p1[0], ..., p0[1], ...]
    and cut to `total` (the reference's eval-gather reconstruction, whose
    samplers stride the dataset by rank)."""
    out = []
    for row in zip(*per_process):
        out.extend(row)
    return out if total is None else out[:total]


def all_gather_host_objects(local: Sequence, total: Optional[int] = None, group=None) -> list:
    """Every rank's list of host objects (picklable; every rank gives as
    many), interleaved as `interleave_process_results` does, on every rank
    (`all_gather_object`). A passthrough where `group` is None."""
    if group is None:
        return list(local) if total is None else list(local)[:total]
    per_process: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(per_process, list(local), group=group)
    return interleave_process_results(per_process, total)
