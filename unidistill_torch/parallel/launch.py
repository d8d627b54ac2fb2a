"""A local world of ranks in spawned processes, as `torchrun --nproc_per_node
N` makes one, for the tests and the smoke run:

    results = run_ranks(fn, 2, args)

runs `fn(rank, *args)` in each of 2 processes that have joined one gloo
process group (gloo takes CPU and CUDA tensors, and any number of ranks on
one card; RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set as
`torchrun` sets them) and returns the ranks' return values in rank order.
A return value goes back pickled: numbers, numpy arrays and CPU tensors.

With `init_group=False` a rank only gets the environment, and `fn` makes
the group itself (as a launcher under `torchrun` does, through
`mesh.init_from_env`).

A world fails loudly: a rank that raises, exits without a result or
outlasts `timeout_s` kills every rank, and `run_ranks` raises with the
tracebacks of the ranks that failed. The group's own timeout is `timeout_s` too, so a rank
blocked in a collective by a dead peer fails rather than hangs.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, ranks_per_card, timeout_s, threads, init_group, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank // ranks_per_card),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        if not init_group:
            out = fn(rank, *args)
        else:
            dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world_size,
                                    timeout=datetime.timedelta(seconds=timeout_s))
            try:
                out = fn(rank, *args)
            finally:
                dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, failed: dict, grace_s: float = 3.0) -> str:
    """The tracebacks of `failed` and of every rank that fails within
    `grace_s` after it (a peer's failure often reaches the parent first,
    as a broken connection)."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            r, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failed[r] = payload
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *, ranks_per_card: int = 1,
              timeout_s: float = 600.0, threads: int = 0, init_group: bool = True) -> List[Any]:
    """`fn(rank, *args)` on `world_size` spawned ranks of one gloo group
    (see the module docstring). `fn` must be importable by name (a
    module-level function). `ranks_per_card` ranks share each card
    (LOCAL_RANK = rank // ranks_per_card). `threads` > 0 sets each rank's
    intra-op threads."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, ranks_per_card, timeout_s, threads, init_group,
                               tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    # a rank may exit just after it queued its result: drain once more
                    try:
                        r, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                           "and no result") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} gave no result "
                                       f"within {timeout_s:.0f} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(results, {r: payload}))
            out[r] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 10.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with code {p.exitcode} after its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        results.close()
    return [out[r] for r in range(world_size)]
