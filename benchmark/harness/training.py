"""The training cells' session: one training step object (model, optimizer
and state; with a frozen teacher for distillation) built in set-up, driven
through its first steps there, and handed to the window.

Set-up runs the step's first three calls on the first three batches of the
pool, which all differ, through the window's own call and as the window
makes them: back to back, the metrics read back once after the third. A
snapshot of the parameters before them, of Adam's first moment after step 1
(the first gradient as the optimizer got it, clipped: exp_avg / (1 − β1))
and of the parameters and BatchNorm statistics after step 3 is copied on the
device in stream order, and brought to the host after the third step.
The window then steps in a closed loop, `batch` frames a step, over the pool
in a seeded order, reading the metrics back every `readback_every` steps
and at its end.

`correct`: the plain float32 reference follows the same three steps from the
same weights and batches. Compared, each as its worst case: the loss terms
of each step; the first gradient's norm by leaf; the parameters' change
after three steps by leaf, worst and median (leaves whose reference gradient
is under a thousandth of the median leaf's left out: they move by round-off
alone);
the BatchNorm statistics' change by leaf; and, with a teacher, its BEV map
of the first step."""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import torch

from benchmark.harness import compare
from benchmark.harness import setup as su
from benchmark.harness.result import Reading, readings
from benchmark.harness.work import PEAKS, bev_pool_work, bound_s, matmul_flops, sparse_conv_work
from benchmark.inputs import synthetic

FIRST_STEPS = 3
BETA1 = 0.9
STAT_LEAVES = ("running_mean", "running_var")


def _stats(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in model.state_dict().items() if k.rsplit(".", 1)[-1] in STAT_LEAVES}


def _params(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in model.named_parameters() if p.requires_grad}


def _first_moment(model, adamw) -> Dict[str, torch.Tensor]:
    """The first gradient as Adam got it (clipped), a copy on the device."""
    return {k: adamw.state[p]["exp_avg"] / (1.0 - BETA1) for k, p in model.named_parameters() if p in adamw.state}


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.to("cpu", copy=True) for k, v in tensors.items()}


class TrainSession:
    """`distill`: the configuration has a frozen `teacher` and the step is
    `distill_train_step`; else `train_step` on `model`."""

    def __init__(self, ctx, distill: bool):
        from unidistill_torch.configs import nuscenes
        from unidistill_torch.models.bevfusion import BEVFusionCenterHead
        from unidistill_torch.training import steps
        from unidistill_torch.training.train_state import TrainState, make_optimizer

        from benchmark.reference import config as rconfig

        self.ctx, self.distill = ctx, distill
        t, dev, clock = ctx.traffic, ctx.device, ctx.clock
        cf, rcf = su.configs(ctx.config, nuscenes), su.configs(ctx.config, rconfig)
        key = "student" if distill else "model"
        self.cfg, self.rcfg = getattr(cf, key), getattr(rcf, key)
        self.tcfg = cf.teacher if distill else None
        self.rtcfg = rcf.teacher if distill else None
        self.cf, self.rcf = cf, rcf
        self.B = t["batch"]
        clock.lap("import")
        if t["pool"] < FIRST_STEPS:
            raise ValueError(f"the pool needs at least {FIRST_STEPS} batches for the first steps")
        sd = su.weights(self.rcfg, ctx.seed, su.STREAM_WEIGHTS, dev)
        tsd = su.weights(self.rtcfg, ctx.seed, su.STREAM_TEACHER, dev) if distill else None
        clock.lap("weights", dev)
        g = synthetic.generator(ctx.seed, su.STREAM_POOL, dev)
        caps_points = (self.tcfg or self.cfg).caps.max_points
        self.pool = [synthetic.train_batch(self.cfg.camera_encoder, caps_points, self.cfg.caps.max_gt_boxes,
                                           self.B, g, dev, with_points=distill) for _ in range(t["pool"])]
        clock.lap("inputs", dev)
        self.model = BEVFusionCenterHead(self.cfg).to(dev)
        self.model.load_state_dict(sd)
        del sd
        self.teacher = None
        if distill:
            self.teacher = BEVFusionCenterHead(self.tcfg).to(dev)
            self.teacher.load_state_dict(tsd)
            del tsd
            self.teacher.requires_grad_(False)
            synthetic.calibrate_batchnorm(self.teacher, steps.model_inputs(self.pool[0], self.tcfg, dev, training=False))
            self.teacher.register_forward_hook(self._hook("teacher_map"))
        self.model.register_forward_hook(self._hook("student_map"))
        self.maps: Dict[str, torch.Tensor] = {}
        self.opt = make_optimizer(self.model, cf.train)
        self.state = TrainState()
        clock.lap("model", dev)
        self.losses, snaps = self._first_steps()
        self.p0, self.s0, self.g1, self.p3, self.s3 = (_to_host(x) for x in snaps)
        for i in range(t["warmup_steps"]):
            self.step(self.pool[i % len(self.pool)])
        clock.lap("warm-up", dev)

    def _first_steps(self):
        """The step's first calls, on the first batches of the pool, as the
        window makes them: dispatched back to back, with the metrics read
        back once after the last. The snapshots are device copies, taken in
        stream order: parameters and statistics before, Adam's first moment
        after step 1, parameters and statistics after the last."""
        from unidistill_torch.training import steps

        dev_copy = lambda d: {k: v.clone() for k, v in d.items()}
        p0, s0 = dev_copy(_params(self.model)), dev_copy(_stats(self.model))
        ms = []
        for i in range(FIRST_STEPS):
            self.capture = i == 0
            ms.append(self.step(self.pool[i]))
            self.capture = False
            if i == 0:
                g1 = _first_moment(self.model, self.opt.adamw)
        p3, s3 = dev_copy(_params(self.model)), dev_copy(_stats(self.model))
        return [steps.metrics_to_host(m) for m in ms], (p0, s0, g1, p3, s3)

    def _hook(self, name: str):
        """A forward hook that keeps the BEV map of the first step."""
        def hook(_mod, _args, out):
            if self.capture:
                self.maps[name] = out["model_output"]
        return hook

    def step(self, batch) -> Dict[str, torch.Tensor]:
        from unidistill_torch.training import steps

        cf = self.cf
        if self.distill:
            return steps.distill_train_step(self.state, batch, self.model, self.teacher, self.opt,
                                            self.cfg, self.tcfg, cf.distill)
        return steps.train_step(self.state, batch, self.model, self.opt, self.cfg)

    def spans(self, timer) -> None:
        from unidistill_torch.training import steps

        m = self.model
        timer.module("camera_encoder", m.camera_encoder)
        timer.module("bev_head", m.bev_encoder)
        timer.module("bev_head", m.det_head)
        if self.teacher is not None:
            timer.module("teacher", self.teacher)
        timer.function("losses", steps, "assign_targets")
        timer.function("losses", steps, "center_head_loss")
        for name in ("feature_distill_loss", "bev_distill_loss", "response_distill_loss"):
            timer.function("losses", steps, name)
        timer.function("backward", torch.Tensor, "backward")
        timer.function("optimizer", self.opt, "step")

    def window(self, seconds: float, tracer=None) -> Dict:
        from unidistill_torch.training import steps

        t = self.ctx.traffic
        every = int(t["readback_every"])
        order = su.order(self.ctx.seed, len(self.pool), 1 << 16)
        bad = torch.zeros((), dtype=torch.int64, device=self.ctx.device)
        n = 0
        su.sync(self.ctx.device)
        t0 = time.perf_counter()
        marks = [t0]  # after each read-back, where the device has caught up
        while time.perf_counter() - t0 < seconds:
            if tracer is not None:
                tracer.before(n)
            with (tracer.annotate("bench.step") if tracer is not None else contextlib.nullcontext()):
                m = self.step(self.pool[order[n]])
                bad += (~torch.isfinite(m["loss"])).to(torch.int64)
                n += 1
                if n % every == 0:
                    steps.metrics_to_host(m)
                    marks.append(time.perf_counter())
            if tracer is not None:
                tracer.after(n - 1)
        steps.metrics_to_host(m)
        failed = int(bad)
        t_end = time.perf_counter()
        print("ms a step between read-backs: " + " ".join(f"{1e3 * (b - a) / every:.1f}" for a, b in zip(marks, marks[1:]))
              + f"; {n} steps", file=sys.stderr)
        if tracer is not None:
            tracer.close()
        self.slice_order = [order[i] for i in (tracer.indices["profiled"] if tracer is not None else [])]
        return {"attempted": n, "failed": failed,
                "end_to_end": {"train_frames_per_s": self.B * n / (t_end - t0)},
                "frames_per_iteration": self.B}

    def release(self) -> None:
        del self.model, self.opt, self.state
        if self.teacher is not None:
            del self.teacher
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------

    def _reference(self, precision: str, counting: bool = False):
        """The reference's three steps from the same weights and batches:
        (losses, first gradient, params before and after, statistics before
        and after, teacher map of step 1, work counts)."""
        from benchmark.reference import steps as rsteps
        from benchmark.reference.model import BEVFusionCenterHead
        from benchmark.reference.optim import TrainState, make_optimizer

        dev, seed = self.ctx.device, self.ctx.seed
        model = BEVFusionCenterHead(self.rcfg, precision=precision).to(dev)
        model.load_state_dict(su.weights(self.rcfg, seed, su.STREAM_WEIGHTS, dev))
        teacher = None
        out = {"teacher_map": None, "student_map": None, "flops": [], "convs": []}

        def keep(name):  # the BEV map of the first step
            return lambda _m, _a, o: out.__setitem__(name, o["model_output"]) if out[name] is None else None
        hooks = [model.register_forward_hook(keep("student_map"))]
        if self.distill:
            teacher = BEVFusionCenterHead(self.rtcfg, precision=precision).to(dev)
            teacher.load_state_dict(su.weights(self.rtcfg, seed, su.STREAM_TEACHER, dev))
            teacher.requires_grad_(False)
            synthetic.calibrate_batchnorm(teacher, rsteps.model_inputs(self.pool[0], self.rtcfg, dev, training=False))
            hooks.append(teacher.register_forward_hook(keep("teacher_map")))
        opt = make_optimizer(model, self.rcf.train)
        state = TrainState()
        p0, s0 = _to_host(_params(model)), _to_host(_stats(model))
        losses = []
        for i in range(FIRST_STEPS):
            def run():
                if self.distill:
                    return rsteps.distill_train_step(state, self.pool[i], model, teacher, opt, self.rcfg,
                                                     self.rtcfg, self.rcf.distill)
                return rsteps.train_step(state, self.pool[i], model, opt, self.rcfg)
            if counting:
                fl = matmul_flops(lambda: losses.append(rsteps.metrics_to_host(run())))
                out["flops"].append(fl["total"])
                out["convs"].append(fl["convs"])
            else:
                losses.append(rsteps.metrics_to_host(run()))
            if i == 0:
                g1 = _to_host(_first_moment(model, opt.adamw))
        for h in hooks:
            h.remove()
        out.update(losses=losses, g1=g1, p0=p0, p3=_to_host(_params(model)), s0=s0, s3=_to_host(_stats(model)))
        return out

    def _loss_keys(self) -> List[str]:
        keys = ["loss"]
        if self.distill:
            keys += ["loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg"]
        return keys

    def numbers(self, prog: Dict, counting: bool = False) -> Dict[str, float]:
        """Every number compared, the program's side `prog` (the keys of
        `_reference`'s result) against the float32 reference; with
        `counting`, the reference's work is counted on the way (`work`).
        The worst leaves are printed on stderr."""
        ref = self._reference("float32", counting)
        self.counted = ref
        out = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"], self._loss_keys())[0]}
        g_ref = compare.norms(ref["g1"])
        median = sorted(g_ref.values())[len(g_ref) // 2]
        moving = [k for k, v in g_ref.items() if v >= 1e-3 * median]
        grads = compare.leaf_norm_gaps(compare.norms(prog["g1"]), g_ref, moving)
        out["grad_gap"] = grads[-1][0]
        out["grad_median_gap"] = grads[len(grads) // 2][0]
        change = lambda side, a, b: compare.norms({k: side[b][k] - side[a][k] for k in side[a]})
        changes = compare.leaf_norm_gaps(change(prog, "p0", "p3"), change(ref, "p0", "p3"), moving)
        out["change_gap"] = changes[-1][0]
        out["change_median_gap"] = changes[len(changes) // 2][0]
        out["bn_gap"] = compare.leaf_norm_gap(change(prog, "s0", "s3"), change(ref, "s0", "s3"))[0]
        out["student_gap"] = compare.rel_l2(prog["student_map"], ref["student_map"])
        if self.distill:
            out["teacher_gap"] = compare.rel_l2(prog["teacher_map"], ref["teacher_map"])
        print(f"worst leaves: gradient {grads[-1][1]}, change {changes[-1][1]} "
              f"({len(moving)} of {len(g_ref)} leaves move)", file=sys.stderr)
        return out

    def numbers_of_program(self, counting: bool = False) -> Dict[str, float]:
        prog = dict(losses=self.losses, g1=self.g1, p0=self.p0, p3=self.p3, s0=self.s0, s3=self.s3,
                    student_map=self.maps["student_map"], teacher_map=self.maps.get("teacher_map"))
        return self.numbers(prog, counting)

    def check(self, counting: bool = False) -> List[Reading]:
        return readings(self.numbers_of_program(counting), self.ctx.traffic["limits"])

    def control(self) -> Dict[str, float]:
        """The numbers of the reference in fp8 put in the program's place."""
        return self.numbers(self._reference("fp8"))

    def work(self) -> Dict:
        """The counts the per-layer metrics divide by, from the reference on
        the pool's batches (counted by `check(counting=True)`)."""
        ref = self.counted
        bev = bound_s(*bev_pool_work(self.rcfg.camera_encoder, self.B, False), PEAKS["f32_flops"]) + \
            bound_s(*bev_pool_work(self.rcfg.camera_encoder, self.B, True), PEAKS["f32_flops"])
        sparse = [bound_s(*sparse_conv_work(c), PEAKS["bf16_flops"]) for c in ref["convs"]]
        if any(i >= len(sparse) for i in self.slice_order):
            raise ValueError(f"the work is counted on the first {len(sparse)} batches: the pool must hold no more")
        return {
            "flops_per_frame": sum(ref["flops"]) / len(ref["flops"]) / self.B,
            "bev_pool_bound_s": bev,
            # the traced steps' batches, each with its teacher's convolutions
            "sparse_conv_bound_s": sum(sparse[i] for i in self.slice_order),
        }

