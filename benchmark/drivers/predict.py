"""Entry driver `predict`: the port's `serving/predictor.Detector.predict`,
served in a closed loop of one client.

The client sends a request of `batch` frames, waits until its ROIs are on
the host, and sends the next at once, as an offline pass over a dataset or a
single camera stream that takes each frame set when the last is done. A
request's latency runs from the `predict` call until its ROIs are on the
host. The batches come from a pool of `pool` batches made on the device from
the seed, taken in a seeded order.

`correct`: for `check_requests` requests drawn from the seed (a reservoir
sample over every request of the window), the program's
own camera BEV map (the camera encoder's output, through the BEV pool) and
head maps, captured from the timed call, against the plain float32
reference's from the same weights and images; and the ROIs the program
served against the reference's decode and NMS of the program's own head maps
(the reference follows the program's maps there, so the maps are checked by
themselves first).
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness import setup as su
from benchmark.harness.result import Reading, readings
from benchmark.harness.work import PEAKS, bev_pool_work, bound_s, matmul_flops
from benchmark.inputs import synthetic


def _host(rois: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.to("cpu") for k, v in rois.items()}


class Session:
    def __init__(self, ctx):
        from unidistill_torch.configs import nuscenes
        from unidistill_torch.serving.predictor import Detector
        from unidistill_torch.training import steps

        from benchmark.reference import config as rconfig

        self.ctx, t, dev, clock = ctx, ctx.traffic, ctx.device, ctx.clock
        self.cfg = su.configs(ctx.config, nuscenes).model
        self.rcfg = su.configs(ctx.config, rconfig).model
        self.B = t["batch"]
        clock.lap("import")
        sd = su.weights(self.rcfg, ctx.seed, su.STREAM_WEIGHTS, dev)
        clock.lap("weights", dev)
        g = synthetic.generator(ctx.seed, su.STREAM_POOL, dev)
        self.pool = [synthetic.camera_batch(self.cfg.camera_encoder, self.B, g, dev) for _ in range(t["pool"])]
        clock.lap("inputs", dev)
        self.det = Detector(self.cfg, sd, device=dev)
        del sd
        synthetic.calibrate_batchnorm(self.det.model, steps.model_inputs(self.pool[0], self.cfg, dev, training=False))
        clock.lap("model", dev)
        self.capture = False
        self._maps = None
        self.det.model.register_forward_hook(self._hook)
        for _ in range(t["warmup_rounds"]):
            for b in self.pool:
                self._request(b)
        clock.lap("warm-up", dev)

    def _hook(self, _mod, _args, out):
        if self.capture:
            self._maps = {"model_output": out["model_output"], "heads": out["multi_head_features"]}

    def _request(self, batch) -> Dict[str, torch.Tensor]:
        return _host(self.det.predict(batch))

    def spans(self, timer) -> None:
        from unidistill_torch.training import steps

        m = self.det.model
        timer.module("camera_encoder", m.camera_encoder)
        timer.module("bev_head", m.bev_encoder)
        timer.module("bev_head", m.det_head)
        timer.function("decode_nms", steps, "generate_proposals")

    def window(self, seconds: float, tracer=None) -> Dict:
        t, seed = self.ctx.traffic, self.ctx.seed
        order = su.order(seed, len(self.pool), 1 << 20)
        keep = su.Reservoir(seed, int(t["check_requests"]))
        lat, failed = [], 0
        self.kept, self.captured = {}, {}  # reservoir slot -> (pool index, ROIs), the program's maps
        su.sync(self.ctx.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            slot = keep.slot(n)
            if tracer is not None:
                tracer.before(n)
            with (tracer.annotate("bench.request") if tracer is not None else contextlib.nullcontext()):
                start = time.perf_counter()
                self.capture = slot is not None
                rois = self._request(self.pool[order[n]])
                self.capture = False
                end = time.perf_counter()
            if tracer is not None:
                tracer.after(n)
            lat.append(end - start)
            if not (torch.isfinite(rois["boxes"]).all() and torch.isfinite(rois["scores"]).all()):
                failed += 1
            if slot is not None:
                self.kept[slot] = (order[n], rois)
                self.captured[slot] = self._maps
            n += 1
        t_end = time.perf_counter()
        if tracer is not None:
            tracer.close()
        q = lambda p: float(np.percentile(np.asarray(lat) * 1e3, p))
        quarters = " ".join(f"{np.median(v) * 1e3:.3f}" for v in np.array_split(np.asarray(lat), 4) if len(v))
        print(f"serve latency ms p50 {q(50):.3f} p95 {q(95):.3f} max {q(100):.3f}; {n} requests; "
              f"p50 by quarter of the window {quarters}", file=sys.stderr)
        return {
            "attempted": n, "failed": failed,
            "end_to_end": {"serve_frames_per_s": self.B * n / (t_end - t0), "serve_p95_ms": q(95)},
            "frames_per_iteration": self.B,
        }

    def release(self) -> None:
        del self.det
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------

    def _reference(self, precision: str):
        from benchmark.reference import steps as rsteps
        from benchmark.reference.model import BEVFusionCenterHead

        dev = self.ctx.device
        model = BEVFusionCenterHead(self.rcfg, precision=precision).to(dev)
        model.load_state_dict(su.weights(self.rcfg, self.ctx.seed, su.STREAM_WEIGHTS, dev))
        synthetic.calibrate_batchnorm(model, rsteps.model_inputs(self.pool[0], self.rcfg, dev, training=False))
        return model

    @torch.no_grad()
    def _ref_maps(self, model, batch):
        from benchmark.reference import steps as rsteps

        out = model(**rsteps.model_inputs(batch, self.rcfg, self.ctx.device, training=False))
        return {"model_output": out["model_output"], "heads": out["multi_head_features"]}

    def _decode(self, heads):
        from benchmark.reference import steps as rsteps

        c = self.rcfg
        return rsteps.generate_proposals(heads, c.proposal, c.tasks, c.point_cloud_range[:2], c.voxel_size[:2],
                                         c.out_size_factor, training=False)

    def numbers(self, items: List) -> Dict[str, float]:
        """Every number compared; items: (pool index, program maps, program ROIs)."""
        tol = self.ctx.traffic["roi_tol"]
        with torch.no_grad():
            ref = self._reference("float32")
            bev_gap = head_gap = 0.0
            mismatch = 0
            for idx, maps, rois in items:
                r = self._ref_maps(ref, self.pool[idx])
                bev_gap = max(bev_gap, compare.rel_l2(maps["model_output"], r["model_output"]))
                for p_task, r_task in zip(maps["heads"], r["heads"]):
                    head_gap = max(head_gap, compare.worst_map_gap(p_task, r_task)[0])
                mismatch += compare.roi_mismatch(rois, _host(self._decode(maps["heads"])), tol)
        return {"bev_gap": bev_gap, "head_gap": head_gap, "roi_mismatch": float(mismatch)}

    def numbers_of_program(self) -> Dict[str, float]:
        items = [(self.kept[k][0], self.captured[k], self.kept[k][1]) for k in sorted(self.kept)]
        if not items:
            raise RuntimeError("no sampled request was served")
        return self.numbers(items)

    def check(self, counting: bool = False) -> List[Reading]:
        return readings(self.numbers_of_program(), self.ctx.traffic["limits"])

    def control(self) -> Dict[str, float]:
        """The numbers of the reference in fp8 put in the program's place,
        on the same sampled requests."""
        items = []
        with torch.no_grad():
            low = self._reference("fp8")
            for idx, _rois in (self.kept[k] for k in sorted(self.kept)):
                maps = self._ref_maps(low, self.pool[idx])
                items.append((idx, maps, _host(self._decode(maps["heads"]))))
            del low
        return self.numbers(items)

    def work(self) -> Dict:
        """The counts the per-layer metrics divide by, from the reference."""
        with torch.no_grad():
            ref = self._reference("float32")
            flops = matmul_flops(lambda: self._decode(self._ref_maps(ref, self.pool[0])["heads"]))
        return {
            "flops_per_frame": flops["total"] / self.B,
            "bev_pool_bound_s": bound_s(*bev_pool_work(self.rcfg.camera_encoder, self.B, False), PEAKS["f32_flops"]),
        }


def setup(ctx) -> Session:
    return Session(ctx)
