"""Microbenchmark: the chunked subm conv with its offsets' select and
products fused into one kernel (K7), against the separate path; and the
smoke kernel (K8).

Counterpart of the JAX experiment `experiments/mb_pallas_fused.py`. The
separate ("prod") path is the chunked layout's `_subm_impl`: per sample a
row gather of the window table, a 3-way case select written back to
memory, and one batched product per offset. The fused path keeps the row
gather and does the select and all 8 offsets' products in K7, the select in
registers and shared memory, accumulating in f32.

    python -m unidistill_torch.experiments.mb_pallas_fused [smoke]
    python -m unidistill_torch.experiments.mb_pallas_fused one <s0|s2|s3> <prod|fused>
        [--device cpu] [--config lidar|tiny]

`one` plans B = 4 realistic frames (`experiments/realistic.py`) under the
LiDAR model config and prints `<stage>: S=.. C=.. (tables ..s)` and
`RESULT <stage> <variant>: <ms> ms/conv (maxerr .., total ..s)`, the time by
CUDA events over ITERS applications, maxerr the fused path's max |diff|
against prod on the same inputs. `--config tiny` uses the tiny test model's
grid and caps instead, for a run on the CPU (see its help).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from unidistill_torch.configs.nuscenes import lidar_exp, tiny_model
from unidistill_torch.experiments.harness import device_name, pick_device, timed_ms
from unidistill_torch.experiments.realistic import realistic_inputs
from unidistill_torch.ops.fused_offsets import fused_subm, smoke
from unidistill_torch.ops.sparse_conv_chunked import _subm_impl


def conv_variants(x):
    """name -> fn() over one stage's inputs: "prod" (`_subm_impl`, the
    separate path) and "fused" (`fused_subm`, K7)."""
    return {
        "prod": lambda: _subm_impl(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight,
                                   None, x.tables, "bfloat16"),
        "fused": lambda: fused_subm(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight,
                                    x.tables, x.C, x.C),
    }


def run_one(stage: str, variant: str, device: torch.device, cfg, x=None):
    """One (stage, variant) measurement, on `x` (that stage's `StageInputs`)
    or on inputs planned here; prints its RESULT line and returns (ms per
    conv, the fused path's max |diff| against prod (0 for prod), max |prod|
    (0 for prod))."""
    t0 = time.time()
    if x is None:
        x = realistic_inputs(cfg, (stage,), device=device)[0][stage]
    print(f"{stage}: S={x.S} C={x.C} on {device_name(device)} "
          f"(tables {time.time() - t0:.0f}s)", flush=True)
    ops = conv_variants(x)
    t0 = time.time()
    ms = timed_ms(ops[variant], device)
    derr = scale = 0.0
    if variant == "fused":
        ref = ops["prod"]().float()
        derr = (ops["fused"]().float() - ref).abs().max().item()
        scale = ref.abs().max().item()
    print(f"RESULT {stage} {variant}: {ms:7.2f} ms/conv "
          f"(maxerr {derr:.2e}, total {time.time() - t0:.0f}s)", flush=True)
    return ms, derr, scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*", help="smoke | one <stage> <prod|fused>")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--config", default="lidar", choices=("lidar", "tiny"),
                    help="lidar: the published stage sizes (default); tiny: the tiny test "
                         "model's grid, small enough for the CPU (the published s2 "
                         "windows are 2 GB in bf16, 4 GB in the plain f32 select)")
    a = ap.parse_args(argv)
    args = a.args or ["smoke"]
    dev = pick_device(a.device)
    if args[0] == "one":
        if len(args) != 3 or args[1] not in ("s0", "s2", "s3") or args[2] not in ("prod", "fused"):
            ap.error("one <s0|s2|s3> <prod|fused>")
        cfg = lidar_exp().model if a.config == "lidar" else tiny_model(with_camera=False)
        run_one(args[1], args[2], dev, cfg)
        return 0
    if "smoke" in args:
        print("smoke:", smoke(dev), "(want 5.0)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
