"""The camera<-LiDAR launcher's step time on warm loader workers.

    python tools/launcher_step.py     # on the card

Writes `chip_smoke.py`'s launcher inputs (`chip_smoke.cli_data`: a
full-width synthetic nuScenes, here STEPS steps of batch 4 an epoch, and a
seeded, calibrated LiDAR teacher) to a temporary directory. Prints the host
seconds of a few full-width training frames on one intra-op thread, as a
loader worker builds them. Then, from inside that directory, runs the
launcher (`run_distill_cli("lidar", "camera")`, CBGS off, no validation)
for two epochs, once with 4 loader workers and once with the CLI's default
10, every step logged (`loop.PRINT_INTERVAL` 1: one metrics read-back a
step). For each run it prints each step's `sec_per_step` and
`loader_wait_sec_per_step` from `metrics.jsonl`: the first epoch pays the
spawned workers' start, the second runs on the same, persistent workers.
Ends with the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from unidistill_torch.configs.nuscenes import DataConfig, fusion_exp  # noqa: E402
from unidistill_torch.data.dataset import NuScenesDataset  # noqa: E402
from unidistill_torch.exps.distill_cli import run_distill_cli  # noqa: E402
from unidistill_torch.kernels import build  # noqa: E402
from unidistill_torch.training import loop  # noqa: E402

STEPS = 12
FRAMES_TIMED = 4
WORKERS = (4, 10)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("launcher_step: CUDA is not available")
    build.build_all()
    loop.PRINT_INTERVAL = 1
    n_train = STEPS * chip_smoke.BATCH
    with tempfile.TemporaryDirectory(prefix="unidistill_launcher_") as tmp:
        tmp = Path(tmp)
        root, _, write_s, teacher_s = chip_smoke.cli_data(tmp, n_train, chip_smoke.CLI_VAL_FRAMES,
                                                          torch.device("cuda"))
        print(f"[data] train_frames={n_train} write_seconds={write_s:.2f} teacher_seconds={teacher_s:.2f}",
              flush=True)
        ds = NuScenesDataset(DataConfig(root_path=root, use_cbgs=False), fusion_exp().model, "training")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        secs = []
        for i in range(FRAMES_TIMED):
            t0 = time.perf_counter()
            ds[i]
            secs.append(round(time.perf_counter() - t0, 4))
        torch.set_num_threads(threads)
        print(f"[frame] host_seconds_one_thread={secs}", flush=True)
        for workers in WORKERS:
            argv = ["-b", str(chip_smoke.BATCH), "--max_epochs", "2", "--num_workers", str(workers),
                    "--data_root", root, "--teacher_ckpt", str(tmp / "teacher"),
                    "--exp_options", "data.use_cbgs=False", "train.eval_interval=3"]
            run_dir = tmp / f"workers{workers}"
            run_dir.mkdir()
            t0 = time.time()
            with contextlib.chdir(run_dir):
                trainer = run_distill_cli("lidar", "camera", argv)
            seconds = time.time() - t0
            with open(run_dir / trainer.output_dir / "metrics.jsonl") as f:
                steps = [r for r in map(json.loads, f) if "step" in r]
            for epoch in range(2):
                part = steps[epoch * STEPS:(epoch + 1) * STEPS]
                print(f"[launcher workers={workers} epoch={epoch}] "
                      f"s_per_step={[round(r['sec_per_step'], 4) for r in part]} "
                      f"loader_wait_s_per_step={[round(r['loader_wait_sec_per_step'], 4) for r in part]}",
                      flush=True)
            print(f"[launcher workers={workers}] run_seconds={seconds:.2f}", flush=True)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
