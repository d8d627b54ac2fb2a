"""camera→lidar distillation experiment.

ref …BEVFusion_nuscenes_centerhead_lidar_exp_distill_camera.py (loss weights per
SURVEY.md §2.3 matrix; teacher frozen, student lr 2e-4).
"""

if __name__ == "__main__":
    # run as `python unidistill_torch/exps/nuscenes/<exp>.py` from a checkout:
    # the interpreter puts the script's dir on sys.path, not the repo root
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
    from unidistill_torch.exps.distill_cli import run_distill_cli

    run_distill_cli(teacher="camera", student="lidar")
