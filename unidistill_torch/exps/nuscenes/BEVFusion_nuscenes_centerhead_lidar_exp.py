"""LiDAR-only BEVFusion CenterHead experiment.

ref exps/multisensor_fusion/nuscenes/BEVFusion/BEVFusion_nuscenes_centerhead_lidar_exp.py:7-35
(fusion exp minus camera encoder; lr 1e-3, batch 4/device, 20 epochs).
"""

if __name__ == "__main__":
    # run as `python unidistill_torch/exps/nuscenes/<exp>.py` from a checkout:
    # the interpreter puts the script's dir on sys.path, not the repo root
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.exps.base_cli import run_cli

    run_cli(lidar_exp())
