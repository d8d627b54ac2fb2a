"""LiDAR+camera fusion BEVFusion CenterHead experiment.

ref …BEVFusion_nuscenes_centerhead_fusion_exp.py:177-215.
"""

if __name__ == "__main__":
    # run as `python unidistill_torch/exps/nuscenes/<exp>.py` from a checkout:
    # the interpreter puts the script's dir on sys.path, not the repo root
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
    from unidistill_torch.configs.nuscenes import fusion_exp
    from unidistill_torch.exps.base_cli import run_cli

    run_cli(fusion_exp())
