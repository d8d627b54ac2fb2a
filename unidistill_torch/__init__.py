"""PyTorch + CUDA port of the UniDistill BEV detectors for NVIDIA Hopper.

The package mirrors the JAX package's layout (configs/ ops/ layers/ models/
decode/ training/ serving/). Hand-written CUDA kernels live in `csrc/` and are
built on first use by `kernels/build.py`. This slice covers the camera
detector's serving path: `serving.predictor.Detector(cfg, state_dict).predict`.
"""
