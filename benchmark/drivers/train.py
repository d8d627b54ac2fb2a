"""Entry driver `train`: the port's `training/steps.train_step` of one
detector, in a closed loop over a pool of batches held on the device
(`harness/training.py` sets out the loop and the comparison)."""
from benchmark.harness.training import TrainSession


def setup(ctx) -> TrainSession:
    return TrainSession(ctx, distill=False)
