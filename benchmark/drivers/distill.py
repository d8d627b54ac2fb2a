"""Entry driver `distill`: the port's `training/steps.distill_train_step`,
a frozen teacher and a training student, in a closed loop over a pool of
batches held on the device (`harness/training.py` sets out the loop and the
comparison)."""
from benchmark.harness.training import TrainSession


def setup(ctx) -> TrainSession:
    return TrainSession(ctx, distill=True)
