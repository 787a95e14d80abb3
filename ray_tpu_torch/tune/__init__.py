"""ray_tpu_torch.tune: the class-API Trainable the port's RLlib
algorithms build on (the tuner, schedulers and searchers are not
ported)."""

from .trainable import DONE, TRAINING_ITERATION, Trainable

__all__ = ["DONE", "TRAINING_ITERATION", "Trainable"]
