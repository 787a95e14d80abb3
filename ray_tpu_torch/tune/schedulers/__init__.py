from .trial_scheduler import (TrialScheduler, FIFOScheduler,
                              MedianStoppingRule, CONTINUE, PAUSE, STOP)
from .asha import AsyncHyperBandScheduler, ASHAScheduler
from .hyperband import HyperBandScheduler
from .pbt import PopulationBasedTraining
from .pb2 import PB2

__all__ = [
    "TrialScheduler", "FIFOScheduler", "MedianStoppingRule",
    "AsyncHyperBandScheduler", "ASHAScheduler", "HyperBandScheduler",
    "PopulationBasedTraining", "PB2", "CONTINUE", "PAUSE", "STOP",
]
