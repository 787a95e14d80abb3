"""ray_tpu_torch.tune: hyperparameter search over trial actors.

The port's copy of ``ray_tpu.tune`` (reference parity: python/ray/tune —
Tuner.fit, tuner.py:312, driving Trainable actors through a
TuneController, execution/tune_controller.py:68, with pluggable
Searchers and TrialSchedulers: ASHA/HyperBand/PBT/median). A trial's
trainable can itself be a TorchTrainer whose workers hold GPUs.
"""

from .._private.usage import record_library_usage as _rlu
_rlu("tune")
del _rlu


from .search.sample import (uniform, quniform, loguniform, qloguniform,
                            randint, qrandint, lograndint, choice,
                            sample_from, grid_search)
from .search.searcher import (Searcher, BasicVariantGenerator, RandomSearch,
                              ConcurrencyLimiter)
from .search.tpe import TPESearch
from .search.bohb import BOHBSearch
from .search.adapters import HyperOptSearch, OptunaSearch
from .schedulers import (TrialScheduler, FIFOScheduler, MedianStoppingRule,
                         AsyncHyperBandScheduler, ASHAScheduler,
                         HyperBandScheduler, PopulationBasedTraining, PB2)
from .trainable import (DONE, TRAINING_ITERATION, Trainable, report,
                        get_checkpoint)
from .trial import Trial
from .tuner import ResultGrid, TuneConfig, TuneResult, Tuner, run

__all__ = [
    "uniform", "quniform", "loguniform", "qloguniform", "randint",
    "qrandint", "lograndint", "choice", "sample_from", "grid_search",
    "Searcher", "BasicVariantGenerator", "RandomSearch", "TPESearch",
    "BOHBSearch", "OptunaSearch", "HyperOptSearch",
    "ConcurrencyLimiter", "TrialScheduler", "FIFOScheduler",
    "MedianStoppingRule", "AsyncHyperBandScheduler", "ASHAScheduler",
    "HyperBandScheduler", "PopulationBasedTraining", "PB2", "Trainable", "report",
    "get_checkpoint", "Trial", "ResultGrid", "TuneConfig", "TuneResult",
    "Tuner", "run",
]
