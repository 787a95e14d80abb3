"""ray_tpu_torch.train: data-parallel training over the port's runtime
(``ray_tpu.train``'s API, with ``TorchTrainer`` for ``JaxTrainer``)."""

from .._private.usage import record_library_usage as _rlu
_rlu("train")
del _rlu

from .checkpoint import Checkpoint, CheckpointManager
from .config import (CheckpointConfig, FailureConfig, RunConfig,
                     ScalingConfig)
from .session import (get_checkpoint, get_context, get_local_rank,
                      get_world_rank, get_world_size, report)
from .trainer import DataParallelTrainer, Result, TorchTrainer, TrainWorker
