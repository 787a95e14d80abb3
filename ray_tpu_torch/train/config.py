"""Train configs.

The port's copy of ``ray_tpu/train/config.py`` (reference parity:
python/ray/air/config.py: ScalingConfig :103, FailureConfig :398,
CheckpointConfig :448, RunConfig :597), with the GPU in the role of the
TPU: ``use_gpu``/``gpus_per_worker`` reserve cards for each worker, and
``accelerator_type`` reserves the ``GPU-<type>`` resource that
``accelerators/gpu.py`` advertises (e.g. "NVIDIA-H100-80GB-HBM3").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

USE_TPU_REFUSED = ("ray_tpu_torch.train reserves GPUs: use "
                   "ScalingConfig(use_gpu=True, gpus_per_worker=N), not "
                   "use_tpu/tpus_per_worker")


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 1
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    accelerator_type: Optional[str] = None   # e.g. "NVIDIA-H100-80GB-HBM3"
    # Elastic training (reference parity: Train v2 ScalingPolicy): when
    # set, each (re)start runs with as many workers as the cluster can
    # place in [min_workers, num_workers] instead of blocking on the full
    # gang — shrink on failures/lost nodes, grow back on later restarts.
    # The train loop must derive its data sharding from ctx.world_size.
    min_workers: Optional[int] = None
    # the JAX package's TPU fields, refused with a message naming use_gpu
    use_tpu: bool = False
    tpus_per_worker: Optional[int] = None

    def __post_init__(self):
        if self.use_tpu or self.tpus_per_worker is not None:
            raise ValueError(USE_TPU_REFUSED)

    def worker_bundle(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        bundle: Dict[str, float] = {"CPU": self.cpus_per_worker}
        if self.use_gpu:
            bundle["GPU"] = float(self.gpus_per_worker)
            if self.accelerator_type:
                bundle[f"GPU-{self.accelerator_type}"] = \
                    float(self.gpus_per_worker)
        return bundle


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0              # group restarts allowed; -1 = infinite


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        """storage_path may be a cloud URI (gs://bucket/dir, mock://...)
        — everything downstream rides train.storage (reference parity:
        train/_internal/storage.py StorageContext)."""
        from .storage import join
        base = self.storage_path or os.path.expanduser("~/ray_tpu_results")
        return join(base, self.name or "train_run")
