"""GPU accelerator manager: detection, isolation, the GPU resources.

The counterpart of ``ray_tpu/accelerators/tpu.py`` (reference parity:
python/ray/_private/accelerators/nvidia_gpu.py, NvidiaGPUAcceleratorManager):
resource name "GPU", CUDA_VISIBLE_DEVICES isolation, and the
"GPU-{type}" resource beside it, as the reference advertises
"TPU-{version}".

Detection is environment-driven and never calls ``torch.cuda``:
``cudaGetDeviceCount`` initializes the driver API, and a process that
forks after that (the worker zygote) hands its children a CUDA state
they cannot use. The count comes from, in order:

1. ``RAY_TPU_NUM_GPUS`` (the counterpart of ``RAY_TPU_NUM_CHIPS``);
2. ``CUDA_VISIBLE_DEVICES``;
3. ``NVIDIA_VISIBLE_DEVICES`` when the container runtime set it to a
   list: a container may expose more ``/dev/nvidia*`` nodes than the
   devices it may use;
4. the ``/dev/nvidia[0-9]*`` device nodes.

The type is the first name ``nvidia-smi --query-gpu=name`` prints.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

GPU_RESOURCE_NAME = "GPU"
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
NUM_GPUS_ENV = "RAY_TPU_NUM_GPUS"
# the node's own CUDA_VISIBLE_DEVICES, captured before any task's pin
# overwrites it; pins are positions in this list
_NODE_VISIBLE = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)


def cuda_initialized() -> bool:
    """Whether this process has initialized CUDA. Never initializes it."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _split(value: Optional[str]) -> Optional[List[str]]:
    if value is None:
        return None
    value = value.strip()
    if value.lower() in ("", "none", "void"):
        return []
    return [v.strip() for v in value.split(",") if v.strip()]


class GPUAcceleratorManager:
    """The static methods of the reference's AcceleratorManager
    (python/ray/_private/accelerators/accelerator.py:5) that the runtime
    calls."""

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        override = os.environ.get(NUM_GPUS_ENV)
        if override:
            return int(override)
        visible = _split(os.environ.get(CUDA_VISIBLE_DEVICES_ENV))
        if visible is not None:
            return len(visible)
        nvidia = os.environ.get("NVIDIA_VISIBLE_DEVICES")
        if nvidia is not None and nvidia.strip().lower() != "all":
            return len(_split(nvidia))
        return len([d for d in glob.glob("/dev/nvidia*")
                    if re.fullmatch(r"/dev/nvidia[0-9]+", d)])

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """The first GPU's name with spaces as dashes (e.g.
        "NVIDIA-H100-80GB-HBM3"), or None without ``nvidia-smi``."""
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=10)
        except (OSError, subprocess.SubprocessError):
            return None
        names = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
        if out.returncode != 0 or not names:
            return None
        return names[0].replace(" ", "-")

    @staticmethod
    def visible_value(gpu_ids: Sequence[int]) -> str:
        """The CUDA_VISIBLE_DEVICES value that pins the given positions
        of the node's devices."""
        node = _split(_NODE_VISIBLE)
        if node:
            return ",".join(node[int(i)] for i in gpu_ids)
        return ",".join(str(int(i)) for i in gpu_ids)

    @staticmethod
    def set_current_process_visible_accelerators(gpu_ids: Sequence[int]
                                                 ) -> None:
        """Restrict this process (and CUDA in it, if it has not
        initialized yet) to the given GPUs."""
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = (
            GPUAcceleratorManager.visible_value(gpu_ids))

    @staticmethod
    def autodetect_resources() -> Dict[str, float]:
        """Resources this node should advertise."""
        out: Dict[str, float] = {}
        n = GPUAcceleratorManager.get_current_node_num_accelerators()
        if n > 0:
            out[GPU_RESOURCE_NAME] = float(n)
            accel = GPUAcceleratorManager.get_current_node_accelerator_type()
            if accel:
                out[f"GPU-{accel}"] = float(n)
        return out
