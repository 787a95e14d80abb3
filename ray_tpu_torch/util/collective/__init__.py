"""Host-side collectives over the port's runtime (``ray_tpu.util.collective``'s
object-store path). The in-program collective plane (``xla.py`` in the
JAX package) goes to NCCL and waits for several cards."""

from .collective import (init_collective_group, destroy_collective_group,
                         allreduce, allgather, reducescatter, broadcast,
                         barrier, send, recv, ReduceOp,
                         create_collective_group)
