"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

Mirrors ``ray_tpu``'s layout (``models``, ``ops``, ``llm``, ``_private``,
...). Device code is PyTorch; the Pallas kernels of those paths are
hand-written CUDA kernels for Hopper (``ops/csrc``). Training is
``models.training.TrainStepBundle``; the serving replica is
``llm.LLMServerImpl``, which ``serve`` deploys behind HTTP
(``llm.build_openai_app``). The actor runtime is the reference's
(tasks/actors/objects over an asyncio control plane, placement groups)
with the GPU in the role of the TPU: ``init(num_gpus=...)`` and
``@remote(num_gpus=1)`` pin a task or an actor to a card with
``CUDA_VISIBLE_DEVICES``. Imports torch and numpy, never jax and
nothing of ``ray_tpu``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Union

from ._private import state as _state
from ._private.object_ref import ObjectRef
from ._private.streaming import ObjectRefGenerator
from ._private.worker import (init, shutdown, current_runtime,
                              add_fake_node, remove_node)
from .actor import ActorClass, ActorHandle
from .remote_function import RemoteFunction
from . import exceptions
from .llm import (ByteTokenizer, EngineConfig, InferenceEngine, LLMConfig,
                  LLMServerImpl, Request, SamplingParams, load_tokenizer)

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "get_actor", "aio_get_actor", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle", "exceptions",
    "get_runtime_context", "method",
    "ByteTokenizer", "EngineConfig", "InferenceEngine", "LLMConfig",
    "LLMServerImpl", "Request", "SamplingParams", "load_tokenizer",
]


def is_initialized() -> bool:
    return _state.is_initialized()


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction or a class into
    an ActorClass. Usable bare (@remote) or with options
    (@remote(num_cpus=2, num_gpus=1))."""
    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0])
                                          or inspect.isclass(args[0])):
        target = args[0]
        return ActorClass(target) if inspect.isclass(target) \
            else RemoteFunction(target)
    if args:
        raise TypeError("use @remote or @remote(**options)")

    def decorator(target):
        return ActorClass(target, kwargs) if inspect.isclass(target) \
            else RemoteFunction(target, kwargs)

    return decorator


def method(**kwargs):
    """Per-method options decorator (accepted for API parity)."""
    def decorator(fn):
        fn._method_options = kwargs
        return fn
    return decorator


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    return _state.current_client().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    return _state.current_client().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return _state.current_client().wait(refs, num_returns=num_returns,
                                        timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _state.current_client().kill_actor(actor._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    info = _state.current_client().get_actor_handle_info(name, namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} found")
    return ActorHandle(info["actor_id"], name)


async def aio_get_actor(name: str,
                        namespace: Optional[str] = None) -> ActorHandle:
    """Async variant of get_actor for use inside async actors."""
    info = await _state.current_client().aio_get_actor_handle_info(
        name, namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} found")
    return ActorHandle(info["actor_id"], name)


def nodes() -> List[dict]:
    return _state.current_client().nodes()


def cluster_resources() -> Dict[str, float]:
    return _state.current_client().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _state.current_client().available_resources()


class RuntimeContext:
    def __init__(self, client):
        self._client = client
        info = getattr(client, "runtime_context", None) or {}
        self.worker_id = info.get("worker_id")
        self.node_id = info.get("node_id")
        runtime = info.get("runtime")
        self.actor_id = getattr(runtime, "current_actor_id", None)

    def get_actor_id(self):
        return self.actor_id

    def get_node_id(self):
        return self.node_id

    def get_worker_id(self):
        return self.worker_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_state.current_client())
