"""ray_tpu_torch.serve: model serving with replica autoscaling.

The port's copy of ``ray_tpu.serve`` (reference parity:
python/ray/serve — controller-reconciled deployments
(serve/_private/controller.py:84), power-of-two routing
(pow_2_scheduler.py:52), HTTP ingress proxy (proxy.py:534), batching,
model multiplexing, request-driven autoscaling) on the port's actor
runtime. A deployment that holds a GPU reserves it with
``ray_actor_options={"num_gpus": n}``; its replica actor is pinned to
the card with ``CUDA_VISIBLE_DEVICES``. The HTTP proxy speaks HTTP/1.1
on the standard library's asyncio streams.
"""

from .._private.usage import record_library_usage as _rlu
_rlu("serve")
del _rlu


from .api import (Application, Deployment, delete, deploy_config,
                  deployment, start_grpc,
                  get_app_handle, get_deployment_handle, run, shutdown,
                  start, status)
from .batching import batch
from .config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from .schema import (DeploymentSchema, ServeApplicationSchema,
                     ServeDeploySchema)
from .handle import (DeploymentHandle, DeploymentResponse,
                     DeploymentResponseGenerator)
from .multiplex import get_multiplexed_model_id, multiplexed
from ._private.proxy import Request, Response, StreamingHint
from .asgi import ingress

__all__ = [
    "deployment", "Deployment", "Application", "run", "start",
    "start_grpc", "shutdown",
    "delete", "deploy_config", "status", "get_app_handle",
    "get_deployment_handle",
    "ServeDeploySchema", "ServeApplicationSchema", "DeploymentSchema",
    "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "StreamingHint",
    "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions", "batch", "multiplexed",
    "get_multiplexed_model_id", "Request", "Response", "ingress",
]


def __getattr__(name):
    # serve.llm namespace, loaded lazily: the fleet plane pulls in the
    # engine's modules, which non-LLM serve processes (controller,
    # proxy) need not load
    if name == "llm":
        import importlib
        return importlib.import_module(".llm", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
