"""LLM serving: the continuous-batching engine over a paged KV cache, its
OpenAI-compatible replica (``LLMServerImpl``) and the serve
applications that put it behind HTTP: ``build_llm_deployment`` (one
replica deployment a model) and ``build_openai_app`` (those behind the
OpenAI-route ``LLMRouterImpl``), deployed with ``serve.run``.

A replica whose engine runs on CUDA (the default) reserves its cards:
``accelerator_type`` sets ``ray_actor_options["num_gpus"]`` to the
engine's tp x pp, or ``ray_actor_options`` names ``num_gpus`` itself.
A CUDA engine with no GPU reserved is refused when the app is built.
"""

import dataclasses
from typing import Any, Dict, Optional

from ._internal.engine import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)
from ._internal.server import LLMServerImpl
from ._internal.tokenizer import ByteTokenizer, load_tokenizer


@dataclasses.dataclass
class LLMConfig:
    """The JAX package's LLMConfig: what LLMServerImpl takes, as a
    dict (``to_dict``). engine_kwargs are EngineConfig fields; the
    engine runs on CUDA unless they say device="cpu"."""
    model_id: str = "default"
    model_source: Any = "debug"          # preset name or LlamaConfig
    tokenizer_source: Optional[str] = None
    engine_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployment_config: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    accelerator_type: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model_id": self.model_id,
            "model_source": self.model_source,
            "tokenizer_source": self.tokenizer_source,
            "engine_kwargs": dict(self.engine_kwargs),
        }


def _engine_cards(engine_kwargs: Dict[str, Any]) -> int:
    """Cards a replica's engine spans: tp x pp of its mesh (the JAX
    package sizes its chip reservation the same way; reference: vLLM
    worker placement, vllm_models.py:123-139)."""
    mesh = engine_kwargs.get("mesh")
    mesh_shape = engine_kwargs.get("mesh_shape")
    if mesh_shape is not None:
        return max(1, int(mesh_shape[0]) * int(mesh_shape[1]))
    if mesh is None:
        return 1
    sizes = (mesh if isinstance(mesh, dict)
             else {"tp": getattr(mesh, "tp", 1),
                   "pp": getattr(mesh, "pp", 1)})
    tp = sizes.get("tp", 1)
    pp = sizes.get("pp", 1)
    if tp == -1 or pp == -1:
        # -1 resolves against VISIBLE devices inside the replica; here
        # the reservation itself is sized, so a wildcard would silently
        # under-provision to one card
        raise ValueError(
            "give explicit tp/pp sizes in engine_kwargs.mesh when "
            "accelerator_type is set (wildcard -1 cannot size the "
            "replica's GPU reservation)")
    return max(1, tp * pp)


def _on_cuda(engine_kwargs: Dict[str, Any]) -> bool:
    device = engine_kwargs.get("device")
    return device is None or str(device).startswith("cuda")


def build_llm_deployment(llm_config: LLMConfig):
    """One LLMServer deployment for one model."""
    from .. import serve

    dep_cfg = dict(llm_config.deployment_config)
    dep_cfg.setdefault("name", f"LLMServer:{llm_config.model_id}")
    dep_cfg.setdefault("max_ongoing_requests", 64)
    ekw = llm_config.engine_kwargs or {}
    opts = dict(dep_cfg.get("ray_actor_options") or {})
    if llm_config.accelerator_type:
        opts.setdefault("num_gpus", _engine_cards(ekw))
        dep_cfg["ray_actor_options"] = opts
    if _on_cuda(ekw) and not opts.get("num_gpus"):
        # the replica would build a CUDA context on a pooled worker no
        # card is pinned to
        raise ValueError(
            f"the engine of {llm_config.model_id!r} runs on CUDA but its "
            f"replica reserves no GPU: set accelerator_type (e.g. "
            f"'GPU-H100'), deployment_config={{'ray_actor_options': "
            f"{{'num_gpus': n}}}}, or engine_kwargs={{'device': 'cpu'}}")
    return serve.deployment(**dep_cfg)(LLMServerImpl).bind(
        llm_config.to_dict())


def build_openai_app(config: Dict[str, Any]):
    """{"llm_configs": [LLMConfig, ...]} → Application serving the
    OpenAI API (reference: serve/llm build_openai_app)."""
    from .. import serve
    from ._internal.server import LLMRouterImpl

    llm_configs = config["llm_configs"]
    servers = [build_llm_deployment(c) for c in llm_configs]
    return serve.deployment(name="LLMRouter", max_ongoing_requests=256)(
        LLMRouterImpl).bind(*servers)


__all__ = ["ByteTokenizer", "EngineConfig", "InferenceEngine", "LLMConfig",
           "LLMServerImpl", "Request", "SamplingParams",
           "build_llm_deployment", "build_openai_app", "load_tokenizer"]
