"""LLM serving: the continuous-batching engine over a paged KV cache,
and its OpenAI-compatible replica (``LLMServerImpl``, driven directly:
the JAX package's serve deployments and router are not ported)."""

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


__all__ = ["ByteTokenizer", "EngineConfig", "InferenceEngine", "LLMConfig",
           "LLMServerImpl", "Request", "SamplingParams", "load_tokenizer"]
