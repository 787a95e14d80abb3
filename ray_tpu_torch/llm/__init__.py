"""LLM serving: the continuous-batching engine over a paged KV cache."""

from ._internal.engine import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)
from ._internal.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "EngineConfig", "InferenceEngine", "Request",
           "SamplingParams"]
