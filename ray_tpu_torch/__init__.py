"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's LLM serving and
single-device training paths.

Mirrors ``ray_tpu``'s layout (``models``, ``ops``, ``llm``). Device code
is PyTorch; the Pallas kernels of those paths are hand-written CUDA
kernels for Hopper (``ops/csrc``). Training is
``models.training.TrainStepBundle``; the serving replica is
``llm.LLMServerImpl``. Imports torch and numpy, never jax
and nothing of ``ray_tpu``.
"""

from .llm import (ByteTokenizer, EngineConfig, InferenceEngine, LLMConfig,
                  LLMServerImpl, Request, SamplingParams, load_tokenizer)

__all__ = ["ByteTokenizer", "EngineConfig", "InferenceEngine", "LLMConfig",
           "LLMServerImpl", "Request", "SamplingParams", "load_tokenizer"]
