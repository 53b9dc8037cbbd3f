"""LLM serving plane of the port: paged KV cache, continuous batching and the
deployment class."""

from ray_tpu_torch.serve.llm.deployment import TINY_MODEL, LLMServer, llm_deployment
from ray_tpu_torch.serve.llm.engine import EngineConfig, InferenceEngine, TokenStream
from ray_tpu_torch.serve.llm.kv_cache import (
    NULL_BLOCK,
    BlockAllocator,
    BlockTable,
    KVCacheExhausted,
)

__all__ = [
    "BlockAllocator",
    "BlockTable",
    "EngineConfig",
    "InferenceEngine",
    "KVCacheExhausted",
    "LLMServer",
    "NULL_BLOCK",
    "TINY_MODEL",
    "TokenStream",
    "llm_deployment",
]
