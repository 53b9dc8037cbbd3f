"""LLM serving plane of the port: paged KV cache + continuous batching."""

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
    "NULL_BLOCK",
    "TokenStream",
]
