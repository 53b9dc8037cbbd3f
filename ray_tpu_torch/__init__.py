"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model and serving path.

A package of its own beside the JAX package ``ray_tpu``, which stays the
reference: the same parameter layouts, the same public names, the same
outputs on the same inputs and weights. It imports ``torch`` and nothing of
JAX or ``ray_tpu``. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU.

Two hand-written CUDA kernels carry the serving path: flash attention
(prefill and ``forward``) and paged attention (decode); see
``ray_tpu_torch.kernels``.
"""

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.kernels.flash_attention import flash_attention
from ray_tpu_torch.kernels.paged_attention import paged_attention
from ray_tpu_torch.models.generation import (
    init_paged_pool,
    make_paged_fns,
    sample_token,
    sequence_key,
)
from ray_tpu_torch.models.transformer import (
    GPTJ_6B,
    LLAMA2_7B,
    TINY,
    TransformerConfig,
    forward,
    init_params,
)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import (
    apply_rope,
    gelu,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from ray_tpu_torch.serve.exceptions import DeploymentOverloadedError
from ray_tpu_torch.serve.llm import (
    NULL_BLOCK,
    BlockAllocator,
    BlockTable,
    EngineConfig,
    InferenceEngine,
    KVCacheExhausted,
    TokenStream,
)
from ray_tpu_torch.weights import params_from_jax

__all__ = [
    "GPTJ_6B",
    "LLAMA2_7B",
    "NULL_BLOCK",
    "TINY",
    "BlockAllocator",
    "BlockTable",
    "DeploymentOverloadedError",
    "EngineConfig",
    "InferenceEngine",
    "KVCacheExhausted",
    "TokenStream",
    "TransformerConfig",
    "apply_rope",
    "attention",
    "flash_attention",
    "forward",
    "gelu",
    "init_paged_pool",
    "init_params",
    "layer_norm",
    "make_paged_fns",
    "paged_attention",
    "params_from_jax",
    "resolve_device",
    "rms_norm",
    "rope_frequencies",
    "sample_token",
    "sequence_key",
    "swiglu",
]
