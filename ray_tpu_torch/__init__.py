"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model and serving path.

A package of its own beside the JAX package ``ray_tpu``, which stays the
reference: the same parameter layouts, the same public names, the same
outputs on the same inputs and weights. It imports ``torch`` and nothing of
JAX or ``ray_tpu``. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU.

Hand-written CUDA kernels carry the main paths: flash attention (prefill,
``forward``, the ViT and, with its backward kernel, training) and paged
attention (decode over the paged pool and over the dense cache); see
``ray_tpu_torch.kernels``. The training step is
``ray_tpu_torch.parallel.spmd.build_lm_train_step``; checkpoints are
``ray_tpu_torch.train``'s ``save_pytree`` and ``load_pytree``. The RL
library (PPO, IMPALA, APPO, DQN, SAC, BC, MARWIL, CQL, multi-agent PPO;
no kernel) is ``ray_tpu_torch.rl``.
"""

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward,
)
from ray_tpu_torch.kernels.paged_attention import paged_attention
from ray_tpu_torch.models import mnist, moe, vit
from ray_tpu_torch.models.generation import (
    generate,
    init_kv_cache,
    init_paged_pool,
    make_decode_fns,
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
    loss_fn,
    param_logical_axes,
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
    LLMServer,
    TokenStream,
)
from ray_tpu_torch.train import load_pytree, save_pytree
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
    "FlashAttention",
    "InferenceEngine",
    "KVCacheExhausted",
    "LLMServer",
    "TokenStream",
    "TransformerConfig",
    "apply_rope",
    "attention",
    "flash_attention",
    "flash_attention_backward",
    "forward",
    "gelu",
    "generate",
    "init_kv_cache",
    "init_paged_pool",
    "init_params",
    "layer_norm",
    "load_pytree",
    "loss_fn",
    "make_decode_fns",
    "make_paged_fns",
    "mnist",
    "moe",
    "paged_attention",
    "param_logical_axes",
    "params_from_jax",
    "resolve_device",
    "rms_norm",
    "rope_frequencies",
    "sample_token",
    "save_pytree",
    "sequence_key",
    "swiglu",
    "vit",
]
