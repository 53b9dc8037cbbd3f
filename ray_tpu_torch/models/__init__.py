"""Model families: the decoder-only transformer and its dense and paged
decode paths, ViT, the MNIST nets and the MoE MLP."""

from ray_tpu_torch.models import mnist, moe, vit
from ray_tpu_torch.models.generation import generate, init_kv_cache, make_decode_fns
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    param_logical_axes,
)

__all__ = [
    "TransformerConfig",
    "forward",
    "generate",
    "init_kv_cache",
    "init_params",
    "loss_fn",
    "make_decode_fns",
    "mnist",
    "moe",
    "param_logical_axes",
    "vit",
]
