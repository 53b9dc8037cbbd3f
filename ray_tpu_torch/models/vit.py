"""Vision Transformer (ViT) (plain torch around the flash kernels).

Port of ``ray_tpu/models/vit.py``: the same stacked-layer parameter dict,
names, layouts and dtypes (``pos_embed`` and ``cls_token`` in fp32, norms
in fp32, the rest in ``cfg.dtype``), so weights carry over from JAX with
``ray_tpu_torch.weights.params_from_jax``. Patch embedding is a reshape and
one matmul; the reference's ``lax.scan`` over layers is a Python loop, and
its ``jax.checkpoint`` (``cfg.remat``) is ``torch.utils.checkpoint`` per
block while gradients are recorded.

Attention is bidirectional: ``ops.attention.attention(..., causal=False)``,
on the card in bf16 the flash forward and, under autograd, the flash
backward (head_dim 64 for ViT-B/16 and ViT-L/16, ragged 197-token
sequences). The reference's TPU gate (512-divisible sequences at head_dim
64) does not carry over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import _init
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import gelu, rms_norm

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.num_channels

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


# CI-sized and standard presets (the reference's)
VIT_TINY_TEST = ViTConfig(image_size=32, patch_size=8, num_classes=10,
                          d_model=64, n_layers=2, n_heads=4, d_ff=128)
VIT_B_16 = ViTConfig()  # ViT-Base/16 geometry (public standard)
VIT_L_16 = ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)

STACKED = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm", "w_up", "w_down")


def init_params(generator: torch.Generator, cfg: ViTConfig, *, device="cuda") -> Params:
    """Parameter dict with the reference's shapes, scales and dtypes, drawn
    from ``generator`` (which must live on ``device``); the values differ
    from JAX's for the same seed."""
    dev = resolve_device(device)
    L, D, H, Hd, Fd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    dt, g = cfg.dtype, generator
    s_in = 1.0 / math.sqrt(D)
    return {
        "patch_embed": _init(g, (cfg.patch_dim, D), 1.0 / math.sqrt(cfg.patch_dim), dt, dev),
        "pos_embed": _init(g, (cfg.num_patches + 1, D), 0.02, torch.float32, dev),
        "cls_token": _init(g, (D,), 0.02, torch.float32, dev),
        "wq": _init(g, (L, D, H, Hd), s_in, dt, dev),
        "wk": _init(g, (L, D, H, Hd), s_in, dt, dev),
        "wv": _init(g, (L, D, H, Hd), s_in, dt, dev),
        "wo": _init(g, (L, H, Hd, D), s_in / math.sqrt(2 * L), dt, dev),
        "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        "w_up": _init(g, (L, D, Fd), s_in, dt, dev),
        "w_down": _init(g, (L, Fd, D), 1.0 / math.sqrt(Fd) / math.sqrt(2 * L), dt, dev),
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "head": _init(g, (D, cfg.num_classes), s_in, dt, dev),
    }


def param_logical_axes(cfg: ViTConfig) -> Dict[str, Tuple]:
    """Logical sharding axes per parameter (the reference's)."""
    return {
        "patch_embed": ("patch", "embed"),
        "pos_embed": (None, "embed"),
        "cls_token": ("embed",),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "heads", "head_dim"),
        "wv": ("layers", "embed", "heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "attn_norm": ("layers", "norm"),
        "mlp_norm": ("layers", "norm"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "final_norm": ("norm",),
        "head": ("embed", "vocab"),
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, patch_dim) by reshape and permute,
    patches in row-major order, each flattened as (row, column, channel)."""
    b = images.shape[0]
    p = cfg.patch_size
    n = cfg.image_size // p
    x = images.reshape(b, n, p, n, p, cfg.num_channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, n, n, P, P, C)
    return x.reshape(b, n * n, cfg.patch_dim)


def _block(x: torch.Tensor, layer: Params, use_flash: bool = True) -> torch.Tensor:
    h = rms_norm(x, layer["attn_norm"])
    q = torch.einsum("bsd,dhk->bshk", h, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, layer["wv"])
    att = attention(q, k, v, causal=False, use_flash=use_flash)
    x = x + torch.einsum("bshk,hkd->bsd", att, layer["wo"])
    m = rms_norm(x, layer["mlp_norm"])
    ff = gelu(torch.einsum("bsd,df->bsf", m, layer["w_up"]))
    return x + torch.einsum("bsf,fd->bsd", ff, layer["w_down"])


def forward(cfg: ViTConfig, params: Params, images, *, use_flash: bool = True) -> torch.Tensor:
    """images (B, H, W, C) float -> logits (B, num_classes) fp32, on the
    parameters' device. ``use_flash=False`` routes attention through the
    plain einsum version, the reference the flash kernels are checked
    against on the card. Differentiable."""
    dev = params["patch_embed"].device
    images = torch.as_tensor(images, device=dev)
    x = patchify(cfg, images).to(cfg.dtype) @ params["patch_embed"]
    b = x.shape[0]
    cls = params["cls_token"].to(cfg.dtype).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(cfg.dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.n_layers):
        layer = {k: params[k][li] for k in STACKED}
        if remat:
            x = checkpoint(_block, x, layer, use_flash, use_reentrant=False)
        else:
            x = _block(x, layer, use_flash)
    x = rms_norm(x, params["final_norm"])
    # classify on the CLS token in fp32
    return (x[:, 0, :] @ params["head"]).float()


def loss_fn(cfg: ViTConfig, params: Params, images, labels, *, use_flash: bool = True):
    """(mean cross-entropy, accuracy), both fp32 scalars."""
    logits = forward(cfg, params, images, use_flash=use_flash)
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, labels[:, None]).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, acc
