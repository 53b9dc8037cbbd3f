"""Decoder-only transformer LM (plain torch).

Port of ``ray_tpu/models/transformer.py``. Parameters keep the reference's
flat dict of layer-stacked tensors, with the same names and layouts, so
weights carry over from JAX with no renaming (``ray_tpu_torch.weights``):
``wq (L,D,H,Hd)``, ``wk/wv (L,D,KV,Hd)``, ``wo (L,H,Hd,D)``, ``w_up/w_gate
(L,D,F)``, ``w_down (L,F,D)``, ``attn_norm/mlp_norm (L,D)`` in fp32,
``final_norm (D,)``, ``embed (V,D)``, ``unembed (D,V)``. The reference's
``lax.scan`` over stacked layers is a Python loop over the layer index.

``remat`` is a training concern (activation checkpointing for the backward
pass); this forward keeps the field for parity and ignores it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import apply_rope, gelu, rms_norm, rope_frequencies, swiglu

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # None = MHA
    d_ff: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    parallel_block: bool = False  # True = GPT-J style
    use_swiglu: bool = True  # False = gelu MLP (GPT-J)
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # kept for parity with the reference; ignored by forward
    remat_policy: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def num_params(self) -> int:
        p = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model
        per_layer = (
            self.d_model * self.n_heads * self.head_dim  # wq
            + 2 * self.d_model * self.kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * self.d_model  # wo
            + (3 if self.use_swiglu else 2) * self.d_model * self.d_ff
            + 2 * self.d_model  # norms
        )
        return p + self.n_layers * per_layer + self.d_model


# -- presets (the reference's, shape for shape) ------------------------------

GPTJ_6B = TransformerConfig(
    vocab_size=50400,
    d_model=4096,
    n_layers=28,
    n_heads=16,
    d_ff=16384,
    max_seq_len=2048,
    parallel_block=True,
    use_swiglu=False,
    tie_embeddings=False,
)

LLAMA2_7B = TransformerConfig(
    vocab_size=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    d_ff=11008,
    max_seq_len=4096,
)

TINY = TransformerConfig(
    vocab_size=256,
    d_model=128,
    n_layers=2,
    n_heads=4,
    d_ff=512,
    max_seq_len=128,
    remat=False,
)


def _init(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x.mul_(scale)).to(dtype)


def init_params(
    generator: torch.Generator, cfg: TransformerConfig, *, device="cuda"
) -> Params:
    """Stacked-layer parameter dict with the reference's shapes, scales and
    dtypes, drawn from ``generator`` (which must live on ``device``). The
    values differ from JAX's for the same seed; parity tests carry JAX's
    weights over instead."""
    dev = resolve_device(device)
    L, D, H, KV, Hd, F = (
        cfg.n_layers,
        cfg.d_model,
        cfg.n_heads,
        cfg.kv_heads,
        cfg.head_dim,
        cfg.d_ff,
    )
    dt = cfg.dtype
    s_in = 1.0 / math.sqrt(D)
    s_ff = 1.0 / math.sqrt(F)
    g = generator
    params = {
        "embed": _init(g, (cfg.vocab_size, D), 0.02, dt, dev),
        "wq": _init(g, (L, D, H, Hd), s_in, dt, dev),
        "wk": _init(g, (L, D, KV, Hd), s_in, dt, dev),
        "wv": _init(g, (L, D, KV, Hd), s_in, dt, dev),
        "wo": _init(g, (L, H, Hd, D), s_in / math.sqrt(2 * L), dt, dev),
        "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        "w_up": _init(g, (L, D, F), s_in, dt, dev),
        "w_down": _init(g, (L, F, D), s_ff / math.sqrt(2 * L), dt, dev),
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
    }
    if cfg.use_swiglu:
        params["w_gate"] = _init(g, (L, D, F), s_in, dt, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = _init(g, (D, cfg.vocab_size), s_in, dt, dev)
    return params


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s slice of every stacked parameter."""
    return {
        k: v[li] for k, v in params.items() if k not in ("embed", "unembed", "final_norm")
    }


def mlp(cfg: TransformerConfig, layer: Params, m: torch.Tensor) -> torch.Tensor:
    if cfg.use_swiglu:
        ff = swiglu(
            torch.einsum("bsd,df->bsf", m, layer["w_gate"]),
            torch.einsum("bsd,df->bsf", m, layer["w_up"]),
        )
    else:
        ff = gelu(torch.einsum("bsd,df->bsf", m, layer["w_up"]))
    return torch.einsum("bsf,fd->bsd", ff, layer["w_down"])


def qkv(layer: Params, h: torch.Tensor, cos, sin, positions):
    """Projected and rotated q, k, v of one block: (B,S,H,Hd), (B,S,KV,Hd) x2."""
    q = torch.einsum("bsd,dhk->bshk", h, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, layer["wv"])
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def block_output(cfg, layer, x, h, att):
    """Residual stream after one block, given the attention output ``att``
    (B,S,H,Hd) and the normed input ``h``: parallel (GPT-J) or sequential."""
    att_out = torch.einsum("bshk,hkd->bsd", att, layer["wo"])
    if cfg.parallel_block:
        # GPT-J: MLP reads the same normed input; both branches add to residual
        return x + att_out + mlp(cfg, layer, h)
    x = x + att_out
    return x + mlp(cfg, layer, rms_norm(x, layer["mlp_norm"]))


def _block(cfg, x, layer, cos, sin, positions, use_flash=True):
    """One transformer block. x: (B, S, D)."""
    h = rms_norm(x, layer["attn_norm"])
    q, k, v = qkv(layer, h, cos, sin, positions)
    att = attention(q, k, v, causal=True, use_flash=use_flash)
    return block_output(cfg, layer, x, h, att)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and projection to the vocabulary, in the model's dtype."""
    x = rms_norm(x, params["final_norm"])
    w = params.get("unembed")
    if w is None:
        w = params["embed"].T
    return torch.einsum("bsd,dv->bsv", x, w)


@torch.no_grad()
def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab), on the parameters' device.
    ``positions`` (B, S) feeds the rotary embedding. ``use_flash=False``
    routes attention through the plain einsum version, the reference that
    the flash kernel is checked against on the card."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    x = params["embed"][tokens]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    for li in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params, li), cos, sin, positions, use_flash)
    return unembed(params, x)
