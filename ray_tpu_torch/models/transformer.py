"""Decoder-only transformer LM (plain torch).

Port of ``ray_tpu/models/transformer.py``. Parameters keep the reference's
flat dict of layer-stacked tensors, with the same names and layouts, so
weights carry over from JAX with no renaming (``ray_tpu_torch.weights``):
``wq (L,D,H,Hd)``, ``wk/wv (L,D,KV,Hd)``, ``wo (L,H,Hd,D)``, ``w_up/w_gate
(L,D,F)``, ``w_down (L,F,D)``, ``attn_norm/mlp_norm (L,D)`` in fp32,
``final_norm (D,)``, ``embed (V,D)``, ``unembed (D,V)``. The reference's
``lax.scan`` over stacked layers is a Python loop over the layer index; a
stacked entry may also be a sequence of per-layer tensors (the training
step's per-layer leaves, ``ray_tpu_torch.parallel.spmd``).

``forward`` and ``loss_fn`` are differentiable. ``remat`` checkpoints each
block when gradients are being recorded, as the reference's
``jax.checkpoint`` does: ``True`` recomputes the whole block in the
backward pass, ``remat_policy="dots"`` saves the outputs of the projection
GEMMs (products with no batch dimension) and recomputes the rest.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
    remat: bool = True  # checkpoint each block while recording gradients
    # None = full recompute; "dots" saves the projection GEMMs' outputs
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


def param_logical_axes(cfg: TransformerConfig) -> Dict[str, Tuple]:
    """Logical sharding axes per parameter (the reference's, for the
    multi-GPU slice's sharding rules)."""
    axes = {
        "embed": ("vocab", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "attn_norm": ("layers", "norm"),
        "mlp_norm": ("layers", "norm"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "final_norm": ("norm",),
    }
    if cfg.use_swiglu:
        axes["w_gate"] = ("layers", "embed", "mlp")
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    return axes


UNSTACKED = ("embed", "unembed", "final_norm")  # every other parameter is per layer


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s slice of every stacked parameter."""
    return {k: v[li] for k, v in params.items() if k not in UNSTACKED}


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


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's counterpart of the reference's
    ``dots_with_no_batch_dims_saveable``: ``torch.einsum`` runs every
    product as a ``bmm``, a projection with a batch of 1 and attention's
    products with a batch of B*H, so save the former and recompute the
    rest (attention and the flash kernel's output included)."""
    if op is torch.ops.aten.mm.default or (
        op is torch.ops.aten.bmm.default and args[0].shape[0] == 1
    ):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn, *args):
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy),
        )
    return checkpoint(fn, *args, use_reentrant=False)


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
    the flash kernel is checked against on the card. Differentiable; see
    the module note for ``cfg.remat``."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    x = params["embed"][tokens]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)

    def block(x, layer):
        return _block(cfg, x, layer, cos, sin, positions, use_flash)

    for li in range(cfg.n_layers):
        x = _remat(cfg, block, x, layer_params(params, li))
    return unembed(params, x)


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    loss_mask: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: logsumexp of the fp32 logits
    minus the gold logit, averaged over all tokens or, with ``loss_mask``,
    over the masked-in ones (at least one)."""
    logits = forward(params, tokens, cfg, positions=positions, use_flash=use_flash).float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = logz - gold
    if loss_mask is not None:
        mask = torch.as_tensor(loss_mask, device=logits.device).to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
