"""Attention: the plain einsum path and the dispatch to the flash kernel.

Port of ``ray_tpu/ops/attention.py``. Convention: q/k/v are
(batch, seq, heads, head_dim) [BSHD].

The flash path is taken only for plain (optionally causal) attention, with
no ``mask``, no ``q_positions`` and no ``kv_positions`` — the reference's
rule — and only where the kernel takes the tensors: on a CUDA device, in
bfloat16, with a head_dim in ``HEAD_DIMS``. Everything else
takes the einsum path by that rule; no exception is ever caught to fall
back. The reference's TPU tiling gates (``_can_use_flash``'s 128/512
divisibility and ``_tuned_block_sizes``) do not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.kernels.flash_attention import HEAD_DIMS, FlashAttention

_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Grouped-query attention: repeat kv heads to match q heads."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def flash_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the flash kernel takes these tensors."""
    return (
        q.device.type == "cuda"
        and q.dtype == k.dtype == v.dtype == torch.bfloat16
        and q.shape[-1] in HEAD_DIMS
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Multi-head attention: the flash kernels where they apply (see the
    module note), else the einsum softmax. Both branches are
    differentiable."""
    if (
        use_flash
        and mask is None
        and q_positions is None
        and kv_positions is None
        and flash_eligible(q, k, v)
    ):
        # the kernels index kv heads themselves; no repeated copy. The
        # autograd function makes the branch differentiable (the backward
        # kernel); without gradients it launches the forward alone.
        return FlashAttention.apply(q, k, v, causal)[0]
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    return _einsum_attention(
        q, k, v, causal=causal, mask=mask, q_positions=q_positions, kv_positions=kv_positions
    )


def _einsum_attention(q, k, v, *, causal, mask=None, q_positions=None, kv_positions=None):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        if q_positions is None:
            q_positions = torch.arange(q.shape[1], device=q.device)
        if kv_positions is None:
            kv_positions = torch.arange(k.shape[1], device=q.device)
        causal_mask = q_positions[:, None] >= kv_positions[None, :]
        scores = scores.masked_fill(~causal_mask[None, None, :, :], _NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
