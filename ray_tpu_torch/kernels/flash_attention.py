"""Flash-attention forward: wrapper of ``csrc/flash_attention.cu`` and its
plain version.

Replaces the Pallas TPU kernel that ``ray_tpu/ops/attention.py`` ``_flash``
calls (``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``,
forward ``pallas_call``). Layout is BSHD: q (B, Sq, H, D), k/v (B, Sk, KV, D)
with H a multiple of KV (grouped-query attention indexes KV heads by
``h // (H // KV)``). Causal masking is top-left aligned (query i sees keys
0..i), as in the reference. Returns the output in q's dtype and the fp32
log-sum-exp of the scaled scores per (B, H, Sq).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch import _build

HEAD_DIMS = (64, 128, 256)
_NEG_INF = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes BSHD tensors of rank 4")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} not a multiple of kv heads {k.shape[2]}")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the port's ``_einsum_attention`` form with the LSE.
    fp32 scores, ``-1e30`` masking, probabilities cast to q's dtype before
    the PV product."""
    _check(q, k, v)
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        visible = torch.arange(q.shape[1], device=q.device)[:, None] >= torch.arange(
            k.shape[1], device=q.device
        )[None, :]
        scores = scores.masked_fill(~visible, _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact softmax attention, (out (B, Sq, H, D), lse (B, H, Sq) fp32).

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise when it does not take them (dtype other than bf16, head_dim not in
    ``HEAD_DIMS``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    _check(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention kernel takes bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention: empty sequence")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel loads 16-byte rows: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, kv, d, int(bool(causal)), 1.0 / (d ** 0.5), stream,
        )
    _build.check(code, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
