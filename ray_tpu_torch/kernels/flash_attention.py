"""Flash attention: wrappers of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward), their plain versions, and the
``FlashAttention`` autograd function that ties them together.

Replaces the Pallas TPU kernel that ``ray_tpu/ops/attention.py`` ``_flash``
calls (``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``:
its forward ``pallas_call`` and, through its ``custom_vjp``, the backward's
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``). Layout is
BSHD: q (B, Sq, H, D), k/v (B, Sk, KV, D) with H a multiple of KV
(grouped-query attention indexes KV heads by ``h // (H // KV)``). Causal
masking is top-left aligned (query i sees keys 0..i), as in the reference.
The forward returns the output in q's dtype and the fp32 log-sum-exp of the
scaled scores per (B, H, Sq); the backward rebuilds the probabilities from
that log-sum-exp.
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


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(q.dtype, torch.float32)


def _scale(q: torch.Tensor) -> float:
    return 1.0 / (q.shape[-1] ** 0.5)


def _visible(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(Sq, Sk) bool: query i sees key j iff j <= i (top-left causal)."""
    rows = torch.arange(q.shape[1], device=q.device)
    return rows[:, None] >= torch.arange(k.shape[1], device=q.device)[None, :]


def _check_aligned(what: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} kernel loads 16-byte rows: inputs must be 16-byte aligned")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the port's ``_einsum_attention`` form with the LSE.
    fp32 scores (float64 for float64 inputs), ``-1e30`` masking,
    probabilities cast to q's dtype before the PV product."""
    _check(q, k, v)
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    acc = _acc_dtype(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * _scale(q)
    if causal:
        scores = scores.masked_fill(~_visible(q, k), _NEG_INF)
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
    _check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, kv, d, int(bool(causal)), _scale(q), stream,
        )
    _build.check(code, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, (dq, dk, dv) in the inputs' dtypes.

    Rebuilds P = exp(Q K^T * scale - lse) from the forward's log-sum-exp,
    then D = rowsum(dO * O), dS = P * (dO V^T - D), dQ = dS K * scale,
    dK = dS^T Q * scale, dV = P^T dO, all in fp32 (float64 for float64
    inputs). A kv head's dK and dV sum its group of query heads in that
    precision before the cast."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    acc = _acc_dtype(q)
    qf, of, dof = q.to(acc), out.to(acc), d_out.to(acc)
    kf = k.to(acc).repeat_interleave(n_rep, dim=2)
    vf = v.to(acc).repeat_interleave(n_rep, dim=2)
    scale = _scale(q)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse.to(acc)[..., None])
    if causal:
        p = p.masked_fill(~_visible(q, k), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    delta = (dof * of).sum(-1).transpose(1, 2)  # (B, H, Sq)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if n_rep > 1:
        dk = dk.reshape(b, sk, kv, n_rep, d).sum(3)
        dv = dv.reshape(b, sk, kv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention``'s output, given its
    output ``out``, its ``lse`` and the output's gradient ``d_out``.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (three launches: delta, dK/dV, dQ; deterministic, no atomics) or raise
    when it does not take them (dtype other than bf16, head_dim not in
    ``HEAD_DIMS``, tensors on more than one device)."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    _check(q, k, v)
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, out, lse, d_out)):
        raise ValueError("flash_attention_backward: all inputs must lie on one CUDA device")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v, out, d_out)):
        raise ValueError("flash_attention_backward kernel takes bfloat16 q, k, v, out, d_out")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if out.shape != q.shape or d_out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and d_out {tuple(d_out.shape)} must match q")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention_backward: empty sequence")
    # autograd may hand over a strided d_out
    q, k, v, out, lse, d_out = (t.contiguous() for t in (q, k, v, out, lse, d_out))
    _check_aligned("flash_attention_backward", q, k, v, out, d_out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            d_out.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, h, kv, d, int(bool(causal)), _scale(q), stream,
        )
    _build.check(code, "flash_attention_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    causal)`` returns ``(out, lse)``; the forward is ``flash_attention`` and
    the backward ``flash_attention_backward``, from the saved q, k, v, out
    and lse. ``lse`` is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        out, lse = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        # lse has no gradient: do not fill a zero one for every call
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        if d_out is None:  # an undefined gradient: autograd may pass one
            return None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, d_out, causal=ctx.causal)
        return dq, dk, dv, None
