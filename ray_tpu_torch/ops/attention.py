"""Attention: the plain einsum path, the dispatch to the flash kernel, and
ring attention over a context group (its hops through the flash kernels).

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

from ray_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS,
    FlashAttention,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from ray_tpu_torch.parallel import collectives

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


# ---------------------------------------------------------------------------
# ring attention (context parallelism)
# ---------------------------------------------------------------------------
#
# Port of ``ray_tpu/ops/attention.py:171`` ``ring_attention`` and ``:236``
# ``make_context_parallel_attention``. Rank i of the context group holds
# tokens [i*S, (i+1)*S) of q, k and v. Each hop attends the rank's queries
# to one K/V block through the flash forward (kernel 1, which returns the
# block's (out, lse)): causally for the diagonal block, fully for a block
# wholly in the past, not at all for a block in the future. The partial
# results merge by their log-sum-exps, in fp32. K/V move one hop by
# point-to-point send and receive; the next block is in flight while the
# current one is computed. The backward walks the ring again through the
# flash backward (kernel 1b), fed the *merged* out and lse: with the global
# lse, a block's probabilities are its share of the whole softmax, so each
# hop's dQ, dK and dV are exact parts of the total. dQ stays with its rank;
# dK and dV (fp32 sums) travel with their blocks and arrive back at their
# owner after the last hop.
#
# The per-hop work (``ring_hop_forward``, ``ring_hop_backward``,
# ``merge_partial``) is kept apart from the transport, so one process can
# run the whole schedule over a list of shards (``ring_schedule_forward`` /
# ``_backward``: the card's check against the whole-sequence kernels).


def ring_hop_forward(q, k, v, q_block: int, kv_block: int, *, causal: bool, use_flash: bool):
    """One hop: (out, lse) of ``q`` (block ``q_block``) against one K/V
    block, or None for a block wholly in q's future."""
    if causal and kv_block > q_block:
        return None
    fn = flash_attention if use_flash else flash_attention_reference
    return fn(q, k, v, causal=causal and kv_block == q_block)


def merge_partial(acc, part):
    """Merge one hop's (out, lse) into the running (out fp32, lse)."""
    out, lse = part
    if acc is None:
        return out.float(), lse
    acc_out, acc_lse = acc
    new_lse = torch.logaddexp(acc_lse, lse)
    # (B, H, S) weights -> (B, S, H, 1) against BSHD outputs
    w_acc = torch.exp(acc_lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    return acc_out * w_acc + out.float() * w_new, new_lse


def ring_hop_backward(q, k, v, out, lse, d_out, q_block: int, kv_block: int, *,
                      causal: bool, use_flash: bool):
    """One hop's (dq, dk, dv) from the merged ``out`` and ``lse``, or None
    for a block wholly in q's future."""
    if causal and kv_block > q_block:
        return None
    fn = flash_attention_backward if use_flash else flash_attention_backward_reference
    return fn(q, k, v, out, lse, d_out, causal=causal and kv_block == q_block)


def ring_schedule_forward(qs, ks, vs, *, causal: bool = True, use_flash: bool = True):
    """The ring's forward over lists of shards in one process: per shard
    (out, lse), hop by hop in the distributed order."""
    n = len(qs)
    acc = [None] * n
    for hop in range(n):
        for r in range(n):
            j = (r - hop) % n
            part = ring_hop_forward(qs[r], ks[j], vs[j], r, j, causal=causal, use_flash=use_flash)
            if part is not None:
                acc[r] = merge_partial(acc[r], part)
    return [(o.to(q.dtype), lse) for (o, lse), q in zip(acc, qs)]


def ring_schedule_backward(qs, ks, vs, outs, lses, d_outs, *, causal: bool = True,
                           use_flash: bool = True):
    """The ring's backward over lists of shards in one process: per shard
    (dq, dk, dv), summed in fp32 in the distributed order."""
    n = len(qs)
    dq = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    dk = [torch.zeros_like(k, dtype=torch.float32) for k in ks]
    dv = [torch.zeros_like(v, dtype=torch.float32) for v in vs]
    for hop in range(n):
        for r in range(n):
            j = (r - hop) % n
            g = ring_hop_backward(qs[r], ks[j], vs[j], outs[r], lses[r], d_outs[r], r, j,
                                  causal=causal, use_flash=use_flash)
            if g is not None:
                dq[r] += g[0]
                dk[j] += g[1]
                dv[j] += g[2]
    return [(a.to(q.dtype), b.to(k.dtype), c.to(v.dtype))
            for a, b, c, q, k, v in zip(dq, dk, dv, qs, ks, vs)]


class RingAttention(torch.autograd.Function):
    """``RingAttention.apply(q, k, v, group, causal, use_flash)`` ->
    (out, lse) over the context ``group``'s ring; ``lse`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, use_flash):
        n, r = collectives.group_size(group), collectives.group_rank(group)
        acc = None
        blk = [k, v]
        for hop in range(n):
            nxt = collectives.Shift(blk, group) if hop < n - 1 else None
            part = ring_hop_forward(q, blk[0], blk[1], r, (r - hop) % n,
                                    causal=causal, use_flash=use_flash)
            if part is not None:
                acc = merge_partial(acc, part)
            if nxt is not None:
                blk = nxt.wait()
        out, lse = acc[0].to(q.dtype), acc[1]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.use_flash = group, causal, use_flash
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        if d_out is None:
            return (None,) * 6
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, r = collectives.group_size(group), collectives.group_rank(group)
        dq = torch.zeros_like(q, dtype=torch.float32)
        blk_k, blk_v = k, v
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        for hop in range(n):
            g = ring_hop_backward(q, blk_k, blk_v, out, lse, d_out, r, (r - hop) % n,
                                  causal=ctx.causal, use_flash=ctx.use_flash)
            if g is not None:
                dq += g[0]
                dk += g[1]
                dv += g[2]
            if hop < n - 1:
                blk_k, blk_v, dk, dv = collectives.shift([blk_k, blk_v, dk, dv], group)
            else:  # the sums go home: block r + 1's owner is the next rank
                dk, dv = collectives.shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q, k, v, *, group, causal: bool = True, use_flash: bool = True):
    """Blockwise ring attention over the context ``group`` (a
    ``Mesh.group("context")``; None runs one block). q/k/v are this rank's
    sequence shards (BSHD; kv heads may divide q heads). ``use_flash``
    runs the hops through the flash kernels' wrappers: their plain versions
    on CPU tensors, the kernels on CUDA tensors, which raise where the
    kernels do not take the tensors (dtype, head_dim, alignment).
    ``use_flash=False`` runs every hop through the plain versions.
    Differentiable."""
    return RingAttention.apply(q, k, v, group, causal, use_flash)[0]


def make_context_parallel_attention(mesh, axis_name: str = "context", causal: bool = True):
    """``fn(q, k, v)`` on this rank's sequence shards: ring attention over
    ``mesh``'s ``axis_name`` group."""
    group = mesh.group(axis_name)

    def cp_attention(q, k, v):
        return ring_attention(q, k, v, group=group, causal=causal)

    return cp_attention
