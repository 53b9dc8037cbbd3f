"""Paged-attention decode: wrapper of ``csrc/paged_attention.cu`` and its
plain version.

There is no Pallas counterpart: this replaces the reference's XLA gather
plus masked softmax in ``ray_tpu/models/generation.py`` (``gather_idx`` and
the gather in ``_forward_paged``, then ``_paged_attention``). One query row
per sequence, q (B, H, D), attends that sequence's cache rows
``0..positions[b]`` inclusive, read in place from one layer's pool slice
k/v (n_slots, KV, D) through ``block_tables`` (B, MB) int32: absolute
position p lives at slot ``block_tables[b, p // block_size] * block_size +
p % block_size``. A dense cache (``models.generation.make_decode_fns``) is
such a pool with one block of ``block_size = max_len`` slots per sequence
and table ``arange(B)``, in place of the reference's ``_cached_attention``.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import _build

HEAD_DIMS = (64, 128, 256)
# context tokens per CTA; a fixed size, so that a sequence's reduction
# order never depends on its batch neighbours
PARTITION = 256
_NEG_INF = -1e30


def _paged_attention(q, gk, gv, q_positions):
    """Port of the reference ``_paged_attention``: q (B,S,H,Hd) against
    gathered block rows (B,M,KV,Hd) whose row index is the absolute
    position; causal mask row <= q_position per batch element. fp32 scores,
    ``-1e30`` masking, probabilities cast to q's dtype before PV."""
    n_rep = q.shape[2] // gk.shape[2]
    gk = gk.repeat_interleave(n_rep, dim=2)
    gv = gv.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), gk.float()) * scale
    rows = torch.arange(gk.shape[1], device=q.device)
    visible = rows[None, None, :] <= q_positions[:, :, None]  # (B,S,M)
    scores = scores.masked_fill(~visible[:, None, :, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, gv)


def gather_rows(pool_layer: torch.Tensor, block_tables: torch.Tensor, block_size: int):
    """(n_slots, KV, D) pool slice -> (B, MB*block_size, KV, D) rows whose
    index is the absolute position."""
    b, mb = block_tables.shape
    idx = (
        block_tables[:, :, None].long() * block_size
        + torch.arange(block_size, device=block_tables.device)[None, None, :]
    ).reshape(b, mb * block_size)
    return pool_layer[idx]


def paged_attention_reference(q, k_pool, v_pool, block_tables, positions, block_size: int):
    """Plain version: gather each sequence's blocks, then ``_paged_attention``."""
    gk = gather_rows(k_pool, block_tables, block_size)
    gv = gather_rows(v_pool, block_tables, block_size)
    return _paged_attention(q[:, None], gk, gv, positions[:, None].long())[:, 0]


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    block_size: int,
) -> torch.Tensor:
    """Decode attention over a paged pool, out (B, H, D) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise when it does not take them."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, positions, block_size)
    b, h, d = q.shape
    n_slots, kv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d or h % kv:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)} pool {tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or positions.shape != (b,):
        raise ValueError("block_tables must be (B, MB) and positions (B,)")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise ValueError(f"paged_attention kernel takes bfloat16, got {q.dtype}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    tensors = (q, k_pool, v_pool, block_tables, positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must lie on one CUDA device")
    if not k_pool.is_contiguous() or not v_pool.is_contiguous():
        raise ValueError("paged_attention: pool slices must be contiguous")
    mb = block_tables.shape[1]
    if n_slots % block_size or mb * block_size > 2**31 - 1:
        raise ValueError("pool slots must be a whole number of blocks")
    q, block_tables, positions = q.contiguous(), block_tables.contiguous(), positions.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention kernel copies 16-byte chunks: inputs must be 16-aligned")
    n_splits = -(-mb * block_size // PARTITION)
    out = torch.empty_like(q)
    part_o = torch.empty((b, h, n_splits, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, n_splits, 2), dtype=torch.float32, device=q.device)
    # arrivals per (sequence, head group): the last CTA to arrive merges
    counters = torch.zeros((b, h), dtype=torch.int32, device=q.device)
    fn = _build.function("paged_attention_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            counters.data_ptr(), b, h, kv, d, mb, block_size, n_slots // block_size, n_splits,
            1.0 / (d ** 0.5), stream,
        )
    _build.check(code, "paged_attention_decode")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
