"""Autoregressive decoding with a KV cache (plain torch around two CUDA kernels).

Port of ``ray_tpu/models/generation.py``. Two cache layouts share the same
attention math:

* dense (``init_kv_cache`` + ``make_decode_fns``, driven by ``generate``):
  a per-batch contiguous cache ``{"k", "v": (L, B, max_len, KV, Hd),
  "pos"}``, every sequence advancing in lockstep — the static-batch path;
* paged (``init_paged_pool`` + ``make_paged_fns``): one device-wide pool of
  fixed-size blocks per layer; each sequence owns a block table mapping
  absolute positions to pool slots. Block tables are dense int32 tensors
  padded with the reserved null block 0, so decode runs at one fixed batch
  shape no matter which sequences occupy its slots.

Where the port differs from the reference, in both layouts:

* prefill starts every sequence at position 0, so its attention is exactly
  causal self-attention over the prompt's own q/k/v for every row below
  its length; the port runs it through the flash kernel
  (``ops.attention.attention``) instead of masking the whole cache;
* decode reads each sequence's cache rows in place through the
  paged-attention kernel (``kernels.paged_attention``). A dense cache is a
  pool whose "blocks" are whole sequences: one layer's slice (B, max_len,
  KV, Hd) is the pool (B * max_len, KV, Hd), block ``b`` of sequence ``b``,
  ``block_size = max_len``;
* the KV write stays a plain ``index_copy_``, in place on the cache, where
  the reference donates the cache to ``jit``;
* rotary positions past ``max_seq_len`` (the padded rows of a prefill
  bucket) are clamped into the tables, as JAX clamps the gather.

``use_kernels=False`` takes the plain versions (the reference's masked
softmax over the cache), which the kernels are checked against on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.kernels.paged_attention import paged_attention, paged_attention_reference
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    block_output,
    layer_params,
    qkv,
    unembed,
)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import rms_norm, rope_frequencies

_NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]
Pool = Dict[str, torch.Tensor]


def _rope_tables(cfg: TransformerConfig) -> Callable[[torch.device], tuple]:
    """(cos, sin) for a device, made once per device."""
    tables: Dict[torch.device, tuple] = {}

    def rope(dev):
        if dev not in tables:
            tables[dev] = rope_frequencies(
                cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev
            )
        return tables[dev]

    return rope


# -- dense KV cache ----------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *, device="cuda") -> Cache:
    """Zeroed dense cache: k/v (L, B, max_len, KV, Hd) in ``cfg.dtype``, and
    ``pos``, the next position to write, an int32 scalar on the device."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _cached_attention(q, ck, cv, cache_positions, q_positions):
    """Plain version: q (B,S,H,Hd) against the full cache (B,M,KV,Hd),
    masked to entries at cache_positions <= q_positions (causal over
    absolute positions). fp32 scores, ``-1e30`` masking, probabilities cast
    to q's dtype before PV, as the reference."""
    n_rep = q.shape[2] // ck.shape[2]
    ck = ck.repeat_interleave(n_rep, dim=2)
    cv = cv.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    mask = cache_positions[None, :] <= q_positions[:, None]  # (S, M)
    scores = scores.masked_fill(~mask[None, None, :, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, cv)


def _forward_cached(
    params, tokens, positions, cache: Cache, cfg: TransformerConfig, *, rope, prefill: bool,
    use_kernels: bool = True,
):
    """Run the model over ``tokens`` (B,S) at absolute ``positions`` (S,),
    writing k/v into the cache at [pos, pos+S) in place. ``prefill`` (a
    cache at position 0): causal attention over the tokens' own q/k/v.
    Otherwise (S=1): attention over cache rows 0..pos, through the paged
    kernel with one whole-sequence block per row of the batch.
    Returns (logits (B,S,V) fp32, cache)."""
    b, s = tokens.shape
    cos, sin = rope
    x = params["embed"][tokens]
    max_len = cache["k"].shape[2]
    dev = x.device
    start = cache["pos"]
    # the write start clamped so that the rows fit, as dynamic_update_slice
    write = torch.clamp(start.long(), 0, max_len - s) + torch.arange(s, device=dev)
    rope_positions = torch.clamp(positions, max=cfg.max_seq_len - 1)
    if not prefill:
        if use_kernels:
            tables = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
            last_pos = start.expand(b)
        else:
            cache_positions = torch.arange(max_len, device=dev)
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h = rms_norm(x, layer["attn_norm"])
        q, k, v = qkv(layer, h, cos, sin, rope_positions)
        ck, cv = cache["k"][li], cache["v"][li]
        ck.index_copy_(1, write, k.to(ck.dtype))
        cv.index_copy_(1, write, v.to(cv.dtype))
        if prefill:
            att = attention(q, k, v, causal=True, use_flash=use_kernels)
        elif use_kernels:
            # the layer's cache as a pool of B blocks of max_len slots
            pk, pv = (c.view(b * max_len, *c.shape[2:]) for c in (ck, cv))
            att = paged_attention(q[:, 0], pk, pv, tables, last_pos, max_len)[:, None]
        else:
            att = _cached_attention(q, ck, cv, cache_positions, positions)
        x = block_output(cfg, layer, x, h, att)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": start + s}
    return unembed(params, x).float(), new_cache


def make_decode_fns(cfg: TransformerConfig, max_len: int, *, use_kernels: bool = True):
    """Returns (prefill, decode_step) over a dense cache, each updating the
    cache's k/v in place and returning the cache with ``pos`` advanced.

    prefill(params, tokens (B,S), cache) -> (last_logits (B,V), cache)
    decode_step(params, token (B,1), cache) -> (logits (B,V), cache)

    ``max_len`` is the cache's length (the reference's signature; the cache
    carries it). Nothing here synchronises with the device.
    ``use_kernels=False`` routes attention through the plain versions.
    """
    rope = _rope_tables(cfg)

    @torch.no_grad()
    def prefill(params, tokens, cache):
        dev = cache["k"].device
        tokens = torch.as_tensor(tokens, device=dev)
        positions = torch.arange(tokens.shape[1], device=dev)
        logits, cache = _forward_cached(params, tokens, positions, cache, cfg, rope=rope(dev),
                                        prefill=True, use_kernels=use_kernels)
        return logits[:, -1, :], cache

    @torch.no_grad()
    def decode_step(params, token, cache):
        dev = cache["k"].device
        positions = cache["pos"].long()[None]
        logits, cache = _forward_cached(params, torch.as_tensor(token, device=dev), positions,
                                        cache, cfg, rope=rope(dev), prefill=False,
                                        use_kernels=use_kernels)
        return logits[:, -1, :], cache

    return prefill, decode_step

# -- paged KV cache ----------------------------------------------------------
#
# The pool is (L, num_blocks * block_size, kv_heads, head_dim): flat slot
# addressing, where block b covers slots [b*block_size, (b+1)*block_size).
# Block 0 is reserved as the null block: padded block-table entries and
# masked-out writes land there, and its (garbage) contents are always
# behind the causal mask, so attention never reads them.


def init_paged_pool(
    cfg: TransformerConfig, num_blocks: int, block_size: int, *, device="cuda"
) -> Pool:
    """Preallocated pool for the paged KV cache (block 0 reserved), in
    ``cfg.dtype``. The reference stores 16-bit floats as raw uint16 bits
    (its ``_kv_storage_dtype``) to dodge an XLA-CPU scatter expansion; that
    is a workaround, not a requirement, and torch's ``index_copy_`` on bf16
    is native, so the port stores ``cfg.dtype`` directly."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks * block_size, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def _write_slots(positions, write_mask, block_tables, block_size):
    """Flat pool slot per (b, s) token; masked rows go to the null block."""
    b, s = positions.shape
    mb = block_tables.shape[1]
    # JAX clamps out-of-range gathers silently; torch raises, so clamp here
    pidx = torch.clamp(positions // block_size, 0, mb - 1)
    slot = torch.gather(block_tables.long(), 1, pidx) * block_size + positions % block_size
    null_slot = torch.arange(b * s, device=positions.device) % block_size
    return torch.where(write_mask.reshape(-1), slot.reshape(-1), null_slot)


def _forward_paged(
    params,
    tokens,
    positions,
    write_mask,
    block_tables,
    pool: Pool,
    cfg: TransformerConfig,
    block_size: int,
    *,
    rope,
    prefill: bool,
    use_kernels: bool = True,
):
    """Run the model over ``tokens`` (B,S) at per-sequence absolute
    ``positions`` (B,S), writing k/v into the pool in place. ``write_mask``
    (B,S) diverts padded rows to the null block; ``block_tables`` (B,MB)
    maps block index -> pool block (0-padded).

    ``prefill`` (B=1, positions 0..S-1): causal attention over the bucket's
    own q/k/v. Otherwise (S=1): paged attention over each sequence's rows
    0..position. ``use_kernels=False`` takes the plain versions, the
    reference the kernels are checked against on the card.
    Returns logits (B,S,V) fp32."""
    b, s = tokens.shape
    cos, sin = rope
    x = params["embed"][tokens]
    slots = _write_slots(positions, write_mask, block_tables, block_size)
    if not prefill:
        paged = paged_attention if use_kernels else paged_attention_reference
        last_pos = positions[:, 0].to(torch.int32)
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h = rms_norm(x, layer["attn_norm"])
        q, k, v = qkv(layer, h, cos, sin, positions)
        pk, pv = pool["k"][li], pool["v"][li]
        pk.index_copy_(0, slots, k.reshape(b * s, *k.shape[2:]).to(pk.dtype))
        pv.index_copy_(0, slots, v.reshape(b * s, *v.shape[2:]).to(pv.dtype))
        if prefill:
            att = attention(q, k, v, causal=True, use_flash=use_kernels)
        else:
            att = paged(q[:, 0], pk, pv, block_tables, last_pos, block_size)[:, None]
        x = block_output(cfg, layer, x, h, att)
    return unembed(params, x).float()


def make_paged_fns(cfg: TransformerConfig, *, block_size: int, use_kernels: bool = True):
    """Returns (prefill, decode_step, decode_step_greedy) over a paged pool,
    each updating the pool in place and returning it.

    prefill(params, tokens (1,S), block_table (1,MB), pool, length)
        -> (logits at position length-1 (1,V), pool)
    decode_step(params, tokens (B,), positions (B,), block_tables (B,MB),
        pool, active (B,) bool) -> (logits (B,V), pool)
    decode_step_greedy(same args) -> (next tokens (B,) int32, pool)
        — argmax on the device, so a greedy batch ships B ints to the host
        per step instead of B x vocab logits.

    Integer inputs are int32 tensors (or anything ``torch.as_tensor``
    takes) and move to the pool's device. Nothing here synchronises with
    the device: results stay there until the caller reads them.
    ``use_kernels=False`` routes attention through the plain versions.
    """
    rope = _rope_tables(cfg)

    def _i32(x, dev):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    @torch.no_grad()
    def prefill(params, tokens, block_table, pool, length):
        dev = pool["k"].device
        tokens = _i32(tokens, dev)
        rows = torch.arange(tokens.shape[1], device=dev)[None, :].expand(tokens.shape)
        write_mask = rows < int(length)
        # a bucket may run past max_seq_len: its padded rows (write-masked,
        # and causally invisible to the rows below length) take the last
        # rotary position, as JAX clamps the gather
        positions = torch.clamp(rows, max=cfg.max_seq_len - 1)
        logits = _forward_paged(
            params, tokens, positions, write_mask, _i32(block_table, dev), pool, cfg,
            block_size, rope=rope(dev), prefill=True, use_kernels=use_kernels,
        )
        return logits[:, int(length) - 1], pool

    @torch.no_grad()
    def decode_step(params, tokens, positions, block_tables, pool, active):
        dev = pool["k"].device
        positions = _i32(positions, dev).long()
        logits = _forward_paged(
            params, _i32(tokens, dev)[:, None], positions[:, None],
            torch.as_tensor(active, device=dev)[:, None], _i32(block_tables, dev), pool,
            cfg, block_size, rope=rope(dev), prefill=False, use_kernels=use_kernels,
        )
        return logits[:, 0], pool

    def decode_step_greedy(params, tokens, positions, block_tables, pool, active):
        logits, pool = decode_step(params, tokens, positions, block_tables, pool, active)
        return torch.argmax(logits, dim=-1).to(torch.int32), pool

    return prefill, decode_step, decode_step_greedy


# -- sampling ----------------------------------------------------------------


def sample_token(
    logits: torch.Tensor,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    key: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next-token selection from ``logits`` (..., V): greedy argmax when
    temperature <= 0, else temperature scaling with optional top-k
    filtering before categorical sampling from ``key``, a generator on the
    logits' device."""
    if not temperature or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if key is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    scaled = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(scaled, int(top_k), dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _NEG_INF, scaled)
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=key).reshape(probs.shape[:-1])


_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def sequence_key(seed: int, step: int, device="cpu") -> torch.Generator:
    """Per-sequence generator, deterministic in (seed, step) and independent
    of batch composition. JAX's ``fold_in(PRNGKey(seed), step)`` bits cannot
    be reproduced in torch; the port keeps the invariant instead: a
    sequence's samples depend only on (seed, step), never on its batch
    neighbours."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix64(_mix64(int(seed) & _MASK64) ^ (int(step) & _MASK64)) >> 1)
    return g


def generate(
    params,
    prompt_tokens,
    cfg: TransformerConfig,
    *,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: int = 0,
    key: Optional[torch.Generator] = None,
    fns: Optional[Tuple] = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled decoding over a dense cache on the
    parameters' device; returns (B, new) int32 tokens there.

    ``key`` is a generator on that device. Like a JAX key it is a value:
    ``generate`` draws from a copy of its state, so the same generator
    reproduces the same sample; without one, the draws start from seed 0.
    ``fns`` is a ``make_decode_fns`` pair (the kernels by default)."""
    dev = params["embed"].device
    prompt_tokens = torch.as_tensor(prompt_tokens, device=dev)
    if prompt_tokens.dim() == 1:
        prompt_tokens = prompt_tokens[None, :]
    b, s = prompt_tokens.shape
    max_len = s + max_new_tokens
    if max_len > cfg.max_seq_len:
        # the rope tables are sized to max_seq_len: past it the clamped
        # positions would silently reuse the last rotary embedding
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({cfg.max_seq_len})"
        )
    prefill, decode_step = fns or make_decode_fns(cfg, max_len)
    cache = init_kv_cache(cfg, b, max_len, device=dev)
    logits, cache = prefill(params, prompt_tokens, cache)
    sampled = bool(temperature and temperature > 0)
    if sampled:
        gen = torch.Generator(device=dev if key is None else key.device)
        if key is None:
            gen.manual_seed(0)
        else:
            gen.set_state(key.get_state())
    out = []
    for i in range(max_new_tokens):
        if sampled:
            tok = sample_token(logits, temperature=temperature, top_k=top_k, key=gen)
        else:
            tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        if i + 1 < max_new_tokens:  # the last token needs no further logits
            logits, cache = decode_step(params, tok[:, None], cache)
    return torch.stack(out, dim=1).to(torch.int32)
