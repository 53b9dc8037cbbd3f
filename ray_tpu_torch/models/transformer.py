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
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import attention, ring_attention
from ray_tpu_torch.ops.layers import apply_rope, gelu, rms_norm, rope_frequencies, swiglu
from ray_tpu_torch.parallel.collectives import all_gather, all_reduce_, copy_to, reduce_from
from ray_tpu_torch.parallel.mesh import LocalMesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_LM_RULES,
    batch_sharding,
    infer_param_sharding,
    spec_axes,
)

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
    """Logical sharding axes per parameter (the reference's; the sharding
    rules of ``ray_tpu_torch.parallel.sharding`` map them to mesh axes)."""
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


def block_output(cfg, layer, x, h, att, tensor=None):
    """Residual stream after one block, given the attention output ``att``
    (B,S,H,Hd) and the normed input ``h``: parallel (GPT-J) or sequential.
    ``tensor`` is a sharded block's tensor group (None: the whole block is
    here): each branch's output is all-reduced over it, and the sequential
    block's MLP input enters its region through ``copy_to``."""
    att_out = reduce_from(torch.einsum("bshk,hkd->bsd", att, layer["wo"]), tensor)
    if cfg.parallel_block:
        # GPT-J: MLP reads the same normed input; both branches add to residual
        return x + att_out + reduce_from(mlp(cfg, layer, h), tensor)
    x = x + att_out
    m = copy_to(rms_norm(x, layer["mlp_norm"]), tensor)
    return x + reduce_from(mlp(cfg, layer, m), tensor)


def _block(cfg, x, layer, cos, sin, positions, model: "ShardedModel", use_flash=True):
    """One transformer block on ``model``'s shards (``ShardedModel``):
    the layer's gathers, the Megatron regions over its tensor group, and
    the ring over its context group. x: (B, S, D)."""
    layer = {k: model.gather(k, v) for k, v in layer.items()}
    h = copy_to(rms_norm(x, layer["attn_norm"]), model.tensor)
    q, k, v = qkv(layer, h, cos, sin, positions)
    if model.context is not None:
        att = ring_attention(q, k, v, group=model.context, causal=True, use_flash=use_flash)
    else:
        att = attention(q, k, v, causal=True, use_flash=use_flash)
    return block_output(cfg, layer, x, h, att, model.tensor)


def unembed(params: Params, x: torch.Tensor, model: Optional["ShardedModel"] = None,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final norm and projection to the vocabulary, in the model's dtype.
    With ``model`` (a rank's ``ShardedModel``) the projection is onto this
    rank's vocabulary columns, and a tied one uses ``table``, the embedding
    as the forward gathered it."""
    x = rms_norm(x, params["final_norm"])
    w = params.get("unembed")
    if model is not None:
        x = copy_to(x, model.tensor)
        w = table.T if w is None else model.gather("unembed", w)
    elif w is None:
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


# -- the sharded model (one rank's part of a mesh) ----------------------------

# dimensions the Megatron math splits over the tensor axis; every other
# sharded dimension (the embed dimension under FSDP) is gathered before use
TENSOR_DIMS = ("heads", "kv_heads", "mlp", "vocab")


class ShardedModel:
    """How one rank runs its part of the model on ``mesh`` under ``rules``
    (``ray_tpu_torch.parallel.sharding``), with explicit collectives. With
    ``mesh=None`` nothing is sharded and every group is None: the model on
    one device, whose collectives are no-ops (``local_model``).

    - **tensor** (Megatron): a rank holds its heads of ``wq/wk/wv/wo``, its
      columns of the MLP and its rows of the vocabulary (``embed``,
      ``unembed``). The normed input enters each block's region through
      ``copy_to`` (its gradient all-reduced); one all-reduce follows
      attention and one the MLP; the embedding lookup and the
      cross-entropy are vocab-parallel (all-reduces of the max, of the sum
      of exponentials and of the gold logit; no (B, S, V) gather).
    - **fsdp** (and any other axis on a non-tensor dimension): each
      parameter is gathered one layer at a time where it is used (inside
      the remat boundary, so the recompute gathers again); the gather's
      backward reduce-scatters the gradient back to the shards.
    - **batch** over the rules' batch axes and **sequence** over their
      sequence axis: the loss is the mean over the global batch; with a
      context group attention runs the ring (``ring_attention``) and RoPE
      takes global positions.
    """

    def __init__(self, cfg: TransformerConfig, mesh, rules, context_axis=None):
        mesh = LocalMesh() if mesh is None else mesh
        self.mesh = mesh
        logical = param_logical_axes(cfg)
        self.specs = infer_param_sharding(logical, rules, mesh)
        tensor_axes, self.gathers, self.gathered_axes = set(), {}, {}
        for name, axes in logical.items():
            stacked = name not in UNSTACKED
            gathers, gathered = [], ()
            for dim, entry in enumerate(self.specs[name]):
                on = spec_axes(entry)
                if not on:
                    continue
                if axes[dim] in TENSOR_DIMS:
                    tensor_axes.add(on)
                elif axes[dim] == "layers":
                    raise ValueError(f"{name}: the layer dimension cannot be sharded ({entry})")
                else:
                    gathers.append((dim - stacked, mesh.group(on)))
                    gathered += on
            self.gathers[name], self.gathered_axes[name] = gathers, gathered
        if len(tensor_axes) > 1:
            raise ValueError(f"heads, kv_heads, mlp and vocab must shard over one axis set: {tensor_axes}")
        self.tensor_axes = tensor_axes.pop() if tensor_axes else ()
        self.tensor = mesh.group(self.tensor_axes) if self.tensor_axes else None
        n_t = mesh.axis_size(self.tensor_axes)
        self.vocab_local = cfg.vocab_size // n_t
        self.vocab_start = mesh.axis_index(self.tensor_axes) * self.vocab_local
        batch = batch_sharding(mesh, rules)
        self.batch_axes = spec_axes(batch[0]) if len(batch) > 0 else ()
        self.seq_axes = spec_axes(batch[1]) if len(batch) > 1 else ()
        if self.seq_axes and (context_axis is None or self.seq_axes != (context_axis,)):
            raise ValueError(
                f"tokens are sequence shards over {self.seq_axes}: pass context_axis="
                f"{self.seq_axes[0]!r} (attention runs the ring over it)"
            )
        self.context = mesh.group(self.seq_axes) if self.seq_axes else None
        self.seq_index = mesh.axis_index(self.seq_axes)
        self.loss_axes = tuple(a for a in mesh.axis_names if a in self.batch_axes + self.seq_axes)
        for name, gathered in self.gathered_axes.items():
            # the gather's backward sums over these axes: each must hold
            # other tokens, or a replicated gradient would be counted twice
            if not set(gathered) <= set(self.loss_axes):
                raise ValueError(f"{name} is sharded over {gathered}, not all batch or sequence axes")
        self.loss_group = mesh.group(self.loss_axes) if self.loss_axes else None
        self.n_replicas = mesh.axis_size(self.loss_axes)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` (one layer's, for a stacked one) with its
        non-tensor dimensions gathered."""
        for dim, group in self.gathers[name]:
            t = all_gather(t, dim, group)
        return t

    def grad_axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which ``name``'s gradient is still a partial sum
        after the backward: the batch and sequence axes it is not gathered
        over (the gather's reduce-scatter summed those)."""
        return tuple(a for a in self.loss_axes if a not in self.gathered_axes[name])

    def shard_axes(self, name: str) -> Tuple[str, ...]:
        """Every axis that splits ``name`` (its norm sums over them)."""
        on = [a for entry in self.specs[name] for a in spec_axes(entry)]
        return tuple(a for a in self.mesh.axis_names if a in on)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: a rank's rows where the token falls in its
        slice of the vocabulary, zeros elsewhere, summed over the group."""
        if self.tensor is None:
            return table[tokens]
        local = tokens - self.vocab_start
        inside = (local >= 0) & (local < self.vocab_local)
        rows = table[local.clamp(0, self.vocab_local - 1)]
        return reduce_from(torch.where(inside[..., None], rows, torch.zeros_like(rows)), self.tensor)

    def positions(self, tokens: torch.Tensor) -> torch.Tensor:
        """Global token positions of this rank's sequence shard."""
        b, s = tokens.shape
        start = self.seq_index * s
        return (start + torch.arange(s, device=tokens.device)).expand(b, s)


@functools.lru_cache(maxsize=None)
def local_model(cfg: TransformerConfig) -> ShardedModel:
    """The model on one device: no shards, no groups."""
    return ShardedModel(cfg, None, DEFAULT_LM_RULES)


def _model(cfg, mesh, rules, context_axis) -> ShardedModel:
    if mesh is None:
        return local_model(cfg)
    return ShardedModel(cfg, mesh, DEFAULT_LM_RULES if rules is None else rules, context_axis)


def _forward(params, tokens, cfg, model: ShardedModel, positions, use_flash):
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    table = model.gather("embed", params["embed"])
    x = model.embed(table, tokens)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    if positions is None and model.context is not None:
        positions = model.positions(tokens)

    def block(x, layer):
        return _block(cfg, x, layer, cos, sin, positions, model, use_flash)

    for li in range(cfg.n_layers):
        x = _remat(cfg, block, x, layer_params(params, li))
    return unembed(params, x, model, table)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    use_flash: bool = True,
    context_axis: Optional[str] = None,
    mesh=None,
    rules=None,
) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab), on the parameters' device.
    ``positions`` (B, S) feeds the rotary embedding. ``use_flash=False``
    routes attention through the plain einsum version, the reference that
    the flash kernel is checked against on the card. Differentiable; see
    the module note for ``cfg.remat``.

    With ``mesh`` (a ``ray_tpu_torch.parallel.mesh.Mesh``), ``params`` are
    this rank's shards under ``rules`` (default ``DEFAULT_LM_RULES``) and
    ``tokens`` its shard of the batch (and of the sequence, over
    ``context_axis``, whose attention then runs the ring); the result is
    this rank's logits, (B, S) local and the vocabulary sharded as
    ``unembed`` is (``ShardedModel``)."""
    return _forward(params, tokens, cfg, _model(cfg, mesh, rules, context_axis), positions,
                    use_flash)


def forward_stages(params: Params, cfg: TransformerConfig, *, use_flash: bool = True) -> List:
    """``forward`` on one device as a chain of stage functions: the
    embedding lookup (tokens on the parameters' device -> x), one stage per
    block (x -> x) and the final norm with the unembedding (x -> logits).
    Run in order they compute ``forward(params, tokens, cfg)`` op for op;
    ``ray_tpu_torch.dag.compile_torch_pipeline`` fuses them into one CUDA
    graph. The rotary tables are made once, here, outside the stages."""
    model = local_model(cfg)
    table = params["embed"]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                                device=table.device)

    def block(x, layer):
        return _block(cfg, x, layer, cos, sin, None, model, use_flash)

    def stage(li):
        layer = layer_params(params, li)
        return lambda x: _remat(cfg, block, x, layer)

    return ([lambda tokens: model.embed(table, tokens)]
            + [stage(li) for li in range(cfg.n_layers)]
            + [lambda x: unembed(params, x, model, table)])


def sharded_loss(params, tokens, targets, cfg, model: ShardedModel, *, positions=None,
                 loss_mask=None, use_flash: bool = True):
    """``loss_fn`` with the rank's ``ShardedModel`` made once. Over a
    tensor group the cross-entropy is vocab-parallel (no (B, S, V)
    gather); the mean is over the global batch."""
    logits = _forward(params, tokens, cfg, model, positions, use_flash).float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    if model.tensor is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    else:
        peak = all_reduce_(logits.detach().amax(-1), model.tensor, dist.ReduceOp.MAX)
        sum_exp = reduce_from(torch.exp(logits - peak[..., None]).sum(-1), model.tensor)
        logz = peak + torch.log(sum_exp)
        local = targets - model.vocab_start
        inside = (local >= 0) & (local < model.vocab_local)
        gold = torch.gather(logits, -1, local.clamp(0, model.vocab_local - 1)[..., None]).squeeze(-1)
        gold = reduce_from(torch.where(inside, gold, torch.zeros_like(gold)), model.tensor)
    nll = logz - gold
    if loss_mask is not None:
        mask = torch.as_tensor(loss_mask, device=logits.device).to(nll.dtype)
        count = all_reduce_(mask.sum(), model.loss_group)
        return reduce_from((nll * mask).sum(), model.loss_group) / torch.clamp(count, min=1.0)
    if model.loss_group is None:
        return nll.mean()
    return reduce_from(nll.sum(), model.loss_group) / (nll.numel() * model.n_replicas)


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    loss_mask: Optional[torch.Tensor] = None,
    use_flash: bool = True,
    context_axis: Optional[str] = None,
    mesh=None,
    rules=None,
) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: logsumexp of the fp32 logits
    minus the gold logit, averaged over all tokens or, with ``loss_mask``,
    over the masked-in ones (at least one).

    With ``mesh`` (see ``forward``), every rank passes its shards and gets
    the mean over the global batch; backpropagating it gives this rank's
    part of each gradient (``ray_tpu_torch.parallel.spmd`` sums them)."""
    return sharded_loss(params, tokens, targets, cfg, _model(cfg, mesh, rules, context_axis),
                        positions=positions, loss_mask=loss_mask, use_flash=use_flash)
