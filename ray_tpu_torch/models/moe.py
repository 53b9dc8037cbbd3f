"""Mixture-of-Experts MLP (plain torch, one device).

Port of ``ray_tpu/models/moe.py``: GShard-style top-k gating with a
per-expert capacity, dispatch and combine einsums, and the
load-balancing loss, all in fp32, as the reference. Its top-k is
``jax.lax.top_k`` (descending, sorted), here ``torch.topk(sorted=True)``,
and its ``jax.nn.gelu`` defaults to the tanh approximation, as here.

Expert parallelism: the expert dimension carries the logical axis
``expert`` (``moe_param_logical_axes``). On a mesh whose expert axis has
more than one rank, each rank holds its experts' ``w_in``/``w_out`` and its
share of the tokens; routing is the single-device one over the whole
batch (positions within an expert's capacity count the tokens of lower
ranks first), and dispatch and combine are two ``all_to_all_single``s of
the kept (token, expert) rows. The reference's GSPMD lowers the same
einsums to all-to-alls over ICI.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 512
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, *, device="cuda") -> Dict:
    """Router and expert weights with the reference's shapes and scales,
    drawn from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(cfg.dtype)

    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal((d, e), 1.0 / math.sqrt(d)),
        "w_in": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_out": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def moe_param_logical_axes() -> Dict[str, Tuple]:
    return {
        "router": ("embed", None),
        "w_in": ("expert", "embed", "mlp"),
        "w_out": ("expert", "mlp", "embed"),
    }


def moe_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig, *, mesh=None):
    """x: (B, S, D) -> (y (B, S, D), aux_loss).

    GShard dispatch: tokens are routed to their top-k experts with a
    per-expert capacity; overflow tokens are dropped (their output is 0, so
    the caller's residual passes them through). aux_loss is the standard
    load-balancing loss.

    With ``mesh`` and an ``expert`` axis of n > 1 ranks: ``x`` is this
    rank's block of B / n rows of the batch, ``params`` its shards
    (``shard_params`` under ``moe_param_logical_axes``); the result is this
    rank's rows of y and the aux loss of the whole batch, on every rank."""
    group = None if mesh is None else mesh.group("expert")
    if group is not None:
        return _moe_expert_parallel(params, x, cfg, group)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d).float()
    probs, gate_vals, expert_idx, flat, capacity = _route(xt, params["router"], cfg, t)
    pos = _positions(flat).reshape(t, k)  # (T, K): position, -1 if none
    within = (pos >= 0) & (pos < capacity)

    # dispatch (T, E, C) and combine weights
    t_idx = torch.arange(t, device=x.device)[:, None].expand(t, k)
    safe_pos = torch.clamp(pos, 0, capacity - 1)
    index = (t_idx.reshape(-1), expert_idx.reshape(-1), safe_pos.reshape(-1))
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    dispatch.index_put_(index, within.float().reshape(-1), accumulate=True)
    combine.index_put_(index, (gate_vals * within).reshape(-1), accumulate=True)

    expert_out = _experts(torch.einsum("tec,td->ecd", dispatch, xt), params)
    yt = torch.einsum("tec,ecd->td", combine, expert_out)

    # load-balancing loss (Shazeer et al.): E * sum_e f_e * p_e
    token_frac = F.one_hot(expert_idx[:, 0], e).float().mean(0)
    prob_frac = probs.mean(0)
    aux_loss = e * torch.sum(token_frac * prob_frac)

    return yt.reshape(b, s, d).to(x.dtype), aux_loss


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, n_tokens: int):
    """Top-k gating of tokens xt (T, D) from a batch of ``n_tokens``:
    probabilities (T, E), normalised gates and experts (T, K), the one-hot
    choices (T*K, E) in token-major order (a token's first choice before
    its second), and the per-expert capacity."""
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xt @ router.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    capacity = max(1, int(cfg.capacity_factor * n_tokens * k / e))
    return probs, gate_vals, expert_idx, F.one_hot(expert_idx, e).reshape(-1, e), capacity


def _positions(flat: torch.Tensor, before=0) -> torch.Tensor:
    """Each (token, choice)'s position in its expert's queue, after
    ``before`` earlier entries per expert: (T*K,)."""
    return ((torch.cumsum(flat, dim=0) + before) * flat - 1).amax(-1)


def _experts(expert_in: torch.Tensor, params) -> torch.Tensor:
    """(E, C, D) expert inputs -> outputs, in fp32."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, params["w_in"].float()),
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, params["w_out"].float())


def _moe_expert_parallel(params, x, cfg: MoEConfig, group):
    n, rank = collectives.group_size(group), collectives.group_rank(group)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    e_local = params["w_in"].shape[0]
    if e_local * n != e:
        raise ValueError(f"{e} experts do not shard into {n} blocks of {e_local}")
    t_global = t * n
    xt = x.reshape(t, d).float()
    probs, gate_vals, expert_idx, flat, capacity = _route(xt, params["router"], cfg, t_global)

    # positions over the whole batch: this rank's tokens follow the lower
    # ranks', whose per-expert counts come first
    counts = collectives.all_gather(flat.sum(0)[None], 0, group)  # (n, E)
    pos = _positions(flat, counts[:rank].sum(0))
    expert = expert_idx.reshape(-1)
    kept = ((pos >= 0) & (pos < capacity)).nonzero().squeeze(-1)
    # kept (token, choice) rows grouped by the rank that owns their expert
    order = kept[torch.argsort(expert[kept], stable=True)]
    send = torch.bincount(expert[order] // e_local, minlength=n)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    send, recv = send.tolist(), recv.tolist()
    slots = torch.stack([expert[order] % e_local, pos[order]], dim=-1)
    their_slots = collectives.all_to_all(slots, recv, send, group)
    rows = collectives.all_to_all(xt[order // k], recv, send, group)

    expert_in = torch.zeros((e_local, capacity, d), dtype=torch.float32, device=x.device)
    expert_in = expert_in.index_put((their_slots[:, 0], their_slots[:, 1]), rows)
    expert_out = _experts(expert_in, params)
    back = collectives.all_to_all(expert_out[their_slots[:, 0], their_slots[:, 1]], send, recv, group)
    yt = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    yt = yt.index_add(0, order // k, back * gate_vals.reshape(-1)[order][:, None])

    # load-balancing loss over the whole batch
    token_frac = collectives.reduce_from(F.one_hot(expert_idx[:, 0], e).float().sum(0), group) / t_global
    prob_frac = collectives.reduce_from(probs.sum(0), group) / t_global
    aux_loss = e * torch.sum(token_frac * prob_frac)
    return yt.reshape(b, s, d).to(x.dtype), aux_loss
