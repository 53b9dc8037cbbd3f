"""Mixture-of-Experts MLP (plain torch, one device).

Port of ``ray_tpu/models/moe.py``: GShard-style top-k gating with a
per-expert capacity, dispatch and combine einsums, and the
load-balancing loss, all in fp32, as the reference. Its top-k is
``jax.lax.top_k`` (descending, sorted), here ``torch.topk(sorted=True)``,
and its ``jax.nn.gelu`` defaults to the tanh approximation, as here. The
expert dimension carries the logical axis ``expert``
(``moe_param_logical_axes``); sharding it, with the all-to-all of the
dispatch, comes with the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


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


def moe_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig):
    """x: (B, S, D) -> (y (B, S, D), aux_loss).

    GShard dispatch: tokens are routed to their top-k experts with a
    per-expert capacity; overflow tokens are dropped (their output is 0, so
    the caller's residual passes them through). aux_loss is the standard
    load-balancing loss."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d).float()

    logits = xt @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)

    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    capacity = max(1, int(cfg.capacity_factor * t * k / e))

    # position of each (token, k) within its expert's capacity, in
    # token-major order: a token's first choice before its second
    onehot = F.one_hot(expert_idx, e)  # (T, K, E) int64
    flat = onehot.reshape(t * k, e)
    pos_in_expert = torch.cumsum(flat, dim=0) * flat - 1
    pos = pos_in_expert.reshape(t, k, e).amax(-1)  # (T, K): position, -1 if none
    within = (pos >= 0) & (pos < capacity)

    # dispatch (T, E, C) and combine weights
    t_idx = torch.arange(t, device=x.device)[:, None].expand(t, k)
    safe_pos = torch.clamp(pos, 0, capacity - 1)
    index = (t_idx.reshape(-1), expert_idx.reshape(-1), safe_pos.reshape(-1))
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    dispatch.index_put_(index, within.float().reshape(-1), accumulate=True)
    combine.index_put_(index, (gate_vals * within).reshape(-1), accumulate=True)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, params["w_in"].float()),
               approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_out"].float())
    yt = torch.einsum("tec,ecd->td", combine, expert_out)

    # load-balancing loss (Shazeer et al.): E * sum_e f_e * p_e
    token_frac = F.one_hot(expert_idx[:, 0], e).float().mean(0)
    prob_frac = probs.mean(0)
    aux_loss = e * torch.sum(token_frac * prob_frac)

    return yt.reshape(b, s, d).to(x.dtype), aux_loss
