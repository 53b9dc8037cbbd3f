"""Normalization and positional-embedding primitives (plain torch).

Port of ``ray_tpu/ops/layers.py``: the same fp32 accumulation and the same
points where values are cast back to the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_len, head_dim//2)."""
    dev = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotary position embedding. x: (..., seq, heads, head_dim);
    cos/sin: (max_len, head_dim//2); positions: (..., seq) absolute indices.
    """
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    # cast the tables to x's dtype before the multiply, as the reference does
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
