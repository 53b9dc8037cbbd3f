"""Carrying JAX parameters into the port.

The port keeps the reference's flat dict of layer-stacked parameters, so
carrying weights over is a per-array copy with no renaming.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy accepts: carry
        # the raw 16 bits through an integer view, bit for bit
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16
        )
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(
    params: Mapping[str, np.ndarray], device="cuda"
) -> Dict[str, torch.Tensor]:
    """Parameter dict of numpy arrays (as ``np.asarray`` gives them from JAX
    arrays) -> dict of torch tensors on ``device``, bit-exact for bf16 and
    fp32."""
    dev = resolve_device(device)
    return {name: _to_torch(a).to(dev) for name, a in params.items()}
