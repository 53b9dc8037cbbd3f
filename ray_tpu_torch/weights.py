"""Carrying JAX parameters into the port.

The port keeps the reference's parameter pytrees (the LM's and ViT's flat
dicts of layer-stacked arrays, MNIST's nested dicts and lists), so carrying
weights over is a per-array copy with no renaming.
"""

from __future__ import annotations

from typing import Any

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


def _carry(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {name: _carry(v, dev) for name, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_carry(v, dev) for v in tree)
    return _to_torch(tree).to(dev)


def params_from_jax(params: Any, device="cuda") -> Any:
    """A pytree of arrays (dicts, lists and tuples of numpy arrays, as
    ``np.asarray`` gives them from JAX arrays) -> the same structure of
    torch tensors on ``device``, bit-exact for bf16 and fp32."""
    return _carry(params, resolve_device(device))
