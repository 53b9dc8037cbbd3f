"""Pytree checkpoints: the port of ``save_pytree`` and ``load_pytree`` in
``ray_tpu/train/jax_utils.py``.

A state is a nested structure of dicts, lists and tuples whose leaves are
tensors, Python numbers or strings, and optimizers: a
``torch.optim.Optimizer``, or the train step's ``OptimizerState``
(``ray_tpu_torch.parallel.spmd``), whose optimizer's ``state_dict`` (its
moments and step counts) is what is saved. ``save_pytree`` writes the
structure with ``torch.save`` into ``path/state.pt``; ``load_pytree`` reads it
back with ``weights_only=True``, so loading runs no pickled code.

The reference's ``ensure_platform`` has no counterpart: it pins JAX's
backend inside worker processes, and torch places each tensor on the
device it is given.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ray_tpu_torch.parallel.spmd import OptimizerState

_FILE = "state.pt"
_OPTIMIZER = "__optimizer_state_dict__"


def _optimizer(x: Any) -> Optional[torch.optim.Optimizer]:
    if isinstance(x, OptimizerState):
        return x.optimizer
    if isinstance(x, torch.optim.Optimizer):
        return x
    return None


def _saveable(tree: Any) -> Any:
    opt = _optimizer(tree)
    if opt is not None:
        return {_OPTIMIZER: opt.state_dict()}
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_saveable(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def save_pytree(state: Any, path: str) -> None:
    """Save a pytree of tensors (and optimizers, see the module note) to
    directory ``path``, made if missing."""
    os.makedirs(path, exist_ok=True)
    torch.save(_saveable(state), os.path.join(path, _FILE))


def _restore(saved: Any, target: Any, where: str) -> Any:
    opt = _optimizer(target)
    if opt is not None:
        if not (isinstance(saved, dict) and _OPTIMIZER in saved):
            raise ValueError(f"{where}: target holds an optimizer, the checkpoint does not")
        opt.load_state_dict(saved[_OPTIMIZER])
        return target
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"{where}: keys differ from the target's")
        return {k: _restore(saved[k], target[k], f"{where}.{k}") for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"{where}: length differs from the target's")
        return type(target)(_restore(s, t, f"{where}[{i}]") for i, (s, t) in
                            enumerate(zip(saved, target)))
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or (saved.shape, saved.dtype) != (
            target.shape, target.dtype
        ):
            raise ValueError(f"{where}: shape or dtype differs from the target's "
                             f"{target.dtype} {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    return saved


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """Load a pytree saved by :func:`save_pytree`.

    Without ``target``, tensors come back on the CPU and a saved optimizer
    as its ``{"__optimizer_state_dict__": state_dict}``. With ``target`` (a
    pytree of the same structure), the saved values are restored into it:
    each of its tensors receives its saved values in place, on its own
    device and in its own dtype, so views that share its storage (the
    train step's per-layer leaves) stay tied to it, and each of its
    optimizers loads its saved state. Returns the restored structure."""
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if target is None:
        return saved
    return _restore(saved, target, "state")
