"""RL policy/value networks (plain torch).

Port of ``ray_tpu/rl/models.py``: the same parameter tree
(``{"layers": [{"w", "b"}, ...], "pi": {"w", "b"}, "vf": {"w", "b"}}``,
fp32, ``w`` as (in, out)), so env runners and learners exchange plain
trees of tensors and JAX trees carry over with ``params_from_jax``.
Parameter leaves require gradients; learners differentiate with
``torch.autograd.grad`` and step them in place (``rl/optim.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.weights import params_from_jax


def init_mlp_policy(generator: torch.Generator, obs_dim: int, num_actions: int,
                    hidden: Tuple[int, ...] = (64, 64), *, device="cuda"):
    """The reference's initialisation (He-scaled hidden layers, a 0.01-scaled
    policy head, a unit-scaled value head, zero biases) drawn from
    ``generator``, which must live on ``device``."""
    dev = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev).mul_(scale)

    sizes = (obs_dim,) + tuple(hidden)
    params = {"layers": [], "pi": None, "vf": None}
    for i in range(len(hidden)):
        params["layers"].append({"w": normal((sizes[i], sizes[i + 1]), math.sqrt(2.0 / sizes[i])),
                                 "b": torch.zeros(sizes[i + 1], device=dev)})
    params["pi"] = {"w": normal((sizes[-1], num_actions), 0.01),
                    "b": torch.zeros(num_actions, device=dev)}
    params["vf"] = {"w": normal((sizes[-1], 1), 1.0), "b": torch.zeros(1, device=dev)}
    return trainable(params)


def trainable(tree):
    """Mark every leaf of a parameter tree as requiring gradients."""
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


def load_params(tree, device):
    """A parameter tree of numpy arrays (a JAX algorithm's, or
    ``get_state``'s) -> trainable tensors on ``device``."""
    return trainable(params_from_jax(tree, device=device))


def tree_leaves(tree):
    """Leaves in JAX's order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def apply_mlp_policy(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
    h = obs
    for layer in params["layers"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def sample_actions(params, obs: torch.Tensor, generator: torch.Generator):
    """Categorical actions by the Gumbel-max rule (as
    ``jax.random.categorical``), their log-probabilities and the values.
    ``argmax(logits - log E)`` with ``E ~ Exp(1)`` is ``argmax(logits + G)``
    with ``G`` Gumbel; the draws come from ``generator``, so one seed gives
    the same actions on every run (not JAX's bits)."""
    logits, value = apply_mlp_policy(params, obs)
    e = torch.empty_like(logits).exponential_(generator=generator)
    actions = (logits - e.log()).argmax(dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, actions[:, None])[:, 0]
    return actions, logp, value
