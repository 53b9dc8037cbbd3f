"""optax's ``adam`` and ``clip_by_global_norm`` for the RL learners, and the
tree helpers around them.

The reference builds its learners' optimizers from optax
(``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))`` or
``optax.adam(lr)``). ``Adam`` computes the same step on a tree of tensors,
in place, with ``_foreach`` operations:

- clip (when ``grad_clip`` is set): ``norm = sqrt(sum(g**2))`` over every
  leaf; the gradients are scaled by ``grad_clip / norm`` only when
  ``norm >= grad_clip`` (optax keeps them as they are while
  ``norm < max_norm``). ``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` and always scales, which is another function;
- ``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + (1-b2)*g**2``, ``count += 1``;
  ``p -= lr * (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)``
  with the bias corrections in fp32, as optax computes them.

The state is ``{"count": int, "mu": tree, "nu": tree}`` in the parameters'
layout; ``load_state`` also takes optax's own state (any tuple nesting that
holds an object with ``count``, ``mu`` and ``nu``), so a JAX algorithm's
``get_state()["opt_state"]`` carries over.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.rl.models import tree_leaves, tree_map


class Adam:
    def __init__(self, lr: float, *, grad_clip: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.grad_clip, self.b1, self.b2, self.eps = lr, grad_clip, b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def step(self, params, grads: Sequence[torch.Tensor], state: Dict[str, Any]) -> None:
        """One clipped Adam step of ``params`` (in place) by ``grads``, given in
        ``tree_leaves(params)`` order; updates ``state`` in place."""
        leaves = tree_leaves(params)
        grads = list(grads)
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        state["count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(leaves, upd, alpha=-self.lr)

    def load_state(self, state, like, device) -> Dict[str, Any]:
        """An optimizer state for parameters shaped as ``like`` from a numpy
        state: this class's ``state_numpy`` or optax's."""
        found = _find_adam_state(state)
        if found is None:
            raise ValueError("no Adam state (count, mu, nu) in the given optimizer state")
        count, mu, nu = found
        tensors = lambda tree: _copy_into(self.init(like)["mu"], tree, device)  # noqa: E731
        return {"count": int(np.asarray(count)), "mu": tensors(mu), "nu": tensors(nu)}


def _find_adam_state(state):
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return state["count"], state["mu"], state["nu"]
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state.count, state.mu, state.nu
    if isinstance(state, (list, tuple)):
        for s in state:
            found = _find_adam_state(s)
            if found is not None:
                return found
    return None


def _copy_into(dst, src, device):
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(torch.tensor(np.asarray(s), device=device))
    return dst


def state_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    return {"count": np.int32(state["count"]), "mu": to_numpy(state["mu"]),
            "nu": to_numpy(state["nu"])}


def to_numpy(tree):
    """A tree of tensors as numpy arrays that own their memory: on the CPU
    ``.numpy()`` shares it with a parameter the optimizer later updates in
    place."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def clone(tree):
    """A detached snapshot of a parameter tree (target networks)."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def polyak_(target, source, tau: float) -> None:
    """``target = (1 - tau) * target + tau * source``, into ``target`` only."""
    t, s = tree_leaves(target), tree_leaves(source)
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, s, alpha=tau)


def value_and_grad(loss_fn, params, *args):
    """``loss_fn(params, *args) -> (loss, aux)``; returns ``(loss, aux, grads)``
    with ``grads`` in ``tree_leaves(params)`` order."""
    loss, aux = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tree_leaves(params), grads)]
    return loss.detach(), aux, grads
