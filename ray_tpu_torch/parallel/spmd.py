"""Train-step builder for the LM in ``ray_tpu_torch.models.transformer``.

Port of ``ray_tpu/parallel/spmd.py`` ``build_lm_train_step``, on one
device. The reference jits one XLA program over a mesh; this slice runs
the step eagerly on one card (or the CPU, when asked). A mesh, its
sharding ``rules`` and ``context_parallel`` come with the multi-GPU slice.

Stacked parameters. The model keeps the reference's layer-stacked
parameters (``w_up (L, D, F)``, ...). Differentiating through
``params["w_up"][li]`` would give each layer a ``select_backward`` that
allocates a zero tensor the size of the whole stack and adds it into the
stack's gradient: L fills and L - 1 additions of the stack per step. The
reference's ``lax.scan`` accumulates in place instead. So the step
differentiates per-layer leaves, views of the stacked storage
(``OptimizerState.leaves``): each layer's gradient is made once, at its
own size, and the optimizer updates the views, which is to say the stacks,
in place. The parameters a state holds are therefore updated in place by
``step_fn``, where JAX donates and replaces them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer as tfm

State = Dict[str, object]
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]
Leaves = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


@dataclass
class OptimizerState:
    """The optimizer and the leaves it updates: per name, one tensor (the
    unstacked parameters) or a list of per-layer views of the stack."""

    optimizer: torch.optim.Optimizer
    leaves: Leaves


def flat_leaves(leaves: Leaves) -> List[torch.Tensor]:
    """Every leaf, in a fixed order (the optimizer's)."""
    out: List[torch.Tensor] = []
    for name in sorted(leaves):
        leaf = leaves[name]
        out.extend(leaf if isinstance(leaf, list) else [leaf])
    return out


def layer_leaves(params: tfm.Params) -> Leaves:
    """Leaves that share storage with ``params``: a per-layer view of each
    stacked tensor, the unstacked ones whole."""
    leaves: Leaves = {}
    for name, t in params.items():
        base = t.detach()
        if name in tfm.UNSTACKED:
            leaves[name] = base.requires_grad_()
        else:
            leaves[name] = [base[li].requires_grad_() for li in range(base.shape[0])]
    return leaves


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """fp32 global L2 norm, as ``optax.global_norm``."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class TrainStepBundle:
    """Everything a trainer needs to run steps on one device."""

    init_fn: Callable[[torch.Generator], State]  # generator -> train state
    step_fn: Callable[[State, torch.Tensor, torch.Tensor], Tuple[State, Dict[str, torch.Tensor]]]
    state_from_params: Callable[[tfm.Params], State]  # takes ownership of params
    config: tfm.TransformerConfig
    device: torch.device

    def init_state(self, seed: int = 0) -> State:
        """The train state from an integer seed (a ``torch.Generator`` on
        the step's device; its numbers differ from JAX's for the seed)."""
        return self.init_fn(torch.Generator(device=self.device).manual_seed(seed))

    def shard_batch(self, tokens, targets) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host arrays -> tensors on the device, through pinned memory
        without a synchronisation."""
        return _place(tokens, self.device), _place(targets, self.device)


def _place(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def build_lm_train_step(
    cfg: tfm.TransformerConfig,
    mesh=None,
    *,
    device: DeviceLike = "cuda",
    optimizer: Optional[OptimizerFactory] = None,
    learning_rate: float = 1e-4,
) -> TrainStepBundle:
    """Init and step functions for ``cfg`` on one device.

    ``optimizer`` makes a ``torch.optim.Optimizer`` from the leaves; the
    default is the reference's ``optax.adamw(learning_rate,
    weight_decay=0.01)``: AdamW with betas (0.9, 0.999), eps 1e-8 and decay
    on every parameter, moments in the parameters' dtype.

    ``step_fn(state, tokens, targets)`` returns the state (its parameters
    and moments updated in place, ``step`` advanced) and ``{"loss",
    "grad_norm"}`` as device tensors: the mean next-token cross-entropy in
    fp32 and the fp32 global norm of the gradients before the update."""
    if mesh is not None:
        raise NotImplementedError(
            "build_lm_train_step runs on one device; a mesh comes with the "
            "multi-GPU slice (ROADMAP Queue 1, 'Multi-GPU')"
        )
    dev = resolve_device(device)
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.AdamW(
                leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
            )

    def state_from_params(params: tfm.Params) -> State:
        leaves = layer_leaves(params)
        opt = OptimizerState(optimizer(flat_leaves(leaves)), leaves)
        return {"params": params, "opt": opt, "step": 0}

    def init(generator: torch.Generator) -> State:
        return state_from_params(tfm.init_params(generator, cfg, device=dev))

    def step(state: State, tokens, targets):
        opt: OptimizerState = state["opt"]  # type: ignore[assignment]
        opt.optimizer.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(opt.leaves, tokens, targets, cfg)
        loss.backward()
        leaves = flat_leaves(opt.leaves)
        for p in leaves:
            if p.grad is None:
                # a parameter the config does not use (GPT-J's mlp_norm):
                # JAX differentiates it to zeros, and AdamW still decays it
                p.grad = torch.zeros_like(p)
        grad_norm = global_norm([p.grad for p in leaves])
        opt.optimizer.step()
        new_state = {"params": state["params"], "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return TrainStepBundle(
        init_fn=init,
        step_fn=step,
        state_from_params=state_from_params,
        config=cfg,
        device=dev,
    )
