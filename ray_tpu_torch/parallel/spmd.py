"""Train-step builder for the LM in ``ray_tpu_torch.models.transformer``.

Port of ``ray_tpu/parallel/spmd.py`` ``build_lm_train_step``. The
reference jits one XLA program over a mesh; here each rank runs the step
eagerly on its device (one card, or the CPU when asked) over its shards,
and the model's explicit collectives (``ShardedModel``) and the step's
gradient sums stand for what XLA inserts. Without a mesh the same step
runs on one device, over a model whose collectives are all no-ops.

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
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import AXIS_CONTEXT, Mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_LM_RULES,
    PartitionSpec,
    Rules,
    batch_sharding,
    shard_params,
    shard_tensor,
)

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


@dataclass
class TrainStepBundle:
    """Everything a trainer needs to run steps on one device, or on one
    rank of a mesh."""

    init_fn: Callable[[torch.Generator], State]  # generator -> train state
    step_fn: Callable[[State, torch.Tensor, torch.Tensor], Tuple[State, Dict[str, torch.Tensor]]]
    state_from_params: Callable[[tfm.Params], State]  # takes ownership of params
    config: tfm.TransformerConfig
    device: torch.device
    mesh: Optional[Mesh] = None
    batch_spec: Optional[PartitionSpec] = None

    def init_seed_fn(self, seed: int) -> State:
        """The train state from an integer seed (a ``torch.Generator`` on
        the step's device; its numbers differ from JAX's for the seed).
        On a mesh every rank draws the same full parameters and keeps its
        shard."""
        return self.init_fn(torch.Generator(device=self.device).manual_seed(seed))

    def init_state(self, seed: int = 0) -> State:
        """The train state from an integer seed (``init_seed_fn``)."""
        return self.init_seed_fn(seed)

    def shard_batch(self, tokens, targets) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host arrays -> tensors on the device, through pinned memory
        without a synchronisation. On a mesh every rank passes the same
        global arrays and keeps its shard (``put_global``)."""
        if self.mesh is not None:
            return (put_global(tokens, self.batch_spec, self.mesh),
                    put_global(targets, self.batch_spec, self.mesh))
        return _place(tokens, self.device), _place(targets, self.device)


def _place(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def put_global(host_array, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global host array under ``spec``, on the
    mesh's device: every rank passes the same global value."""
    return _place(shard_tensor(torch.as_tensor(host_array), spec, mesh), mesh.device)


def build_lm_train_step(
    cfg: tfm.TransformerConfig,
    mesh: Optional[Mesh] = None,
    *,
    rules: Rules = DEFAULT_LM_RULES,
    device: DeviceLike = "cuda",
    optimizer: Optional[OptimizerFactory] = None,
    learning_rate: float = 1e-4,
    context_parallel: bool = False,
) -> TrainStepBundle:
    """Init and step functions for ``cfg`` on one device, or (``mesh``) on
    this rank of a mesh.

    ``optimizer`` makes a ``torch.optim.Optimizer`` from the leaves; the
    default is the reference's ``optax.adamw(learning_rate,
    weight_decay=0.01)``: AdamW with betas (0.9, 0.999), eps 1e-8 and decay
    on every parameter, moments in the parameters' dtype.

    ``step_fn(state, tokens, targets)`` returns the state (its parameters
    and moments updated in place, ``step`` advanced) and ``{"loss",
    "grad_norm"}`` as device tensors: the mean next-token cross-entropy in
    fp32 and the fp32 global norm of the gradients before the update.

    With a mesh (``ray_tpu_torch.parallel.mesh.create_mesh``) the device is
    the mesh's, parameters and AdamW's moments are this rank's shards under
    ``rules``, and ``shard_batch`` keeps this rank's part of the global
    batch. The step is the reference's on a mesh of the same shape: the loss
    is the global mean; after the backward each gradient is summed over the
    batch and sequence axes it is replicated on; ``grad_norm`` counts each
    parameter once. A context axis of more than one rank shards the
    sequence, and needs ``context_parallel=True``: attention then runs the
    ring. (Without it the reference lets GSPMD gather K/V; the port has no
    such path and raises.) Without a mesh the same step runs over a model
    with no shards and no groups (``tfm.local_model``)."""
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.AdamW(
                leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
            )
    if mesh is None:
        dev = resolve_device(device)
        model = tfm.local_model(cfg)
    elif not isinstance(mesh, Mesh):
        raise NotImplementedError(
            "build_lm_train_step runs over the port's mesh (Multi-GPU: "
            "ray_tpu_torch.parallel.mesh.create_mesh), not over a "
            f"{type(mesh).__name__}"
        )
    else:
        dev = mesh.device
        ctx_axis = None
        if mesh.shape.get(AXIS_CONTEXT, 1) > 1:
            if not context_parallel:
                raise ValueError(
                    f"the mesh's context axis ({mesh.shape[AXIS_CONTEXT]} ranks) shards the "
                    "sequence: pass context_parallel=True (attention over sequence shards "
                    "is the ring)"
                )
            ctx_axis = AXIS_CONTEXT
        model = tfm.ShardedModel(cfg, mesh, rules, ctx_axis)
    logical = tfm.param_logical_axes(cfg)

    def state_from_params(params: tfm.Params) -> State:
        """Takes the parameters (on a mesh, this rank's ``shard_params``)."""
        leaves = layer_leaves(params)
        opt = OptimizerState(optimizer(flat_leaves(leaves)), leaves)
        return {"params": params, "opt": opt, "step": 0}

    def init(generator: torch.Generator) -> State:
        full = tfm.init_params(generator, cfg, device=dev)
        return state_from_params(shard_params(full, logical, rules, model.mesh))

    def step(state: State, tokens, targets):
        opt: OptimizerState = state["opt"]  # type: ignore[assignment]
        opt.optimizer.zero_grad(set_to_none=True)
        loss = tfm.sharded_loss(opt.leaves, tokens, targets, cfg, model)
        loss.backward()
        named = _named_leaves(opt.leaves)
        _fill_missing_grads([p for _, p in named])
        _sum_partial_grads(model, named)
        grad_norm = _sharded_norm(model, named)
        opt.optimizer.step()
        new_state = {"params": state["params"], "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return TrainStepBundle(
        init_fn=init,
        step_fn=step,
        state_from_params=state_from_params,
        config=cfg,
        device=dev,
        mesh=mesh,
        batch_spec=None if mesh is None else batch_sharding(mesh, rules),
    )


def _fill_missing_grads(leaves: List[torch.Tensor]) -> None:
    for p in leaves:
        if p.grad is None:
            # a parameter the config does not use (GPT-J's mlp_norm):
            # JAX differentiates it to zeros, and AdamW still decays it
            p.grad = torch.zeros_like(p)


def _named_leaves(leaves: Leaves) -> List[Tuple[str, torch.Tensor]]:
    """(parameter name, leaf) in ``flat_leaves``' order."""
    out = []
    for name in sorted(leaves):
        leaf = leaves[name]
        out.extend((name, t) for t in (leaf if isinstance(leaf, list) else [leaf]))
    return out


def _sum_partial_grads(model: tfm.ShardedModel, named: List[Tuple[str, torch.Tensor]]) -> None:
    """All-reduce each gradient over the axes it is still partial on, one
    flat buffer per (axes, dtype)."""
    buckets: Dict[Tuple, List[torch.Tensor]] = {}
    for name, p in named:
        axes = model.grad_axes(name)
        if axes:
            buckets.setdefault((axes, p.grad.dtype), []).append(p.grad)
    for (axes, _), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        collectives.all_reduce_(flat, model.mesh.group(axes))
        for g, summed in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(summed.view_as(g))


def _sharded_norm(model: tfm.ShardedModel, named: List[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """fp32 global L2 norm (``optax.global_norm``) over each parameter
    once: a sharded leaf's squared
    norm is summed over the axes that split it, and nothing is summed over
    the axes it is replicated on."""
    norms = list(torch._foreach_norm([p.grad for _, p in named], 2, dtype=torch.float32))
    by_axes: Dict[Tuple[str, ...], List[int]] = {}
    for i, (name, _) in enumerate(named):
        axes = model.shard_axes(name)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        sq = torch.stack([norms[i] for i in idx]).square()
        collectives.all_reduce_(sq, model.mesh.group(axes))
        for i, v in zip(idx, sq.sqrt()):
            norms[i] = v
    return torch.linalg.vector_norm(torch.stack(norms))
