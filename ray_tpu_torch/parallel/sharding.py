"""Sharding rules: logical axes -> mesh axes -> this rank's shard.

Port of ``ray_tpu/parallel/sharding.py``. Models declare *logical* axis
names per parameter dimension ("embed", "mlp", "heads", ...); a rule table
maps them to mesh axes, so the same model runs pure-DP, FSDP, TP or
combinations by swapping rules. The reference annotates shardings and XLA
places the arrays; here a rank holds plain tensors, its own shard of each
parameter (``shard_params``), and the model's explicit collectives follow
the same specs.

``ray_tpu/parallel/_shard_map.py`` has no counterpart: it is a version shim
for ``jax.shard_map``, and the port's collectives are written out where
they run (``ray_tpu_torch.parallel.collectives``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_TENSOR,
    AbstractMesh,
    Mesh,
)

# logical dimension name -> mesh axis (or None = replicate). A mesh axis may
# appear in multiple rules only if those logical dims never co-occur in one
# parameter.
Rules = Dict[str, Optional[Union[str, Tuple[str, ...]]]]

# FSDP over ('data','fsdp') batches and the embed dimension, Megatron TP
# over 'tensor' on heads/mlp/vocab (the reference's table)
DEFAULT_LM_RULES: Rules = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "sequence": AXIS_CONTEXT,
    "embed": AXIS_FSDP,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "mlp": AXIS_TENSOR,
    "vocab": AXIS_TENSOR,
    "expert": AXIS_EXPERT,
    "head_dim": None,
    "layers": None,
    "norm": None,
}

SpecEntry = Optional[Union[str, Tuple[str, ...]]]


class PartitionSpec(tuple):
    """Per dimension: None (replicated), a mesh axis, or a tuple of mesh
    axes (the first major). Equal, entry for entry, to the reference's
    ``jax.sharding.PartitionSpec`` for the same mesh shape."""

    def __new__(cls, *entries: SpecEntry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_to_mesh_spec(
    logical_axes: Sequence[Optional[str]], rules: Rules, mesh: AbstractMesh
) -> PartitionSpec:
    """One parameter's logical axes -> PartitionSpec, skipping axes absent
    from the mesh or trivially sized, and never using an axis twice."""
    used = set()
    out: List[SpecEntry] = []
    for name in logical_axes:
        mesh_axis = rules.get(name) if name is not None else None
        if mesh_axis is None:
            out.append(None)
            continue
        axes = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        kept = tuple(
            a
            for a in axes
            if a in mesh.axis_names and mesh.shape[a] > 1 and a not in used
        )
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(kept)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dicts and lists (a tuple is a leaf: the
    logical axes of one parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def infer_param_sharding(logical_tree: Any, rules: Rules, mesh: AbstractMesh) -> Any:
    """A pytree of logical-axis tuples -> the same tree of PartitionSpecs."""
    return tree_map(lambda axes: logical_to_mesh_spec(axes, rules, mesh), logical_tree)


def batch_sharding(mesh: AbstractMesh, rules: Rules = DEFAULT_LM_RULES) -> PartitionSpec:
    """Spec of (batch, sequence, ...) data arrays."""
    return logical_to_mesh_spec(["batch", "sequence"], rules, mesh)


def replicated(mesh: AbstractMesh) -> PartitionSpec:
    return PartitionSpec()


def shard_tensor(full: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: each sharded dimension
    cut into as many equal blocks as its axes have ranks, the block at this
    rank's index along them. The tensor itself when ``spec`` shards nothing;
    else a copy (so the full tensor can be freed). A dimension that does
    not divide raises."""
    out = full
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if full.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {full.shape[dim]} does not divide over {axes} ({n} ranks)"
            )
        block = full.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes) * block, block)
    return out if out is full else out.clone(memory_format=torch.contiguous_format)


def gather_tensor(local: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's ``shard_tensor`` block (a
    collective over the spec's axes)."""
    out = local
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            out = collectives.all_gather(out, dim, mesh.group(axes))
    return out


def shard_params(params: Any, logical_tree: Any, rules: Rules, mesh: Mesh) -> Any:
    """Full parameters (the same on every rank, for example from
    ``ray_tpu_torch.weights.params_from_jax``) -> this rank's shards."""
    specs = infer_param_sharding(logical_tree, rules, mesh)
    return tree_map(lambda p, s: shard_tensor(p, s, mesh), params, specs)


def gather_params(local: Any, logical_tree: Any, rules: Rules, mesh: Mesh) -> Any:
    """``shard_params``'s inverse: every rank gets the full parameters."""
    specs = infer_param_sharding(logical_tree, rules, mesh)
    with torch.no_grad():
        return tree_map(lambda p, s: gather_tensor(p, s, mesh), local, specs)
