"""Device mesh over the canonical axes, one process and one device per rank.

Port of ``ray_tpu/parallel/mesh.py``. The canonical axes (scaling-book
convention):

* ``data``     — batch (pure DP: gradients all-reduced)
* ``fsdp``     — batch + parameter sharding (ZeRO-3: gathered per layer)
* ``tensor``   — within-layer model parallelism (Megatron)
* ``context``  — sequence/context parallelism (ring attention)
* ``expert``   — MoE expert parallelism
* ``pipeline`` — pipeline stages

The reference's mesh is a grid of devices that one jitted program spans;
XLA inserts the collectives. Here every rank is one process driving one
device (``cuda:{local_rank}`` with NCCL, or the CPU with gloo), and the
mesh is the rank's coordinates on the grid plus one process group per set
of non-trivial axes, over which the port's explicit collectives run
(``ray_tpu_torch.parallel.collectives``). Ranks fill the grid in row-major
order over ``CANONICAL_ORDER``, so ``tensor`` is innermost: neighbouring
ranks (the GPUs of one NVLink host) share a tensor group.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_CONTEXT = "context"
AXIS_EXPERT = "expert"
AXIS_PIPELINE = "pipeline"

# the axes that want the most bandwidth (tensor, context) innermost
CANONICAL_ORDER = (
    AXIS_PIPELINE,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_CONTEXT,
    AXIS_TENSOR,
)

Axes = Union[str, Sequence[str]]


@dataclass
class MeshConfig:
    """Axis sizes; -1 on at most one axis means "use remaining devices"."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    context: int = 1
    expert: int = 1
    pipeline: int = 1

    def sizes(self) -> Dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_FSDP: self.fsdp,
            AXIS_TENSOR: self.tensor,
            AXIS_CONTEXT: self.context,
            AXIS_EXPERT: self.expert,
            AXIS_PIPELINE: self.pipeline,
        }

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = self.sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {n_devices}"
            )
        return sizes


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class AbstractMesh:
    """Axis names and sizes without ranks or groups: what sharding specs
    are computed from (the reference's ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in _as_axes(axes))


class LocalMesh(AbstractMesh):
    """No mesh: one device, no axes, no groups (the model without a mesh
    runs as a sharded one over this, its collectives all no-ops)."""

    def __init__(self):
        super().__init__({})

    def axis_index(self, axes: Axes) -> int:
        return 0

    def group(self, axes: Axes) -> None:
        return None


class Mesh(AbstractMesh):
    """This rank's place on the mesh, and a process group per set of its
    non-trivial axes.

    ``axis_names`` and ``shape`` (name -> size) read as the reference's
    ``jax.sharding.Mesh``. ``group(axes)`` is the process group of the
    ranks that differ from this one only along ``axes`` (ordered by their
    index along ``axes``, the first axis major), or None when that group
    is this rank alone: collectives over it are no-ops.
    """

    def __init__(self, sizes: Dict[str, int], names: Sequence[str], device: torch.device):
        super().__init__({a: sizes[a] for a in names})
        self.device = device
        self.rank = dist.get_rank()
        if self.size != dist.get_world_size():
            raise ValueError(
                f"mesh of {self.size} ranks over a world of {dist.get_world_size()} processes"
            )
        dims = [self.shape[a] for a in self.axis_names]
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, dims)))
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        live = [a for a in self.axis_names if self.shape[a] > 1]
        # every rank creates every group, in one order (torch requires it)
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                self._groups[axes] = self._new_group(axes)

    def _new_group(self, axes: Tuple[str, ...]) -> dist.ProcessGroup:
        if math.prod(self.shape[a] for a in axes) == self.size:
            return dist.group.WORLD
        others = [a for a in self.axis_names if a not in axes]
        dims = [self.shape[a] for a in self.axis_names]
        groups = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            coords = dict(zip(others, fixed))
            ranks = []
            for inner in itertools.product(*(range(self.shape[a]) for a in axes)):
                coords.update(zip(axes, inner))
                ranks.append(_ravel([coords[a] for a in self.axis_names], dims))
            groups.append(ranks)
        mine, _ = dist.new_subgroups_by_enumeration(groups)
        return mine

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (the first axis major)."""
        index = 0
        for a in _as_axes(axes):
            index = index * self.shape.get(a, 1) + self.coords.get(a, 0)
        return index

    def group(self, axes: Axes) -> Optional[dist.ProcessGroup]:
        live = tuple(a for a in CANONICAL_ORDER if a in _as_axes(axes) and self.shape.get(a, 1) > 1)
        if not live:
            return None
        given = [a for a in _as_axes(axes) if a in live]
        if given != list(live):
            raise ValueError(f"axes {tuple(axes)} are not in the canonical order {CANONICAL_ORDER}")
        return self._groups[live]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _unravel(index: int, dims: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for d in reversed(dims):
        out.append(index % d)
        index //= d
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], dims: Sequence[int]) -> int:
    index = 0
    for c, d in zip(coords, dims):
        index = index * d + c
    return index


def create_mesh(
    config: Optional[MeshConfig] = None,
    *,
    drop_trivial_axes: bool = False,
    **axis_sizes: int,
) -> Mesh:
    """The mesh over the ranks of the initialized process group
    (``ray_tpu_torch.parallel.distributed.initialize``), its axes in
    ``CANONICAL_ORDER``.

    ``create_mesh(data=-1, tensor=4)`` puts tensor=4 innermost and all
    remaining ranks on data. A mesh whose size is not the world size
    raises, as the reference's ``resolve`` does. Every rank calls it with
    the same arguments (it creates the groups).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs a process group: call "
            "ray_tpu_torch.parallel.distributed.initialize(...) on every rank first"
        )
    if config is None:
        for k in axis_sizes:
            if k not in MeshConfig().sizes():
                raise ValueError(f"unknown mesh axis {k}")
        config = MeshConfig(**{k: axis_sizes.get(k, 1) for k in MeshConfig().sizes()})
    from ray_tpu_torch.parallel.distributed import device as rank_device

    sizes = config.resolve(dist.get_world_size())
    names = [a for a in CANONICAL_ORDER if not (drop_trivial_axes and sizes[a] == 1)]
    if math.prod(sizes[a] for a in names) != dist.get_world_size():
        # all axes trivial-dropped but ranks remain
        names, sizes = [AXIS_DATA], {AXIS_DATA: dist.get_world_size()}
    return Mesh(sizes, names, rank_device())


def pod_chip_count(pod_type: str) -> int:
    """Total chips in a pod slice, e.g. v5litepod-64 -> 64 (a copy of
    ``ray_tpu/_private/accelerators/tpu.py:63``); 0 when the name has no
    count."""
    try:
        return int(pod_type.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return 0


def mesh_from_pod_type(pod_type: str, config: Optional[MeshConfig] = None) -> Mesh:
    """Mesh for a full pod slice, e.g. ``v5litepod-64`` -> a 64-rank mesh
    (``data=-1`` unless ``config`` says otherwise). Checks that the ranks of
    the initialized process group actually form the named slice."""
    want = pod_chip_count(pod_type)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if want and world != want:
        raise ValueError(
            f"pod type {pod_type} has {want} chips but the process group has {world} "
            f"ranks. Every rank must join the group first: use ScalingConfig("
            f"use_torch_distributed=True) in DataParallelTrainer, or call "
            f"ray_tpu_torch.parallel.distributed.initialize(coord, n_procs, rank) "
            f"directly; afterwards the group's ranks are the global set."
        )
    return create_mesh(config or MeshConfig(data=-1))


def local_device_count() -> int:
    """CUDA devices visible to this process."""
    return torch.cuda.device_count()
