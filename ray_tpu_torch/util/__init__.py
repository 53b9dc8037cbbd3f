"""Utility APIs. Parity: ``python/ray/util/``."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
]
