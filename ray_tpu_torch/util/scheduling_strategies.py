"""User-facing scheduling strategies.

Parity: ``python/ray/util/scheduling_strategies.py`` — PlacementGroup /
NodeAffinity / Spread strategies passed via ``.options(scheduling_strategy=)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch._private.task_spec import SchedulingStrategy as _Internal


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"  # noqa: F821
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_internal(self) -> _Internal:
        return _Internal(
            kind="PLACEMENT_GROUP",
            placement_group_id=self.placement_group.id,
            bundle_index=self.placement_group_bundle_index,
        )


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def to_internal(self) -> _Internal:
        return _Internal(kind="NODE_AFFINITY", node_id=self.node_id, soft=self.soft)


@dataclass
class SpreadSchedulingStrategy:
    def to_internal(self) -> _Internal:
        return _Internal(kind="SPREAD")


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"
