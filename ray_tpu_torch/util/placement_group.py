"""Placement groups: gang scheduling of resource bundles.

Parity: ``python/ray/util/placement_group.py:145`` +
``gcs_placement_group_manager.h:230`` (2PC bundle reservation) — strategies
PACK / SPREAD / STRICT_PACK / STRICT_SPREAD. The TPU extension: a bundle list
may be generated from a slice topology so one PG == one ICI-connected slice
(see ``ray_tpu_torch.util.tpu_pod``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.ids import PlacementGroupID, pg_ready_sentinel
from ray_tpu_torch._private.scheduler import PlacementGroupState
from ray_tpu_torch._private.worker import ObjectRef, get_runtime


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    def ready(self) -> ObjectRef:
        """An ObjectRef resolving when the PG is placed (parity: ``pg.ready()``).

        The scheduler commits a sentinel object the moment the 2PC placement
        commits, so this is push-notified, not probe-polled."""
        return ObjectRef(pg_ready_sentinel(self.id))

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        rt = get_runtime()
        ready, _ = rt.wait([pg_ready_sentinel(self.id)], 1, timeout_seconds)
        return bool(ready)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid strategy {strategy}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    rt = get_runtime()
    pg_id = PlacementGroupID.from_random()
    state = PlacementGroupState(
        pg_id=pg_id,
        bundles=[{k: float(v) for k, v in b.items()} for b in bundles],
        strategy=strategy,
        name=name,
    )
    if hasattr(rt, "scheduler"):
        rt.scheduler.post(("create_pg", state))
    else:
        rt._send(("cmd", ("create_pg", state)))
    return PlacementGroup(pg_id, state.bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    rt = get_runtime()
    if hasattr(rt, "scheduler"):
        rt.scheduler.post(("remove_pg", pg.id))
    else:
        rt._send(("cmd", ("remove_pg", pg.id)))


def placement_group_table() -> dict:
    rt = get_runtime()
    if not hasattr(rt, "scheduler"):
        raise RuntimeError("driver only")
    out = {}
    for pg_id, st in rt.scheduler.placement_groups.items():
        out[pg_id.hex()] = {
            "state": st.state,
            "strategy": st.strategy,
            "bundles": st.bundles,
            "name": st.name,
        }
    return out
