"""Runtime context. Parity: ``python/ray/runtime_context.py``
(``ray.get_runtime_context()``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch._private import worker as _worker


@dataclass
class RuntimeContext:
    job_id: Optional[str]
    node_id: Optional[str]
    worker_id: Optional[str]
    actor_id: Optional[str]
    task_id: Optional[str]
    accelerator_ids: Optional[dict] = None

    def get_job_id(self):
        return self.job_id

    def get_node_id(self):
        return self.node_id

    def get_actor_id(self):
        return self.actor_id

    def get_task_id(self):
        return self.task_id

    def get_worker_id(self):
        return self.worker_id

    def get_accelerator_ids(self) -> dict:
        """Device instances assigned to the current task (parity:
        ``RuntimeContext.get_accelerator_ids``): ``{"GPU": ["0", "1"]}``.
        Empty lists when the task requested no indexed resources."""
        out = {"GPU": []}
        for name, alloc in (self.accelerator_ids or {}).items():
            out[name] = [str(i) for i, _ in alloc]
        return out


def get_runtime_context() -> RuntimeContext:
    rt = _worker.get_runtime()
    if hasattr(rt, "scheduler"):  # driver
        return RuntimeContext(
            job_id=rt.job_id.hex(),
            node_id=rt.node.head_node_id.hex(),
            worker_id=None,
            actor_id=None,
            task_id=rt.task_id.hex(),
        )
    tid = rt.current_task_id
    actor = rt._actor_id
    return RuntimeContext(
        job_id=tid.job_id().hex() if tid else None,
        node_id=None,
        worker_id=rt.worker_id.hex(),
        actor_id=actor.hex() if actor else None,
        task_id=tid.hex() if tid else None,
        accelerator_ids=getattr(rt, "_accel_alloc", None),
    )
