"""Wire-level task description and control messages.

Design parity: ``TaskSpecification`` (``src/ray/common/task/``) — function
descriptor, args (inline values or object refs), resource demand, scheduling
strategy, retry policy; actor creation/call specs share the struct. Messages
between driver/scheduler/workers are tagged tuples serialized with pickle over
OS pipes (the reference uses gRPC protos; single-host transport here is a pipe,
the multi-host transport rides the same structs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclass
class Arg:
    """One task argument: exactly one of value/object_id set."""

    value: Any = None
    object_id: Optional[ObjectID] = None
    is_ref: bool = False

    # tuple state: args ride every task message — skip the per-instance
    # __dict__ that default dataclass pickling emits
    def __getstate__(self):
        return (self.value, self.object_id, self.is_ref)

    def __setstate__(self, state):
        self.value, self.object_id, self.is_ref = state


@dataclass
class SchedulingStrategy:
    """DEFAULT | SPREAD | node-affinity | placement group bundle."""

    kind: str = "DEFAULT"
    node_id: Optional[str] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1


@dataclass
class TaskSpec:
    task_id: TaskID
    task_type: TaskType
    function: Any  # pickled callable descriptor (bytes) or (module, name)
    args: List[Arg]
    kwargs: Dict[str, Arg]
    num_returns: int
    resources: Dict[str, float]
    name: str = ""
    actor_id: Optional[ActorID] = None
    # actor creation only:
    # resources held for the actor's lifetime (creation demand is `resources`;
    # parity: Ray actors take 1 CPU to schedule, 0 while running unless
    # explicitly requested)
    lifetime_resources: Optional[Dict[str, float]] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    # detached actors outlive their handles (reaped only via kill)
    detached: bool = False
    # default retry budget for this actor's method calls on actor restart
    max_task_retries: int = 0
    # retries
    max_retries: int = 0
    # False | True (retry any app exception) | list of exception types
    retry_exceptions: Any = False
    # scheduling
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Optional[dict] = None
    # streaming generator
    is_streaming: bool = False
    # tracing plane: the task's own (trace_id, span_id, parent_id), minted
    # at submission (util/tracing.for_submission) so head-side lifecycle
    # events and worker-side execution events share one span; None=untraced.
    # A dedicated field (not the runtime_env side channel) so tracing never
    # forces the runtime-env apply path in the worker.
    trace_ctx: Optional[Tuple[str, str, Optional[str]]] = None

    # positional state (see Arg): specs are the bulk of control-plane bytes
    _STATE_FIELDS = (
        "task_id",
        "task_type",
        "function",
        "args",
        "kwargs",
        "num_returns",
        "resources",
        "name",
        "actor_id",
        "lifetime_resources",
        "max_restarts",
        "max_concurrency",
        "actor_name",
        "namespace",
        "detached",
        "max_task_retries",
        "max_retries",
        "retry_exceptions",
        "scheduling_strategy",
        "runtime_env",
        "is_streaming",
        # appended last: blobs pickled by older builds unpickle with
        # trace_ctx falling back to the class default (None)
        "trace_ctx",
    )

    def __getstate__(self):
        return tuple(getattr(self, f) for f in self._STATE_FIELDS)

    def __setstate__(self, state):
        for f, v in zip(self._STATE_FIELDS, state):
            setattr(self, f, v)

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_return(self.task_id, i) for i in range(self.num_returns)]

    def arg_ref_ids(self) -> List[ObjectID]:
        return [
            a.object_id
            for a in list(self.args) + list(self.kwargs.values())
            if a.is_ref and a.object_id is not None
        ]
