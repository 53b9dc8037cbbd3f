"""Binary IDs for the runtime.

Design parity: the reference uses 28-byte binary ids with structured encoding
(``src/ray/common/id.h:1``, spec in ``src/ray/design_docs/id_specification.md``):
JobID(4) < ActorID(16) < TaskID(24) < ObjectID(28), where an ObjectID embeds the
TaskID of its creating task plus a put/return index, and a TaskID embeds the
ActorID/JobID. We keep the same nesting so ownership and lineage can be derived
from an id alone, but sizes are natively chosen (no protobuf wire constraint).
"""

from __future__ import annotations

import os
import threading

JOB_ID_SIZE = 4
ACTOR_UNIQUE_SIZE = 12
ACTOR_ID_SIZE = ACTOR_UNIQUE_SIZE + JOB_ID_SIZE  # 16
TASK_UNIQUE_SIZE = 8
TASK_ID_SIZE = TASK_UNIQUE_SIZE + ACTOR_ID_SIZE  # 24
OBJECT_INDEX_SIZE = 4
OBJECT_ID_SIZE = TASK_ID_SIZE + OBJECT_INDEX_SIZE  # 28
NODE_ID_SIZE = 28
WORKER_ID_SIZE = 28
PLACEMENT_GROUP_ID_SIZE = 16


class BaseID:
    """Immutable binary id; hashable, comparable, hex-printable."""

    SIZE = 0
    __slots__ = ("_bin", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {self.SIZE} bytes, got {len(binary)}"
            )
        self._bin = bytes(binary)
        self._hash = hash(self._bin)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bin == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __lt__(self, other):
        return self._bin < other._bin

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bin,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int):
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int(self) -> int:
        return int.from_bytes(self._bin, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(ACTOR_UNIQUE_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bin[ACTOR_UNIQUE_SIZE:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, actor_id: ActorID):
        return cls(os.urandom(TASK_UNIQUE_SIZE) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID):
        return cls.for_task(ActorID(b"\x00" * ACTOR_UNIQUE_SIZE + job_id.binary()))

    def actor_id(self) -> ActorID:
        return ActorID(self._bin[TASK_UNIQUE_SIZE:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """ObjectID = TaskID of creating task + little-endian index.

    Index 0..N-1 are task returns; put objects use a per-task put counter offset
    by 2**31 (mirrors the reference's return/put index split).
    """

    SIZE = OBJECT_ID_SIZE
    PUT_INDEX_OFFSET = 1 << 31

    @classmethod
    def for_return(cls, task_id: TaskID, index: int):
        return cls(task_id.binary() + index.to_bytes(OBJECT_INDEX_SIZE, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        return cls.for_return(task_id, cls.PUT_INDEX_OFFSET + put_index)

    def task_id(self) -> TaskID:
        return TaskID(self._bin[:TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bin[TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return self.index() >= self.PUT_INDEX_OFFSET


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


# just below the put-index region: not a plausible return index (returns are
# small) and below PUT_INDEX_OFFSET so is_put() stays False for sentinels
_PG_SENTINEL_INDEX = ObjectID.PUT_INDEX_OFFSET - 1


def pg_ready_sentinel(pg_id: PlacementGroupID) -> ObjectID:
    """Deterministic object id committed when a placement group is placed.

    Lets ``pg.ready()/wait()`` ride the ordinary object-readiness plane
    (push notification) instead of probe-polling the control plane."""
    padded = pg_id.binary().ljust(TASK_ID_SIZE, b"\x9d")
    return ObjectID(padded + _PG_SENTINEL_INDEX.to_bytes(OBJECT_INDEX_SIZE, "little"))


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, start: int = 0):
        self._v = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v
