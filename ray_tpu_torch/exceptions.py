"""User-facing exception types.

Design parity: ``python/ray/exceptions.py`` — RayError hierarchy (RayTaskError
wrapping the remote traceback, RayActorError, ObjectLostError, OOM, timeouts).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


_TASK_ERROR_FIELDS = frozenset(
    ("function_name", "traceback_str", "cause", "task_id", "attempt", "node_id", "pid", "_inner")
)


class TaskError(RayTpuError):
    """A remote task raised an exception; carries the remote traceback plus
    its origin: task id, attempt number, node, and executing pid.

    Mirrors ``RayTaskError`` (python/ray/exceptions.py): re-raised at
    ``get()`` with cause chained to the user's original exception, and the
    provenance fields survive pickling (parity: RayTaskError carrying
    proctitle/pid/ip through the object store).
    """

    def __init__(
        self,
        function_name: str,
        traceback_str: str,
        cause: Exception | None = None,
        task_id: str | None = None,
        attempt: int | None = None,
        node_id: str | None = None,
        pid: int | None = None,
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.task_id = task_id
        self.attempt = attempt
        self.node_id = node_id
        self.pid = pid
        parts = [
            f"{k}={v}"
            for k, v in (("pid", pid), ("node", node_id), ("attempt", attempt))
            if v is not None
        ]
        where = f" ({', '.join(parts)})" if parts else ""
        super().__init__(f"task {function_name} failed{where}:\n{traceback_str}")

    def _provenance(self) -> tuple:
        return (self.task_id, self.attempt, self.node_id, self.pid)

    def __reduce__(self):
        return (
            TaskError,
            (self.function_name, self.traceback_str, self.cause)
            + self._provenance(),
        )

    def as_instanceof_cause(self):
        """Return an exception that is both a TaskError and the cause's type."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if cause_cls in (TaskError, ActorDiedError):
            return self
        try:
            class _Wrapped(TaskError, cause_cls):  # noqa: N801
                def __init__(self, inner):
                    self._inner = inner
                    TaskError.__init__(
                        self,
                        inner.function_name,
                        inner.traceback_str,
                        inner.cause,
                        *inner._provenance(),
                    )
                    # TaskError's message went through the cause class's
                    # __init__ and reset its fields to their defaults: take
                    # the cause's own (a shed's retry_after_s reaches the
                    # proxy's Retry-After)
                    self.__dict__.update(
                        (k, v) for k, v in vars(inner.cause).items()
                        if k not in _TASK_ERROR_FIELDS
                    )

                def __str__(self):
                    return TaskError.__str__(self._inner)

                def __reduce__(self):
                    return (
                        _rebuild_task_error,
                        (self.function_name, self.traceback_str, self.cause)
                        + self._provenance(),
                    )

            _Wrapped.__name__ = cause_cls.__name__
            _Wrapped.__qualname__ = cause_cls.__qualname__
            return _Wrapped(self)
        except TypeError:
            return self


def _rebuild_task_error(
    function_name,
    traceback_str,
    cause,
    task_id=None,
    attempt=None,
    node_id=None,
    pid=None,
):
    return TaskError(
        function_name, traceback_str, cause, task_id, attempt, node_id, pid
    ).as_instanceof_cause()


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead; pending and future calls fail with this.

    ``task_started`` is the scheduler's started-marker for the failed call:
    ``False`` means the call provably never reached a worker (still queued
    in the actor mailbox, or submitted after death) and is safe to retry;
    ``True`` means it had been dispatched for execution; ``None`` means the
    scheduler could not tell. Serve's replica failover keys off this.
    """

    def __init__(
        self,
        actor_id=None,
        reason: str = "actor died",
        task_started: bool | None = None,
    ):
        self.actor_id = actor_id
        self.reason = reason
        self.task_started = task_started
        super().__init__(reason)

    def __reduce__(self):
        # default Exception pickling would rebuild from args=(reason,),
        # shifting reason into actor_id and dropping the started-marker
        return (ActorDiedError, (self.actor_id, self.reason, self.task_started))


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object was evicted/lost and could not be reconstructed."""


class ObjectTransferStalledError(RayTpuError):
    """An in-flight inter-node transfer made no chunk progress for the
    configured window (``transfer_coverage_timeout_s``). Carries the link
    and coverage provenance so a relay stall names its transfer instead of
    surfacing as a generic fetch failure (transfer-plane observability)."""

    def __init__(
        self,
        message: str = "",
        *,
        object_id: str | None = None,
        link: str | None = None,
        covered_bytes: int | None = None,
        total_bytes: int | None = None,
        waited_s: float | None = None,
    ):
        self.object_id = object_id
        self.link = link
        self.covered_bytes = covered_bytes
        self.total_bytes = total_bytes
        self.waited_s = waited_s
        parts = [
            f"{k}={v}"
            for k, v in (
                ("object", object_id),
                ("link", link),
                ("covered", covered_bytes),
                ("total", total_bytes),
                ("waited_s", None if waited_s is None else round(waited_s, 3)),
            )
            if v is not None
        ]
        where = f" ({', '.join(parts)})" if parts else ""
        super().__init__((message or "object transfer stalled") + where)

    def __reduce__(self):
        return (
            _rebuild_transfer_stalled,
            (
                self.args[0] if self.args else "",
                self.object_id,
                self.link,
                self.covered_bytes,
                self.total_bytes,
                self.waited_s,
            ),
        )


def _rebuild_transfer_stalled(msg, object_id, link, covered, total, waited):
    err = ObjectTransferStalledError.__new__(ObjectTransferStalledError)
    RayTpuError.__init__(err, msg)
    err.object_id = object_id
    err.link = link
    err.covered_bytes = covered
    err.total_bytes = total
    err.waited_s = waited
    return err


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get()`` exceeded its timeout."""


class OutOfMemoryError(RayTpuError):
    """Task/actor was killed by the memory monitor."""


class ObjectStoreFullError(RayTpuError):
    """The object store is full and nothing could be evicted/spilled."""


class RuntimeEnvSetupError(RayTpuError):
    """Creating the runtime environment for a task/actor failed."""


class PendingCallsLimitExceeded(RayTpuError):
    """Back-pressure limit on an actor's pending call queue was reached."""


class CrossSliceTransferError(RayTpuError):
    """A device-to-device transfer across TPU slices failed (DCN path)."""


class JobAdmissionError(RayTpuError):
    """Admission control rejected the job submission (quota exceeded or
    admission queue full). The cluster never saw the job's tasks."""


class PreemptedError(RayTpuError):
    """The task's worker was killed by priority preemption; the attempt
    re-queued without spending the retry budget."""
