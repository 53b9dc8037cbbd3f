"""Typed serve data-plane errors (resilience plane).

Parity: ``python/ray/serve/exceptions.py`` (``RayServeException``,
``BackPressureError``, ``RequestCancelledError``) plus the failover
semantics of the replica scheduler: a request that provably never started
executing is transparently retried on another replica, while torn work —
a call or stream the dead replica had already begun — surfaces as a typed
:class:`ReplicaDiedError` carrying provenance so callers can decide
whether re-issuing is safe for THEIR semantics.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.exceptions import GetTimeoutError, RayTpuError


class ServeError(RayTpuError):
    """Base class for serve data-plane errors."""


class ReplicaDrainingError(ServeError):
    """The replica rejected the dispatch because it is DRAINING (graceful
    shutdown in progress). The request never entered execution, so it is
    ALWAYS safe to retry on another replica; handles and the direct proxy
    channel do so transparently."""

    def __init__(self, deployment: str = "", replica_id: str = ""):
        self.deployment = deployment
        self.replica_id = replica_id
        super().__init__(
            f"replica {replica_id[:12] or '?'} of deployment "
            f"'{deployment or '?'}' is draining"
        )

    def __reduce__(self):
        return (ReplicaDrainingError, (self.deployment, self.replica_id))


class ReplicaDiedError(ServeError):
    """The replica died under this request and the work cannot be proven
    un-started (unary call already executing, or a stream that had begun
    yielding). Carries provenance: which deployment/replica, which method,
    and whether execution had observably started (``started=True``) or the
    runtime could not tell (``started=None``)."""

    def __init__(
        self,
        deployment: str = "",
        app: str = "",
        method: str = "",
        replica_id: str = "",
        started: Optional[bool] = None,
        reason: str = "replica died",
    ):
        self.deployment = deployment
        self.app = app
        self.method = method
        self.replica_id = replica_id
        self.started = started
        self.reason = reason
        state = {True: "started", False: "unstarted", None: "unknown-progress"}[
            started if started in (True, False) else None
        ]
        super().__init__(
            f"replica {replica_id[:12] or '?'} of '{app or '?'}/"
            f"{deployment or '?'}' died under {state} request "
            f"{method or '?'}(): {reason}"
        )

    def __reduce__(self):
        return (
            ReplicaDiedError,
            (
                self.deployment,
                self.app,
                self.method,
                self.replica_id,
                self.started,
                self.reason,
            ),
        )


class DeploymentOverloadedError(ServeError):
    """Admission control shed this request: the deployment's queue bound
    (``max_ongoing_requests x replicas x shed_queue_factor``) is exceeded.
    Fast-fail instead of queueing into a guaranteed timeout; retry after
    ``retry_after_s`` (the HTTP proxy maps this to 503 + ``Retry-After``)."""

    def __init__(
        self,
        deployment: str = "",
        retry_after_s: float = 1.0,
        load: int = 0,
        capacity: int = 0,
    ):
        self.deployment = deployment
        self.retry_after_s = retry_after_s
        self.load = load
        self.capacity = capacity
        super().__init__(
            f"deployment '{deployment or '?'}' is overloaded "
            f"(load {load} >= capacity {capacity}); retry in {retry_after_s:g}s"
        )

    def __reduce__(self):
        return (
            DeploymentOverloadedError,
            (self.deployment, self.retry_after_s, self.load, self.capacity),
        )


class RequestTimeoutError(ServeError, GetTimeoutError):
    """A serve request (or one item of a streaming response) exceeded its
    timeout. Subclasses :class:`GetTimeoutError` so existing callers that
    catch the generic get-timeout keep working."""

    def __init__(self, deployment: str = "", method: str = "", timeout_s: float = 0.0):
        self.deployment = deployment
        self.method = method
        self.timeout_s = timeout_s
        super().__init__(
            f"request {method or '?'}() to deployment '{deployment or '?'}' "
            f"timed out after {timeout_s:g}s"
        )

    def __reduce__(self):
        return (RequestTimeoutError, (self.deployment, self.method, self.timeout_s))


class ControllerUnavailableError(ServeError):
    """The serve controller is (temporarily) unreachable. Data-plane
    handles keep routing to their cached replica set meanwhile."""
