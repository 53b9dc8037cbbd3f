"""Typed serve data-plane errors: the port's own copy of the one it needs.

``DeploymentOverloadedError`` has the reference's name and fields
(``ray_tpu/serve/exceptions.py``), over a base class of its own.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for serve data-plane errors."""


class DeploymentOverloadedError(ServeError):
    """Admission control shed this request: the deployment cannot take it
    now. Fast-fail instead of queueing into a guaranteed timeout; retry
    after ``retry_after_s``."""

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
