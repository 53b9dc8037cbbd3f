"""Distributed trace-context propagation across task/actor boundaries.

Parity: ``python/ray/util/tracing/tracing_helper.py`` (``:34``,
``_DictPropagator:165``) — the caller's span context travels with every task
spec and is adopted in the executing worker, so spans form one tree across
processes. The reference delegates to OpenTelemetry; this environment has no
OTel package, so the context model (16-byte trace id, 8-byte span ids,
parent links) is implemented natively.

Tracing-plane extension beyond the reference helper: a ``(trace_id,
span_id)`` is minted at every ENTRY POINT — driver ``remote()`` calls, serve
proxy requests, job submissions — and each task/actor call gets its span id
assigned at SUBMISSION time (``for_submission``), so the scheduler's
head-side lifecycle events and the executing worker's events land on the
SAME span. Nested submissions become children of the executing task's span.
The default is governed by the ``tracing_enabled`` config flag (on);
``enable_tracing``/``disable_tracing`` override per process.

The resulting span tree is queried with ``ray_tpu_torch.trace(trace_id)`` /
``ray_tpu_torch trace <id>`` (see ``ray_tpu_torch._private.trace``).
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_CTX_KEY = "_trace_ctx"

# None = follow the runtime config (tracing_enabled, default on);
# True/False = explicit per-process override via enable/disable_tracing()
_enabled_override: Optional[bool] = None
_local = threading.local()

# id minting: urandom-seeded per-process PRNG — ~5x cheaper than os.urandom
# per call. Fork safety via os.register_at_fork (no per-call getpid syscall
# or lock on the submission hot path); getrandbits itself is GIL-atomic
_rng = random.Random(os.urandom(16))
try:
    os.register_at_fork(after_in_child=lambda: _rng.seed(os.urandom(16)))
except AttributeError:  # non-posix: spawn re-imports the module anyway
    pass
_randbits = _rng.getrandbits


def _ids(nbits: int) -> str:
    return "%0*x" % (nbits // 4, _randbits(nbits))


@dataclass
class TraceContext:
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars
    parent_id: Optional[str] = None
    # verbose = explicit-tracing mode (enable_tracing()): workers record a
    # per-task PROFILE wrapper span for chrome-timeline flow links. The
    # default-on plane leaves it False — lifecycle events carry the span
    # ids, sparing one telemetry span per task on the hot path. Inherited
    # by nested submissions so a whole traced call tree stays verbose.
    verbose: bool = False

    def to_dict(self) -> Dict[str, str]:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "TraceContext":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"))

    def to_tuple(self):
        if self.verbose:
            return (self.trace_id, self.span_id, self.parent_id, True)
        return (self.trace_id, self.span_id, self.parent_id)

    @classmethod
    def from_tuple(cls, t) -> "TraceContext":
        return cls(
            t[0],
            t[1],
            t[2] if len(t) > 2 else None,
            bool(t[3]) if len(t) > 3 else False,
        )


def enable_tracing() -> None:
    """Parity: ``ray start --tracing-startup-hook`` turning span export on.
    Overrides the ``tracing_enabled`` config flag in this process."""
    global _enabled_override
    _enabled_override = True


def disable_tracing() -> None:
    global _enabled_override
    _enabled_override = False


def reset_tracing() -> None:
    """Back to config-driven behavior (tests)."""
    global _enabled_override
    _enabled_override = None


# (runtime identity, resolved flag): the config is immutable per runtime,
# so the lookup chain runs once per connect, not per remote() call
_enabled_cache: Tuple[Optional[object], bool] = (None, False)


def tracing_enabled() -> bool:
    global _enabled_cache
    if _enabled_override is not None:
        return _enabled_override
    # config default: tracing rides the telemetry plane, so an unconnected
    # process (or telemetry off) reads as disabled
    try:
        from ray_tpu_torch._private import worker as worker_mod

        rt = worker_mod._worker_runtime or worker_mod._driver
        if rt is None:
            return False
        cached_rt, val = _enabled_cache
        if rt is cached_rt:
            return val
        cfg = getattr(rt, "config", None)
        val = bool(getattr(cfg, "tracing_enabled", True)) and bool(
            getattr(cfg, "telemetry_enabled", True)
        )
        _enabled_cache = (rt, val)
        return val
    except Exception:
        return False


def get_current_context() -> Optional[TraceContext]:
    return getattr(_local, "ctx", None)


def _set_current_context(ctx: Optional[TraceContext]) -> None:
    _local.ctx = ctx


def _new_id(nbytes: int) -> str:
    return _ids(nbytes * 8)


def new_root() -> TraceContext:
    """A fresh root span (new trace id, no parent)."""
    return TraceContext(trace_id=_ids(128), span_id=_ids(64))


def start_span() -> TraceContext:
    """Begin a span under the current context (new trace if none) and make
    it current. Legacy surface — entry points prefer ``activate``/``scope``."""
    cur = get_current_context()
    if cur is None:
        ctx = new_root()
        ctx.verbose = _enabled_override is True
    else:
        ctx = TraceContext(
            trace_id=cur.trace_id,
            span_id=_ids(64),
            parent_id=cur.span_id,
            verbose=cur.verbose or _enabled_override is True,
        )
    _set_current_context(ctx)
    return ctx


def for_submission():
    """The submitted task's OWN context, minted at the call site so the
    scheduler's head-side events and the worker's execution events share one
    span id. Child of the caller's active span; a fresh root when this
    process has no active context and tracing is enabled; ``None`` (untraced
    task) otherwise. Does NOT change the caller's current context.

    Returns a compact ``(trace_id, span_id, parent_id)`` tuple for
    ``TaskSpec.trace_ctx`` (None when untraced).
    """
    cur = get_current_context()
    if cur is not None:
        # an active context propagates even in processes that never enabled
        # tracing — workers executing a traced task must keep the chain for
        # nested submissions (the reference achieves this via a cluster-wide
        # tracing startup hook on every worker)
        if cur.verbose or _enabled_override is True:
            return (cur.trace_id, _ids(64), cur.span_id, True)
        return (cur.trace_id, _ids(64), cur.span_id)
    if not tracing_enabled():
        return None
    if _enabled_override is True:
        return (_ids(128), _ids(64), None, True)
    return (_ids(128), _ids(64), None)


def activate(ctx: Optional[TraceContext]) -> None:
    """Make ``ctx`` the calling thread's current context."""
    _set_current_context(ctx)


def activate_from_spec(spec) -> Optional[TraceContext]:
    """Executing-worker side: adopt the task's submission-minted span as the
    current context (nested submissions become its children). Falls back to
    the legacy runtime_env side channel (older callers / user-injected
    contexts), where a child span is minted as before."""
    t = getattr(spec, "trace_ctx", None)
    if t is not None:
        ctx = TraceContext.from_tuple(t)
        _set_current_context(ctx)
        return ctx
    return extract_and_activate(getattr(spec, "runtime_env", None))


class scope:
    """``with tracing.scope(ctx):`` — activate a context for a block,
    restoring the previous one on exit (serve proxy / direct-plane server
    threads handle many requests on one thread)."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev: Optional[TraceContext] = None

    def __enter__(self):
        self._prev = get_current_context()
        _set_current_context(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        # only restore when this thread still holds the context we set: a
        # generator-held scope can be closed (GC) from a DIFFERENT thread,
        # and blindly restoring would clobber that thread's live context
        if get_current_context() is self._ctx:
            _set_current_context(self._prev)
        return False


def inject(runtime_env: Optional[dict]) -> Optional[dict]:
    """Attach the caller's context to an outgoing task spec via the
    runtime_env side channel (legacy path; new callers set
    ``TaskSpec.trace_ctx`` from :func:`for_submission` instead — the side
    channel forces the runtime-env apply path in the worker).

    Parity: ``_DictPropagator.inject_current_context``.
    """
    ctx = get_current_context()
    if ctx is None:
        if _enabled_override is not True:
            return runtime_env
        ctx = start_span()
    out = dict(runtime_env or {})
    out[_CTX_KEY] = ctx.to_dict()
    return out


def extract_and_activate(runtime_env: Optional[dict]) -> Optional[TraceContext]:
    """Legacy executing-worker side: adopt the caller's context as parent and
    open a child span for this task. Returns the new context (None if
    untraced)."""
    if not runtime_env or _CTX_KEY not in runtime_env:
        return None
    parent = TraceContext.from_dict(runtime_env[_CTX_KEY])
    child = TraceContext(
        trace_id=parent.trace_id,
        span_id=_ids(64),
        parent_id=parent.span_id,
        verbose=True,  # the side channel IS the legacy explicit-tracing path
    )
    _set_current_context(child)
    return child


def deactivate() -> None:
    _set_current_context(None)


def current_trace_id() -> Optional[str]:
    """The active trace id (e.g. to log alongside an external request id)."""
    ctx = get_current_context()
    return ctx.trace_id if ctx is not None else None


def context_args() -> Dict[str, str]:
    """The active context as chrome-trace/span args ({} when untraced) —
    the telemetry plane stamps these onto profile spans so timeline
    consumers can rebuild the parent-linked tree across processes."""
    ctx = get_current_context()
    return ctx.to_dict() if ctx is not None else {}
