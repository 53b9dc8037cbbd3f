"""The core runtime's public functions: tasks, actors, objects and the cluster
view (``init``, ``remote``, ``get``, ``put``, ``wait``, ...), re-exported by
``ray_tpu_torch``. The same API as the JAX package's ``ray_tpu/__init__.py``
(parity: ``python/ray/_private/worker.py:1225,2576,2691,2756``), on the
port's own runtime (``ray_tpu_torch._private``), whose worker processes
import torch and nothing of JAX.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.worker import ObjectRef, get_runtime
from ray_tpu_torch.actor import ActorClass
from ray_tpu_torch.remote_function import RemoteFunction


def init(**kwargs):
    """Start the runtime on this host (parity: ``ray.init``): a local node
    whose ``GPU`` resource is the count of NVIDIA GPUs detected without
    initialising CUDA. ``address=`` (attaching to a cluster) raises
    ``NotImplementedError``: the cluster daemons are a later slice."""
    return _worker.init(**kwargs)


def shutdown():
    _worker.shutdown()


def remote(*args, **options):
    """Decorator turning a function into a remote task / class into an actor."""

    def decorate(obj):
        import inspect

        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and not options and (callable(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return decorate


def method(num_returns: int = 1):
    """Decorator recording per-method defaults (parity: ``ray.method``)."""

    def decorate(m):
        m.__ray_num_returns__ = num_returns
        return m

    return decorate


def job_scope(
    *,
    name: str = "",
    priority: int = 0,
    weight: float = 1.0,
    quota=None,
    meta=None,
):
    """Run a block of submissions as a distinct tenant of the multi-tenant
    job plane: tasks, actors, and puts created inside the ``with`` block
    are arbitrated (weighted-fair queueing), quota-capped, and
    priority-ranked under one job. ``quota`` caps live usage per resource
    (plus the ``object_store_bytes`` pseudo-resource); ``priority`` feeds
    preemption and admission ordering. Raises
    ``exceptions.JobAdmissionError`` if admission control rejects the
    submission outright."""
    return get_runtime().job_scope(
        name=name, priority=priority, weight=weight, quota=quota, meta=meta
    )


def put(value: Any) -> ObjectRef:
    rt = get_runtime()
    return ObjectRef(rt.put(value), _owned=True)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    rt = get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get_objects([refs.id()], timeout=timeout)[0]
    from ray_tpu_torch.dag import CompiledDAGRef

    if isinstance(refs, CompiledDAGRef):
        # parity: ray.get accepts compiled-DAG result refs
        return refs.get(timeout)
    if isinstance(refs, (list, tuple)):
        if not refs:
            return []
        if all(isinstance(r, CompiledDAGRef) for r in refs):
            return [r.get(timeout) for r in refs]
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("get() accepts an ObjectRef or a list of ObjectRefs")
        return rt.get_objects([r.id() for r in refs], timeout=timeout)
    raise TypeError(f"get() got {type(refs)}")


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> tuple:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    rt = get_runtime()
    id_to_ref = {r.id(): r for r in refs}
    ready_ids, not_ready_ids = rt.wait(
        [r.id() for r in refs], num_returns=num_returns, timeout=timeout
    )
    return [id_to_ref[i] for i in ready_ids], [id_to_ref[i] for i in not_ready_ids]


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    rt = get_runtime()
    task_id = ref.id().task_id()
    if hasattr(rt, "scheduler"):
        rt.scheduler.post(("cancel", task_id, force))
    else:
        rt._send(("cmd", ("cancel", task_id, force)))


def nodes() -> List[dict]:
    """Parity: ``ray.nodes()``."""
    rt = get_runtime()
    if hasattr(rt, "scheduler"):
        return rt.scheduler_rpc("list_nodes", ())
    return rt.rpc("list_nodes")


def cluster_resources() -> dict:
    total: dict = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n["total"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> dict:
    total: dict = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n["available"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace task events. Parity: ``ray.timeline(filename=...)``
    (``python/ray/_private/state.py:944``).

    Forces a cluster-wide telemetry flush first (read-your-writes despite
    the batched pipeline), then renders the merged event log as a
    chrome://tracing array: per-task lifecycle phase spans
    (SUBMITTED/QUEUED/DISPATCHED/RUNNING/FINISHED‑or‑FAILED), profile
    spans with trace-context parent links (one tree across processes),
    and stable per-task tids. With ``filename`` the JSON array is also
    written to disk, ready to load into chrome://tracing or Perfetto.
    """
    rt = get_runtime()
    if not hasattr(rt, "scheduler"):
        raise RuntimeError("timeline() is driver-only")
    from ray_tpu_torch._private import telemetry as _telemetry

    _telemetry.flush()
    rt.scheduler.request_telemetry_flush()
    # read via the loop-serialized rpc: the loop appends telemetry batches
    # concurrently, and list(deque) from this thread could see a mutation
    events = rt.scheduler_rpc("task_events", ())
    trace = _telemetry.build_chrome_trace(events)
    if filename:
        import json as _json

        with open(filename, "w") as fh:
            _json.dump(trace, fh)
    return trace


def _sched_rpc(op: str, *args):
    """One scheduler rpc, in-process driver or remote-attached alike (the
    single place the runtime-dispatch fallback lives)."""
    rt = get_runtime()
    if hasattr(rt, "scheduler_rpc"):
        return rt.scheduler_rpc(op, args)
    return rt.rpc(op, *args)


def _traced_rpc(op: str, *args):
    """Flush telemetry cluster-wide (read-your-writes), then run a
    scheduler rpc."""
    rt = get_runtime()
    from ray_tpu_torch._private import telemetry as _telemetry

    _telemetry.flush()
    scheduler = getattr(rt, "scheduler", None)
    if scheduler is not None:
        scheduler.request_telemetry_flush()
    return _sched_rpc(op, *args)


def trace(trace_id: str):
    """Reconstruct one request's cross-process span tree and critical-path
    latency decomposition (submit -> queue_wait -> dispatch -> arg_fetch ->
    execute -> result_put -> stream_yield; serve spans included).

    ``trace_id`` comes from :func:`recent_traces`, the
    ``x-raytpu-trace-id`` serve response header,
    ``ray_tpu_torch.util.tracing.current_trace_id()``, or a latency exemplar.
    Returns a :class:`ray_tpu_torch._private.trace.Trace`; print
    ``.summary()`` or inspect ``.to_dict()``.
    """
    from ray_tpu_torch._private.trace import build_trace

    trace_id = str(trace_id)
    events = _traced_rpc("trace_events", trace_id)
    return build_trace(events, trace_id)


def recent_traces(limit: int = 100) -> List[dict]:
    """Digests of recently-seen traces, newest first: ``{trace_id,
    first_time, last_time, root, events}``. Reads the scheduler's index
    directly — no cluster-wide flush fan-out (the dashboard polls this
    every couple of seconds; only per-trace event reads need
    read-your-writes)."""
    from ray_tpu_torch._private import telemetry as _telemetry

    _telemetry.flush()  # local buffer only: direct-call submission anchors
    return _sched_rpc("list_traces", int(limit))


def train_timeline(run: str, max_steps: Optional[int] = None):
    """One training run's step-time attribution — "where did the step go".

    Returns a :class:`ray_tpu_torch._private.stepplane.TrainTimeline`: per-rank
    step records decomposed into data_wait -> host_to_device -> compile ->
    compute -> collective_wait (with the straggler rank) ->
    checkpoint_stall -> other, run-level stage shares, per-operator ingest
    stalls, recompile flags, and the goodput downtime ledger attributed by
    cause. Print ``.summary()`` for the per-rank step waterfall or inspect
    ``.to_dict()``. ``run`` is the RunConfig name (see
    ``state.list_train_runs()``)."""
    from ray_tpu_torch._private.stepplane import TrainTimeline

    data = _traced_rpc("train_run", str(run), max_steps)
    return TrainTimeline(data or {})


def request_profile(hz: float = 99.0, duration_s: float = 10.0) -> int:
    """Boost the continuous sampling profiler cluster-wide for a bounded
    window (on top of the steady-state ``profiler_hz``). Returns the number
    of workers reached; the calling process is boosted too."""
    from ray_tpu_torch._private import sampler as _sampler

    _sampler.boost(hz, duration_s)
    return _sched_rpc("request_profile", hz, duration_s)


def profile_dump(
    filename: str,
    format: str = "speedscope",
    task_id: Optional[str] = None,
    trace_id: Optional[str] = None,
) -> int:
    """Export the cluster's aggregated continuous-profiler samples as a
    flame graph: ``format="speedscope"`` (JSON for speedscope.app, one
    profile per task) or ``"collapsed"`` (Brendan-Gregg collapsed stacks).
    Optional ``task_id``/``trace_id`` narrow attribution to one task or one
    request. Returns profiles/lines written."""
    from ray_tpu_torch._private import sampler as _sampler

    _sampler.get_sampler().drain()
    rows = _traced_rpc("profile_samples", task_id, trace_id)
    if format == "collapsed":
        return _sampler.write_collapsed(rows, filename)
    if format == "speedscope":
        return _sampler.write_speedscope(rows, filename)
    raise ValueError(f"unknown flame-graph format {format!r}")
