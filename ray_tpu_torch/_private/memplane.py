"""Memory-observability plane: allocation provenance + byte attribution.

Answers "where did the *bytes* go" the way the tracing plane
answers "where did the *time* go". Parity: ``ray memory``'s per-object
provenance grouped by creation callsite with ref-holder attribution
(``python/ray/_private/internal_api.py`` memory_summary / the
CoreWorker's ``ObjectRefInfo`` callsite capture).

Three process-side capture points feed the scheduler's bounded provenance
index through the telemetry ring:

* **allocation provenance** — every store-backed ``put`` / task-return /
  stream-item records its creation callsite (``file.py:LINE`` digest,
  interned with bounded cardinality), size, kind, and active trace id;
  the owner task/job ids ride in the object id itself (an oid embeds its
  creating task id). Shipped batched (``telemetry.record_object_event``),
  never per-record RPCs.
* **spill/restore byte attribution** — the store clients call
  :func:`note_spill` / :func:`note_restore` with the victim oid; the
  owning job is decoded from the oid and the bytes land on the
  ``ray_tpu_torch_spill_bytes_total{job=}`` / ``ray_tpu_torch_restore_bytes_total``
  counters (batched through the same metrics pipeline).
* **device-memory telemetry** — :func:`maybe_record_device_metrics` is
  probed from the telemetry flusher cadence: once user code has
  initialised CUDA in this process, per-device ``ray_tpu_torch_device_*``
  gauges (the caching allocator's bytes allocated, reserved and peak,
  ``torch.cuda.memory_stats``) are recorded. Never imports torch or
  initialises CUDA itself.

Scheduler-side consumers: the provenance index, the 1 Hz leak watchdog,
``state.summarize_objects`` server-side grouping, the ``ray_tpu_torch memory``
CLI, and the OOM-kill forensics snapshot (see
``Scheduler._memory_watchdog_scan`` / ``memory_forensics_snapshot``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from typing import Dict, Optional

# bounded per-process callsite interning: beyond the cap every new site
# collapses into one bucket so a pathological codegen loop can't balloon
# the provenance index's label cardinality
_CALLSITE_CACHE_MAX = 1024
_ELIDED = "<elided>"

_callsite_cache: Dict[tuple, str] = {}
_callsite_lock = threading.Lock()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# (runtime identity, verdict) — the flags can't change under a live
# runtime, and this check sits on the put hot path (bench-budgeted)
_enabled_cache: tuple = (None, False)


def enabled() -> bool:
    """Memory plane on? Requires the telemetry pipeline (records ride its
    batches); ``memory_plane_enabled`` gates the capture side. Memoized
    per connected runtime — this is the put hot path."""
    from ray_tpu_torch._private import telemetry

    rt = telemetry._runtime()
    if rt is None:
        return False
    global _enabled_cache
    cached_rt, verdict = _enabled_cache
    if cached_rt is rt:
        return verdict
    cfg = getattr(rt, "config", None)
    verdict = bool(getattr(cfg, "telemetry_enabled", True)) and bool(
        getattr(cfg, "memory_plane_enabled", True)
    )
    _enabled_cache = (rt, verdict)
    return verdict


def user_callsite(depth_limit: int = 12) -> str:
    """``file.py:LINE`` of the nearest stack frame OUTSIDE ray_tpu_torch — the
    user line that created the object. Interned (bounded): repeated puts
    from one site share a single string."""
    try:
        frame = sys._getframe(1)
    except ValueError:
        return "<unknown>"
    depth = 0
    while frame is not None and depth < depth_limit:
        code = frame.f_code
        fn = code.co_filename
        if not fn.startswith(_PKG_DIR):
            key = (fn, frame.f_lineno)
            with _callsite_lock:
                cs = _callsite_cache.get(key)
                if cs is None:
                    if len(_callsite_cache) >= _CALLSITE_CACHE_MAX:
                        return _ELIDED
                    cs = f"{os.path.basename(fn)}:{frame.f_lineno}"
                    _callsite_cache[key] = cs
            return cs
        frame = frame.f_back
        depth += 1
    return "<internal>"


def capture_put() -> Optional[tuple]:
    """Hot-path provenance capture for ``put``: returns ``(callsite,
    trace_id, t)`` to ride the put's EXISTING registration message
    (``put_done`` / ``submit_put``) — zero extra messages, and the
    provenance can never race the commit it describes. None when the
    plane is off. Returns/stream items have no per-object message and use
    :func:`record_object` (telemetry batches) instead."""
    if not enabled():
        return None
    from ray_tpu_torch.util import tracing

    return (user_callsite(), tracing.current_trace_id(), time.time())


def record_object(oid, size: int, kind: str, callsite: Optional[str] = None) -> None:
    """One store-backed object came to life: ship its provenance record
    (batched). ``kind`` is ``put`` / ``return`` / ``stream_item``. The
    creating task and job ids are embedded in the oid — the scheduler
    decodes them at ingest, keeping this record small. Hot path: one
    bounded stack walk + one ring-buffer append per store-backed put."""
    if not enabled():
        return
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch.util import tracing

    # compact positional record (oid_bin, size, kind, callsite, trace, t):
    # one tuple alloc on the put hot path, decoded scheduler-side
    buf = telemetry.get_buffer()
    buf.record_object_event(
        (
            oid.binary(),
            int(size),
            kind,
            callsite if callsite is not None else user_callsite(),
            tracing.current_trace_id(),
            time.time(),
        )
    )
    buf.ensure_flusher()


# --------------------------------------------------------------------------
# spill / restore byte attribution (per owning job)
# --------------------------------------------------------------------------

_byte_counters: Dict[str, object] = {}
_counter_lock = threading.Lock()


def _job_hex_of(oid) -> str:
    try:
        return oid.binary()[20:24].hex()
    except Exception:
        return "unknown"


def _spill_restore_counters():
    """Lazily construct the per-job spill/restore counters (metric names
    stay literal constructor args: the metrics-lint scanner keys on it)."""
    with _counter_lock:
        if "spill" not in _byte_counters:
            from ray_tpu_torch.util.metrics import Counter

            _byte_counters["spill"] = Counter(
                "ray_tpu_torch_spill_bytes_total",
                "bytes spilled out of the object-store arena, by owning job",
                tag_keys=("job",),
            )
            _byte_counters["restore"] = Counter(
                "ray_tpu_torch_restore_bytes_total",
                "bytes restored from the spill path into the object store, "
                "by owning job",
                tag_keys=("job",),
            )
    return _byte_counters


def note_spill(oid, nbytes: int) -> None:
    """An object left the arena for the spill path; charge its owning job
    (the oid embeds the creating task's job id)."""
    if not enabled():
        return
    try:
        _spill_restore_counters()["spill"].inc(
            int(nbytes), tags={"job": _job_hex_of(oid)}
        )
    except Exception:
        pass  # observability must never fail the data path


def note_restore(oid, nbytes: int) -> None:
    """A spilled object was restored into the store; per-job accounting."""
    if not enabled():
        return
    try:
        _spill_restore_counters()["restore"].inc(
            int(nbytes), tags={"job": _job_hex_of(oid)}
        )
    except Exception:
        pass


# --------------------------------------------------------------------------
# device-memory telemetry (the CUDA caching allocator)
# --------------------------------------------------------------------------

_DEVICE_PROBE_INTERVAL_S = 5.0
_last_device_probe = 0.0
_device_gauges: Dict[str, object] = {}


def _get_device_gauges() -> Dict[str, object]:
    """Lazily construct the ``ray_tpu_torch_device_*`` gauges (literal names:
    the metrics-lint scanner keys on the constructor call)."""
    with _counter_lock:
        if "bytes_in_use" not in _device_gauges:
            from ray_tpu_torch.util.metrics import Gauge

            _device_gauges["bytes_in_use"] = Gauge(
                "ray_tpu_torch_device_bytes_in_use",
                "bytes held by live tensors (torch.cuda.memory_allocated)",
                tag_keys=("pid", "device"),
            )
            _device_gauges["reserved_bytes"] = Gauge(
                "ray_tpu_torch_device_reserved_bytes",
                "bytes the caching allocator holds (torch.cuda.memory_reserved)",
                tag_keys=("pid", "device"),
            )
            _device_gauges["peak_bytes_in_use"] = Gauge(
                "ray_tpu_torch_device_peak_bytes_in_use",
                "high-water mark of allocated bytes (torch.cuda.max_memory_allocated)",
                tag_keys=("pid", "device"),
            )
    return _device_gauges


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def maybe_record_device_metrics() -> bool:
    """Record per-device CUDA memory gauges when (and only when) user code
    has initialised CUDA in this process. Called from the telemetry flusher
    cadence; self-rate-limited; never imports torch or initialises CUDA.
    Returns True when a sweep was recorded."""
    global _last_device_probe
    if not _cuda_initialized() or not enabled():
        return False
    now = time.monotonic()
    if now - _last_device_probe < _DEVICE_PROBE_INTERVAL_S:
        return False
    _last_device_probe = now
    try:
        return collect_device_metrics()
    except Exception:
        return False


def collect_device_metrics() -> bool:
    """One sweep of the caching allocator's stats into the
    ``ray_tpu_torch_device_*`` gauges (skipped while CUDA is uninitialised).
    Separate from the rate-limited probe so tests/read paths can force it."""
    pid = str(os.getpid())
    if _cuda_initialized():
        cuda = sys.modules["torch"].cuda
        gauges = _get_device_gauges()
        for index in range(cuda.device_count()):
            try:
                stats = cuda.memory_stats(index)
            except Exception:
                continue
            tags = {"pid": pid, "device": f"cuda:{index}"}
            gauges["bytes_in_use"].set(int(stats.get("allocated_bytes.all.current", 0)), tags=tags)
            gauges["reserved_bytes"].set(int(stats.get("reserved_bytes.all.current", 0)), tags=tags)
            gauges["peak_bytes_in_use"].set(int(stats.get("allocated_bytes.all.peak", 0)), tags=tags)
    # KV-cache view: every registered paged-pool provider (LLM engines in
    # this process) folds into the ray_tpu_torch_kv_* gauges alongside the
    # allocator stats, so `ray_tpu_torch memory` shows KV occupancy next to HBM
    try:
        for name, ref in list(_kv_providers.items()):
            provider = ref()
            if provider is None:  # its engine is gone
                _kv_providers.pop(name, None)
                continue
            try:
                record_kv_occupancy(provider())
            except Exception:
                pass
    except Exception:
        pass
    return True


# -- paged KV cache occupancy (LLM serving plane) ----------------------------
#
# The serve-plane inference engine reserves KV blocks at admission and
# sheds on exhaustion; these gauges make that live shed signal visible in
# the same device-gauge surface as HBM use. Providers are callables
# returning an engine's kv_stats() snapshot, swept by
# collect_device_metrics() and updated inline by the engine on every
# admission/finish edge.

_kv_gauges: Dict[str, object] = {}
_kv_providers: Dict[str, object] = {}


def register_kv_provider(deployment: str, provider) -> None:
    """Register a KV-stats source (an engine's ``kv_stats``) so periodic
    device sweeps refresh the ``ray_tpu_torch_kv_*`` gauges even when the
    engine is idle. A bound method is held weakly: the registry must not
    keep an engine, its weights and its KV pool alive."""
    if hasattr(provider, "__self__"):
        ref = weakref.WeakMethod(provider)
    else:
        ref = lambda: provider  # noqa: E731
    _kv_providers[str(deployment)] = ref


def _get_kv_gauges() -> Dict[str, object]:
    with _counter_lock:
        if "blocks_total" not in _kv_gauges:
            from ray_tpu_torch.util.metrics import Gauge

            _kv_gauges["blocks_total"] = Gauge(
                "ray_tpu_torch_kv_blocks_total",
                "usable KV-cache blocks in the paged device pool per LLM "
                "deployment (excludes the reserved null block)",
                tag_keys=("deployment",),
            )
            _kv_gauges["blocks_free"] = Gauge(
                "ray_tpu_torch_kv_blocks_free",
                "KV-cache blocks currently on the free list per LLM "
                "deployment — the admission-control shed signal",
                tag_keys=("deployment",),
            )
            _kv_gauges["occupancy"] = Gauge(
                "ray_tpu_torch_kv_occupancy_ratio",
                "fraction of usable KV-cache blocks in use per LLM "
                "deployment (1.0 = pool exhausted, requests shed)",
                tag_keys=("deployment",),
            )
            _kv_gauges["bytes_total"] = Gauge(
                "ray_tpu_torch_kv_pool_bytes",
                "device bytes reserved by the paged KV pool per LLM "
                "deployment (blocks x bytes-per-block, both k and v)",
                tag_keys=("deployment",),
            )
    return _kv_gauges


def record_kv_occupancy(stats: Dict[str, object]) -> None:
    """Fold one engine ``kv_stats()`` snapshot into the KV gauges."""
    if not enabled():
        return
    try:
        gauges = _get_kv_gauges()
        tags = {"deployment": str(stats.get("deployment", "llm"))}
        total = int(stats.get("blocks_total", 0))
        free = int(stats.get("blocks_free", 0))
        gauges["blocks_total"].set(float(total), tags=tags)
        gauges["blocks_free"].set(float(free), tags=tags)
        gauges["occupancy"].set(
            0.0 if not total else 1.0 - free / total, tags=tags
        )
        bpb = int(stats.get("bytes_per_block", 0))
        if bpb:
            # pool bytes include the reserved null block
            gauges["bytes_total"].set(float((total + 1) * bpb), tags=tags)
    except Exception:
        pass
