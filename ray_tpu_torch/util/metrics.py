"""Application metrics: Counter / Gauge / Histogram.

Parity: ``python/ray/util/metrics.py`` + the metrics agent's Prometheus
exposition (``python/ray/_private/metrics_agent.py:483``). Records update a
process-local shadow and ride the telemetry plane
(``ray_tpu_torch._private.telemetry``): the background flusher ships at most ONE
snapshot per metric per ``metrics_report_interval_ms`` — the seed did a
blocking KV RPC on *every* ``Counter.inc()`` and silently swallowed
failures. The scheduler merges per-process snapshots (counters/histograms
sum across processes, gauges last-writer-wins) into the GCS KV, and
:func:`prometheus_text` exposes them plus the runtime-internal series
(scheduler queue depth, handler event_stats, object-store usage, fastcopy
stage bandwidth, telemetry drop counters) in Prometheus text format.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.worker import get_runtime

_NS = "metrics"
_lock = threading.Lock()
# local shadow (shipped in batches by the telemetry flusher): name ->
# {labels_json: value}
_local: Dict[str, Dict[str, object]] = {}


def _enqueue(name: str, kind: str, description: str, data: Dict[str, object]):
    """Queue this metric's latest snapshot for the next batched flush (one
    KV write per interval per metric, not per record). Loss is accounted by
    ``ray_tpu_torch_telemetry_dropped_total``, not swallowed."""
    from ray_tpu_torch._private import telemetry

    telemetry.record_metric(name, kind, description, data)


class _Metric:
    KIND = "untyped"

    def __init__(self, name: str, description: str = "", tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        with _lock:
            _local.setdefault(name, {})

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> str:
        merged = {**self._default_tags, **(tags or {})}
        return json.dumps(merged, sort_keys=True)

    def _store(self, key: str, value):
        with _lock:
            _local[self._name][key] = value
            snapshot = dict(_local[self._name])
        _enqueue(self._name, self.KIND, self._description, snapshot)


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with _lock:
            current = _local[self._name].get(key, 0.0)
        self._store(key, current + value)


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._store(self._key(tags), value)


# default histogram grid: sub-millisecond buckets resolve dispatch-path
# costs (direct-call send, lease grant, arg materialization live in the
# 10us-1ms band the old [0.1, 1, 10, 100, 1000] grid lumped into one
# bucket), still reaching 10s for slow requests. Units are whatever the
# metric observes — for *_ms series this spans 10us .. 10s.
DEFAULT_HISTOGRAM_BOUNDARIES: List[float] = [
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000,
]

# per-metric boundary overrides (configure_histogram_boundaries), consulted
# at CONSTRUCTION time; env var RAY_TPU_TORCH_HIST_BUCKETS_<NAME> (comma-separated
# floats, metric name uppercased with non-alnum -> _) wins over both
_boundary_overrides: Dict[str, List[float]] = {}


def configure_histogram_boundaries(name: str, boundaries: List[float]) -> None:
    """Set the bucket bounds for histograms named ``name`` created AFTER
    this call (per-metric bucket configurability). Bounds must ascend."""
    bounds = list(boundaries)
    if bounds != sorted(bounds) or not bounds:
        raise ValueError("histogram boundaries must be ascending and non-empty")
    with _lock:
        _boundary_overrides[name] = bounds


def _env_boundaries(name: str) -> Optional[List[float]]:
    import os
    import re

    key = "RAY_TPU_TORCH_HIST_BUCKETS_" + re.sub(r"[^A-Za-z0-9]", "_", name).upper()
    raw = os.environ.get(key)
    if not raw:
        return None
    try:
        bounds = [float(p) for p in raw.split(",") if p.strip()]
        return bounds if bounds == sorted(bounds) and bounds else None
    except ValueError:
        return None


def resolve_boundaries(name: str, explicit: Optional[List[float]] = None) -> List[float]:
    """Boundary resolution order: env override > configure_histogram_
    boundaries > constructor argument > the default grid."""
    env = _env_boundaries(name)
    if env is not None:
        return env
    with _lock:
        override = _boundary_overrides.get(name)
    if override is not None:
        return list(override)
    if explicit:
        # preserved verbatim: int bounds render as le="1", not le="1.0"
        return list(explicit)
    return list(DEFAULT_HISTOGRAM_BOUNDARIES)


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(self, name, description="", boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self._boundaries = resolve_boundaries(name, boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.observe_many((value,), tags)

    def observe_many(self, values, tags: Optional[Dict[str, str]] = None):
        """Fold a batch of observations in with ONE entry copy + snapshot
        enqueue (observe() per value pays a json round-trip each — hot
        per-step callers like the train step plane accumulate locally and
        flush batches through here)."""
        if not values:
            return
        key = self._key(tags)
        with _lock:
            entry = _local[self._name].get(key) or {
                "count": 0,
                "sum": 0.0,
                "buckets": [0] * (len(self._boundaries) + 1),
            }
            entry = json.loads(json.dumps(entry))  # copy
        for value in values:
            entry["count"] += 1
            entry["sum"] += value
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    entry["buckets"][i] += 1
                    break
            else:
                entry["buckets"][-1] += 1
        entry["boundaries"] = self._boundaries
        self._store(key, entry)


def _sync_cluster_telemetry(rt) -> None:
    """Read-your-writes for the batched pipeline: flush this process's
    buffer, then ask the scheduler to pull every worker's (bounded wait).
    Remote (socket-attached) drivers skip the cluster pull — their view may
    lag one flush interval."""
    from ray_tpu_torch._private import telemetry

    telemetry.flush()
    scheduler = getattr(rt, "scheduler", None)
    if scheduler is not None:
        try:
            scheduler.request_telemetry_flush()
        except Exception:
            pass


def _format_series(lines: List[str], name: str, kind: str, description: str,
                   data: Dict[str, object]) -> None:
    lines.append(f"# HELP {name} {description}")
    lines.append(f"# TYPE {name} {kind if kind != 'untyped' else 'gauge'}")
    for labels_json, value in data.items():
        labels = json.loads(labels_json) if labels_json.startswith("{") else {}
        label_str = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        label_part = "{" + label_str + "}" if label_str else ""
        if kind == "histogram" and isinstance(value, dict):
            lines.append(f"{name}_count{label_part} {value['count']}")
            lines.append(f"{name}_sum{label_part} {value['sum']}")
            bounds = value.get("boundaries") or []
            cumulative = 0
            for b, n in zip(bounds, value.get("buckets", ())):
                cumulative += n
                le = "{" + ",".join(filter(None, [label_str, f'le="{b}"'])) + "}"
                lines.append(f"{name}_bucket{le} {cumulative}")
            le_inf = "{" + ",".join(filter(None, [label_str, 'le="+Inf"'])) + "}"
            lines.append(f"{name}_bucket{le_inf} {value['count']}")
        else:
            lines.append(f"{name}{label_part} {value}")


def prometheus_text() -> str:
    """All recorded metrics — application (GCS KV aggregated) plus the
    scheduler's runtime-internal series — in Prometheus exposition format."""
    rt = get_runtime()
    _sync_cluster_telemetry(rt)
    if hasattr(rt, "scheduler_rpc"):
        keys = rt.scheduler_rpc("kv_keys", (_NS, b""))
        get = lambda k: rt.scheduler_rpc("kv_get", (_NS, k))  # noqa: E731
        runtime_series = rt.scheduler_rpc("runtime_metrics", ())
    else:
        keys = rt.rpc("kv_keys", _NS, b"")
        get = lambda k: rt.rpc("kv_get", _NS, k)  # noqa: E731
        runtime_series = rt.rpc("runtime_metrics")
    lines: List[str] = []
    for key in sorted(keys):
        raw = get(key)
        if raw is None:
            continue
        payload = json.loads(raw)
        _format_series(
            lines,
            key.decode(),
            payload["kind"],
            payload.get("description", ""),
            payload["data"],
        )
    for series in runtime_series or ():
        _format_series(
            lines,
            series["name"],
            series.get("kind", "gauge"),
            series.get("description", ""),
            series.get("data", {}),
        )
    return "\n".join(lines) + "\n"
