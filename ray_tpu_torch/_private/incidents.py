"""Alerting & incident-forensics plane (the observability capstone).

The observability planes built the attribution substrate — request traces, memory
provenance, the training goodput ledger, the per-link transfer ledger, and
the actor-launch lifecycle — but nothing *watched* it: an operator had to
already know which of ~110 series, 9 watchdog event types, and 5 plane
CLIs to query.  This module is the consuming layer (parity role: the
reference's dashboard alerting + event aggregation, SURVEY L8):

* **SLO registry & burn-rate evaluator** — declarative SLO specs
  (:class:`SLOSpec`) over state the head already holds: per-job p99
  latency off the ``LatencyWindow``s, per-deployment p99 / availability /
  stream TTFT off the aggregated serve series, per-run goodput floors off
  the step-plane ledger, per-link throughput floors off the net-plane
  EWMAs, and an actor-launch-rate floor off the launch counters.  Each
  (spec, subject) keeps a ring of 1 Hz badness samples; an SLO *breaches*
  only when both the fast- and the slow-window burn rate exceed the
  threshold (Google-SRE multi-window multi-burn-rate), so transient noise
  never fires.  Burn = time-in-violation / error budget (or, for
  availability, bad-request fraction / budget).

* **Incident lifecycle** — any SLO breach or existing watchdog event
  (SLOW_LINK, OBJECT_TRANSFER_STALLED, ACTOR_LAUNCH_STALLED,
  OBJECT_LEAK_SUSPECT, TRAIN_RECOMPILE, OOM, WORKER_SPAWN_FAILED,
  STRAGGLER, HUNG_GET — plus a WORKER_DIED *burst* gate, since a single
  death is routine churn) opens or merges into a bounded incident record
  keyed (kind, subject).  Each incident auto-assembles a cross-plane
  digest joined by trace id and time — exemplar traces with stage
  breakdowns, the kill-time-style memory snapshot, the goodput-ledger
  slice, the offending link-ledger rows, launch/decision-ring entries,
  and correlated cluster events — and closes on recovery with a measured
  duration and a one-line verdict naming the dominant attributed cause.

* **Surfaces** — ``ray_tpu_torch doctor`` / ``ray_tpu_torch incidents`` (CLI),
  ``state.list_incidents``, the dashboard incidents tab, a pluggable
  alert-sink seam (file / webhook / in-process callable), and the
  ``ray_tpu_torch_slo_*`` / ``ray_tpu_torch_incidents_*`` series.

Plane rules: evaluation rides the scheduler's existing 1 Hz maintenance
pass (:meth:`IncidentManager.scan` is called from ``_schedule``); the only
off-loop entry points are :meth:`IncidentManager.note_event` (a bounded
lock-guarded enqueue) and the read-only counters — no new hot-path
messages, and ``incident_plane_overhead_ratio`` <= 1.05 is recorded in
BENCH_CORE.jsonl (bench_incidents.py).
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch._private.telemetry import EventDeduper

logger = logging.getLogger(__name__)

# watchdog event types that open (or merge into) an incident directly.
# WORKER_DIED is intake-only: it feeds the kill-storm burst gate below.
_TRIGGER_SUBJECT: Dict[str, Callable[[dict], str]] = {
    "SLOW_LINK": lambda ev: ev.get("link") or "?",
    "OBJECT_TRANSFER_STALLED": lambda ev: ev.get("link") or "?",
    "ACTOR_LAUNCH_STALLED": lambda ev: (
        f"{ev.get('stage') or '?'}@{(ev.get('node_id') or 'head')[:12]}"
    ),
    "OBJECT_LEAK_SUSPECT": lambda ev: ev.get("callsite") or "?",
    "TRAIN_RECOMPILE": lambda ev: str(ev.get("run") or "?"),
    "OOM": lambda ev: (ev.get("node_id") or "head")[:12],
    "WORKER_SPAWN_FAILED": lambda ev: (ev.get("node_id") or "head")[:12],
    "STRAGGLER": lambda ev: ev.get("name") or "?",
    "HUNG_GET": lambda ev: "driver",
    "REPLICA_DIED": lambda ev: ev.get("deployment") or "?",
}

# intake-only types: counted / burst-gated, never 1:1 incidents
_INTAKE_EXTRA = ("WORKER_DIED", "REPLICA_REQUEST_FAILED")

SLO_KINDS = (
    "job_latency_p99",
    "deployment_latency_p99",
    "deployment_availability",
    "deployment_ttft_p99",
    "train_goodput_floor",
    "link_throughput_floor",
    "actor_launch_rate_floor",
)


@dataclass
class SLOSpec:
    """One declarative service-level objective.

    ``target`` is the objective value in the kind's natural unit (ms for
    latency/TTFT kinds, a 0..1 fraction for availability and goodput,
    GiB/s for links, launches/s for the launch rate).  ``budget`` is the
    tolerated bad fraction (error budget): for time-based kinds the
    fraction of wall time the signal may sit in violation, for
    availability the tolerated failed-request fraction.  A breach fires
    only when burn = bad/budget >= ``threshold`` over BOTH windows."""

    name: str
    kind: str
    target: float
    budget: float = 0.1
    threshold: float = 1.0
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    subject: Optional[str] = None  # None/"*" = every observed subject
    severity: str = "WARNING"
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        if not d.get("name"):
            raise ValueError("SLO spec needs a name")
        kind = d.get("kind")
        if kind not in SLO_KINDS:
            raise ValueError(
                f"unknown SLO kind {kind!r} (one of {', '.join(SLO_KINDS)})"
            )
        if "target" not in d:
            raise ValueError("SLO spec needs a target")
        known = {
            "name", "kind", "target", "budget", "threshold",
            "fast_window_s", "slow_window_s", "subject", "severity",
            "params",
        }
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown SLO spec fields: {sorted(extra)}")
        return cls(
            name=str(d["name"]),
            kind=str(kind),
            target=float(d["target"]),
            budget=float(d.get("budget", 0.1)),
            threshold=float(d.get("threshold", 1.0)),
            fast_window_s=float(d.get("fast_window_s", 60.0)),
            slow_window_s=float(d.get("slow_window_s", 300.0)),
            subject=d.get("subject") or None,
            severity=str(d.get("severity", "WARNING")),
            params=dict(d.get("params") or {}),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "target": self.target,
            "budget": self.budget,
            "threshold": self.threshold,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "subject": self.subject,
            "severity": self.severity,
            "params": dict(self.params),
        }


class _SLOState:
    """Per-(spec, subject) burn-rate bookkeeping: a bounded ring of 1 Hz
    (wall_ts, badness in [0,1]) samples + the latest evaluated burns."""

    __slots__ = (
        "samples", "burn_fast", "burn_slow", "breached", "breach_since",
        "detail", "last_sample_t",
    )

    def __init__(self, max_samples: int):
        self.samples: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max_samples
        )
        self.burn_fast: Optional[float] = None
        self.burn_slow: Optional[float] = None
        self.breached = False
        self.breach_since: Optional[float] = None
        self.detail: dict = {}
        self.last_sample_t = 0.0

    def burn(self, window_s: float, budget: float, now: float,
             min_samples: int = 3) -> Optional[float]:
        live = [b for t, b in self.samples if t >= now - window_s]
        if len(live) < min_samples:
            return None
        return (sum(live) / len(live)) / max(budget, 1e-9)


def _hist_p99(count: int, buckets: List[float], boundaries: List[float]
              ) -> Optional[float]:
    """p99 estimate from cumulative histogram deltas (upper bound of the
    bucket holding the 99th percentile; +Inf bucket -> last boundary)."""
    if count <= 0 or not buckets:
        return None
    rank = 0.99 * count
    seen = 0.0
    for i, n in enumerate(buckets):
        seen += n
        if seen >= rank:
            return float(
                boundaries[i] if i < len(boundaries) else boundaries[-1]
            )
    return float(boundaries[-1]) if boundaries else None


class _AlertSinks:
    """Pluggable alert fan-out: ``file:<path>`` appends one JSON line per
    alert, ``webhook:<url>`` POSTs the payload from a daemon thread (a
    dead endpoint can never stall the scheduler loop), and in-process
    callables register via :meth:`add`.  Failures are counted, never
    raised."""

    def __init__(self, spec: str):
        self._sinks: List[Tuple[str, Callable[[dict], None]]] = []
        self.emitted: Dict[str, int] = {}
        self.failed: Dict[str, int] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if part.startswith("file:"):
                self._sinks.append((part, self._file_sink(part[5:])))
            elif part.startswith("webhook:"):
                self._sinks.append((part, self._webhook_sink(part[8:])))
            else:
                logger.warning("ignoring unknown alert sink %r", part)

    @staticmethod
    def _file_sink(path: str) -> Callable[[dict], None]:
        def emit(payload: dict) -> None:
            with open(path, "a") as fh:
                fh.write(json.dumps(payload) + "\n")

        return emit

    @staticmethod
    def _webhook_sink(url: str) -> Callable[[dict], None]:
        def emit(payload: dict) -> None:
            import urllib.request

            def _post():
                try:
                    req = urllib.request.Request(
                        url,
                        data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    urllib.request.urlopen(req, timeout=5).read()
                except Exception:
                    pass  # counted by the caller's try; never raised

            threading.Thread(target=_post, daemon=True).start()

        return emit

    def add(self, fn: Callable[[dict], None], name: Optional[str] = None):
        self._sinks.append((name or getattr(fn, "__name__", "callable"), fn))

    def emit(self, payload: dict) -> None:
        for name, fn in self._sinks:
            try:
                fn(payload)
                self.emitted[name] = self.emitted.get(name, 0) + 1
            except Exception:
                self.failed[name] = self.failed.get(name, 0) + 1


class IncidentManager:
    """Owns SLO evaluation + the bounded incident table.

    Constructed by the scheduler; :meth:`scan` runs ON the scheduler loop
    inside the existing 1 Hz maintenance pass, so every read of scheduler
    state (latency windows, link ledger, step index, provenance) is
    race-free by construction.  The only cross-thread entry points are
    :meth:`note_event` (bounded enqueue under a small lock — called from
    ``_ingest_cluster_event``, which itself is any-thread) and the plain
    counter reads the metric series make."""

    def __init__(self, sch, config):
        self._sch = sch
        self._cfg = config
        self._lock = threading.Lock()  # guards _pending only
        self._pending: Deque[dict] = collections.deque(maxlen=1024)
        # incident table: id -> record; bounded, closed-oldest evicted
        self._incidents: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self._seq = 0
        self._max = int(getattr(config, "incident_max", 256) or 256)
        self._quiet_close_s = float(
            getattr(config, "incident_quiet_close_s", 120.0) or 120.0
        )
        self._event_window_s = float(
            getattr(config, "incident_event_window_s", 120.0) or 120.0
        )
        # WORKER_DIED burst gate: deaths within the window, per node
        self._death_burst = int(
            getattr(config, "incident_worker_died_burst", 3) or 3
        )
        self._burst_window_s = float(
            getattr(config, "incident_burst_window_s", 30.0) or 30.0
        )
        self._deaths: Deque[Tuple[float, str, dict]] = collections.deque(
            maxlen=512
        )
        # REPLICA_REQUEST_FAILED timestamps per deployment (availability
        # SLO numerator); bounded per deployment
        self._serve_failures: Dict[str, Deque[float]] = {}
        # one alert per (incident, action) — and storms re-alert at most
        # once per re-arm even if the incident keeps merging
        self._alert_dedup = EventDeduper(rearm_s=300.0, max_keys=512)
        self._storm_dedup = EventDeduper(rearm_s=60.0, max_keys=256)
        # SLO registry: name -> SLOSpec; states keyed (name, subject)
        self._slos: Dict[str, SLOSpec] = {}
        self._slo_states: Dict[Tuple[str, str], _SLOState] = {}
        self._slo_breaches: Dict[str, int] = {}
        # cumulative-counter rings for rate-style SLO inputs:
        # (name, subject) -> deque[(t, value-or-tuple)]
        self._cum_rings: Dict[Tuple[str, str], Deque[Tuple[float, Any]]] = {}
        self.sinks = _AlertSinks(getattr(config, "alert_sinks", "") or "")
        self.opened_total: Dict[str, int] = {}
        self.closed_total = 0
        self.scan_count = 0
        self._load_config_slos()

    # ---- config / registry ---------------------------------------------

    def _load_config_slos(self) -> None:
        raw = getattr(self._cfg, "slo_config", "") or ""
        if not raw:
            return
        try:
            if raw.startswith("@"):
                with open(raw[1:]) as fh:
                    raw = fh.read()
            specs = json.loads(raw)
            if isinstance(specs, dict):
                specs = [specs]
            for d in specs:
                spec = SLOSpec.from_dict(d)
                self._slos[spec.name] = spec
        except Exception:
            logger.exception("failed to load slo_config")

    def register_slo(self, d: dict) -> dict:
        spec = SLOSpec.from_dict(d)
        self._slos[spec.name] = spec
        # re-registration resets the burn bookkeeping for that name
        for key in [k for k in self._slo_states if k[0] == spec.name]:
            del self._slo_states[key]
        return spec.to_dict()

    def remove_slo(self, name: str) -> bool:
        gone = self._slos.pop(name, None) is not None
        for key in [k for k in self._slo_states if k[0] == name]:
            del self._slo_states[key]
        return gone

    def list_slos(self) -> List[dict]:
        out = []
        for spec in self._slos.values():
            states = [
                (key[1], st)
                for key, st in self._slo_states.items()
                if key[0] == spec.name
            ]
            worst = None
            for subj, st in states:
                bf = st.burn_fast if st.burn_fast is not None else -1.0
                if worst is None or bf > worst[1]:
                    worst = (subj, bf, st)
            row = spec.to_dict()
            row.update(
                {
                    "subjects": len(states),
                    "ok": not any(st.breached for _, st in states),
                    "breaches_total": self._slo_breaches.get(spec.name, 0),
                }
            )
            if worst is not None:
                _, _, st = worst
                row["worst"] = {
                    "subject": worst[0],
                    "burn_fast": _r(st.burn_fast),
                    "burn_slow": _r(st.burn_slow),
                    **st.detail,
                }
            out.append(row)
        return out

    # ---- intake ---------------------------------------------------------

    def note_event(self, ev: dict) -> None:
        """Any-thread trigger intake (called under no scheduler locks from
        ``_ingest_cluster_event``): bounded enqueue of the event types the
        plane consumes; everything else returns in two dict lookups."""
        etype = ev.get("type")
        if etype in _TRIGGER_SUBJECT or etype in _INTAKE_EXTRA:
            with self._lock:
                self._pending.append(ev)

    # ---- the 1 Hz scan (scheduler loop) ---------------------------------

    def scan(self) -> None:
        now = time.time()
        self.scan_count += 1
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for ev in pending:
            etype = ev.get("type")
            if etype == "WORKER_DIED":
                # graceful exits (idle reaping, shutdown drain) are INFO
                # and routine — only unexpected deaths count toward a storm
                if (ev.get("severity") or "") == "ERROR":
                    node = (ev.get("node_id") or "head")[:12]
                    self._deaths.append((now, node, ev))
                continue
            if etype == "REPLICA_REQUEST_FAILED":
                dep = ev.get("deployment") or "?"
                ring = self._serve_failures.get(dep)
                if ring is None:
                    ring = self._serve_failures[dep] = collections.deque(
                        maxlen=2048
                    )
                ring.append(float(ev.get("time") or now))
                continue
            subject = _TRIGGER_SUBJECT[etype](ev)
            self._open_or_merge(etype, subject, ev, now, source="watchdog")
        self._check_kill_storms(now)
        try:
            self._eval_slos(now)
        except Exception:
            logger.exception("slo evaluation failed")
        self._check_closes(now)

    def _check_kill_storms(self, now: float) -> None:
        """>= incident_worker_died_burst deaths on one node inside the
        burst window collapse into ONE WORKER_KILL_STORM incident — a
        single death is routine churn and never opens an incident."""
        while self._deaths and now - self._deaths[0][0] > self._burst_window_s:
            self._deaths.popleft()
        per_node: Dict[str, List[dict]] = {}
        for _, node, ev in self._deaths:
            per_node.setdefault(node, []).append(ev)
        for node, evs in per_node.items():
            if len(evs) < self._death_burst:
                continue
            if not self._storm_dedup.should_fire(("storm", node)):
                continue
            synth = {
                "time": now,
                "type": "WORKER_KILL_STORM",
                "severity": "ERROR",
                "source": "INCIDENTS",
                "message": (
                    f"{len(evs)} worker deaths on node {node} within "
                    f"{self._burst_window_s:g}s"
                ),
                "node_id": node,
                "deaths": len(evs),
                "window_s": self._burst_window_s,
                "exit_detail": [
                    e.get("message") for e in evs[-3:]
                ],
            }
            self._open_or_merge(
                "WORKER_KILL_STORM", node, synth, now, source="watchdog"
            )

    # ---- SLO evaluation -------------------------------------------------

    def _eval_slos(self, now: float) -> None:
        for spec in list(self._slos.values()):
            try:
                samples = self._sample_slo(spec, now)
            except Exception:
                logger.exception("slo %s sampling failed", spec.name)
                continue
            for subject, bad, detail in samples:
                key = (spec.name, subject)
                st = self._slo_states.get(key)
                if st is None:
                    st = self._slo_states[key] = _SLOState(
                        max_samples=max(int(spec.slow_window_s) + 60, 120)
                    )
                st.samples.append((now, float(bad)))
                st.last_sample_t = now
                st.detail = detail
                st.burn_fast = st.burn(
                    spec.fast_window_s, spec.budget, now
                )
                st.burn_slow = st.burn(
                    spec.slow_window_s, spec.budget, now
                )
                breach = (
                    st.burn_fast is not None
                    and st.burn_slow is not None
                    and st.burn_fast >= spec.threshold
                    and st.burn_slow >= spec.threshold
                )
                if breach and not st.breached:
                    st.breached = True
                    st.breach_since = now
                    self._slo_breaches[spec.name] = (
                        self._slo_breaches.get(spec.name, 0) + 1
                    )
                    ev = {
                        "time": now,
                        "type": "SLO_BREACH",
                        "severity": spec.severity,
                        "source": "INCIDENTS",
                        "message": (
                            f"SLO {spec.name} breached for {subject}: "
                            f"burn {st.burn_fast:.2f}x budget over "
                            f"{spec.fast_window_s:g}s and "
                            f"{st.burn_slow:.2f}x over "
                            f"{spec.slow_window_s:g}s"
                        ),
                        "slo": spec.name,
                        "slo_kind": spec.kind,
                        "subject": subject,
                        "target": spec.target,
                        "burn_fast": _r(st.burn_fast),
                        "burn_slow": _r(st.burn_slow),
                        **detail,
                    }
                    # lands in the cluster-event log too (note_event skips
                    # SLO_BREACH — incidents handle it right here)
                    try:
                        self._sch.record_cluster_event(
                            "SLO_BREACH",
                            ev["message"],
                            severity=spec.severity,
                            source="INCIDENTS",
                            slo=spec.name,
                            subject=subject,
                        )
                    except Exception:
                        pass
                    self._open_or_merge(
                        "SLO_BREACH",
                        f"{spec.name}:{subject}",
                        ev,
                        now,
                        source="slo",
                        slo=spec.name,
                        severity=spec.severity,
                    )
                elif st.breached:
                    cleared = (
                        st.burn_fast is None
                        or st.burn_fast < spec.threshold
                    )
                    if cleared:
                        st.breached = False
                        st.breach_since = None
                    else:
                        # still burning: keep the incident warm
                        inc = self._incidents.get(
                            self._open_key("SLO_BREACH",
                                           f"{spec.name}:{subject}")
                        )
                        if inc is not None and inc["state"] == "open":
                            inc["last_seen"] = now
        # drop state rows whose subject stopped reporting (job finished,
        # link idle, run over) so the table tracks live subjects
        stale = [
            k
            for k, st in self._slo_states.items()
            if now - st.last_sample_t > 600.0
        ]
        for k in stale:
            del self._slo_states[k]

    def _sample_slo(
        self, spec: SLOSpec, now: float
    ) -> List[Tuple[str, float, dict]]:
        """One 1 Hz badness sample per observed subject: (subject,
        badness in [0,1], detail).  All inputs are head-held state."""
        sch = self._sch
        out: List[Tuple[str, float, dict]] = []

        def want(subject: str) -> bool:
            return spec.subject in (None, "*", subject)

        if spec.kind == "job_latency_p99":
            for job, win in sch._job_latency.items():
                label = sch._job_label(job) if hasattr(sch, "_job_label") else job
                if not (want(job) or want(label)):
                    continue
                snap = win.snapshot()
                p99 = snap.get("p99")
                if p99 is None:
                    continue
                out.append(
                    (label, 1.0 if p99 > spec.target else 0.0,
                     {"p99_ms": p99, "target_ms": spec.target})
                )
        elif spec.kind in ("deployment_latency_p99", "deployment_ttft_p99"):
            metric = (
                "ray_tpu_torch_serve_request_latency_ms"
                if spec.kind == "deployment_latency_p99"
                else "ray_tpu_torch_serve_ttft_ms"
            )
            for dep, cum in self._merged_hist_by_label(metric, "deployment"):
                if not want(dep):
                    continue
                p99 = self._windowed_hist_p99(
                    (spec.name, dep), cum, spec.fast_window_s, now
                )
                if p99 is None:
                    continue
                out.append(
                    (dep, 1.0 if p99 > spec.target else 0.0,
                     {"p99_ms": p99, "target_ms": spec.target})
                )
        elif spec.kind == "deployment_availability":
            for dep, total in self._merged_counter_by_label(
                "ray_tpu_torch_serve_requests_total", "deployment"
            ):
                if not want(dep):
                    continue
                ring = self._cum_ring((spec.name, dep))
                ring.append((now, total))
                old = _ring_at(ring, now - spec.fast_window_s)
                if old is None:
                    continue
                requests = total - old
                fails = ring_count_since(
                    self._serve_failures.get(dep),
                    now - spec.fast_window_s,
                )
                if requests <= 0 and fails <= 0:
                    continue
                denom = max(requests, fails, 1)
                bad_frac = min(1.0, fails / denom)
                # availability budget: tolerated failure fraction is
                # (1 - target); badness is scaled so burn = frac/budget
                budget_frac = max(1e-9, 1.0 - spec.target)
                out.append(
                    (dep,
                     min(1.0, (bad_frac / budget_frac) * spec.budget),
                     {"failed": fails, "requests": int(requests),
                      "availability": _r(1.0 - bad_frac)})
                )
        elif spec.kind == "train_goodput_floor":
            for row in sch._train_index.list_runs():
                run = row.get("run")
                if not want(str(run)):
                    continue
                gp = row.get("goodput")
                if gp is None:
                    continue
                if row.get("status") not in (None, "running"):
                    continue
                out.append(
                    (str(run), 1.0 if gp < spec.target else 0.0,
                     {"goodput": gp, "floor": spec.target,
                      "downtime_s": row.get("downtime_s")})
                )
        elif spec.kind == "link_throughput_floor":
            min_samples = int(spec.params.get("min_samples", 3))
            for key, row in sch._net_links.items():
                if row.get("path") not in ("socket", "relay"):
                    continue
                if (row.get("samples") or 0) < min_samples:
                    continue
                ewma = row.get("ewma_gib_per_s")
                if not ewma:
                    continue
                link = f"{row['src']}->{row['dst']}"
                if not want(link):
                    continue
                out.append(
                    (link, 1.0 if ewma < spec.target else 0.0,
                     {"gib_per_s": _r(ewma), "floor": spec.target})
                )
        elif spec.kind == "actor_launch_rate_floor":
            min_pending = int(spec.params.get("min_pending", 1))
            pending = sum(
                1 for a in sch.actors.values() if a.state == "PENDING"
            )
            ring = self._cum_ring((spec.name, "cluster"))
            ring.append((now, sch._launch_done_total))
            old = _ring_at(ring, now - spec.fast_window_s)
            if old is not None and pending >= min_pending:
                rate = (sch._launch_done_total - old) / max(
                    spec.fast_window_s, 1e-9
                )
                out.append(
                    ("cluster", 1.0 if rate < spec.target else 0.0,
                     {"launches_per_s": _r(rate), "floor": spec.target,
                      "pending": pending})
                )
        return out

    # -- head-held metric readers (aggregated serve series) --

    def _merged_hist_by_label(
        self, metric: str, label: str
    ) -> List[Tuple[str, dict]]:
        entry = self._sch._metric_procs.get(metric)
        if not entry:
            return []
        merged: Dict[str, dict] = {}
        for proc_data in entry["per_proc"].values():
            for key, val in proc_data.items():
                if not isinstance(val, dict):
                    continue
                try:
                    lab = json.loads(key).get(label) or "?"
                except Exception:
                    lab = "?"
                cur = merged.get(lab)
                if cur is None or len(cur.get("buckets", ())) != len(
                    val.get("buckets", ())
                ):
                    merged[lab] = {
                        "count": val.get("count", 0),
                        "sum": val.get("sum", 0.0),
                        "buckets": list(val.get("buckets") or ()),
                        "boundaries": list(val.get("boundaries") or ()),
                    }
                else:
                    cur["count"] += val.get("count", 0)
                    cur["sum"] += val.get("sum", 0.0)
                    cur["buckets"] = [
                        a + b
                        for a, b in zip(cur["buckets"], val.get("buckets"))
                    ]
        return sorted(merged.items())

    def _merged_counter_by_label(
        self, metric: str, label: str
    ) -> List[Tuple[str, float]]:
        entry = self._sch._metric_procs.get(metric)
        if not entry:
            return []
        merged: Dict[str, float] = {}
        for proc_data in entry["per_proc"].values():
            for key, val in proc_data.items():
                try:
                    lab = json.loads(key).get(label) or "?"
                except Exception:
                    lab = "?"
                try:
                    merged[lab] = merged.get(lab, 0.0) + float(val)
                except (TypeError, ValueError):
                    continue
        return sorted(merged.items())

    def _cum_ring(self, key: Tuple[str, str]) -> Deque[Tuple[float, Any]]:
        ring = self._cum_rings.get(key)
        if ring is None:
            ring = self._cum_rings[key] = collections.deque(maxlen=900)
        return ring

    def _windowed_hist_p99(
        self, key: Tuple[str, str], cum: dict, window_s: float, now: float
    ) -> Optional[float]:
        """p99 of the observations that landed inside the window, from the
        delta between the current cumulative histogram and the ring entry
        just older than the window."""
        ring = self._cum_ring(key)
        ring.append((now, cum))
        old = _ring_at(ring, now - window_s)
        boundaries = cum.get("boundaries") or []
        if old is None or len(old.get("buckets", ())) != len(
            cum.get("buckets", ())
        ):
            # replica restarted mid-window (counts went backwards) or no
            # baseline yet: fall back to lifetime p99
            return _hist_p99(
                int(cum.get("count", 0)), cum.get("buckets") or [],
                boundaries,
            )
        d_count = int(cum.get("count", 0)) - int(old.get("count", 0))
        if d_count < 0:
            return _hist_p99(
                int(cum.get("count", 0)), cum.get("buckets") or [],
                boundaries,
            )
        d_buckets = [
            a - b for a, b in zip(cum.get("buckets"), old.get("buckets"))
        ]
        return _hist_p99(d_count, d_buckets, boundaries)

    # ---- incident lifecycle ---------------------------------------------

    @staticmethod
    def _open_key(kind: str, subject: str) -> str:
        return f"{kind}|{subject}"

    def _open_or_merge(
        self,
        kind: str,
        subject: str,
        ev: dict,
        now: float,
        source: str,
        slo: Optional[str] = None,
        severity: Optional[str] = None,
    ) -> dict:
        """Open a new incident for (kind, subject), or merge the trigger
        into the open one (bump count, keep the newest trigger events)."""
        okey = self._open_key(kind, subject)
        inc = self._incidents.get(okey)
        if inc is not None and inc["state"] == "open":
            inc["count"] += 1
            inc["last_seen"] = now
            evs = inc["events"]
            evs.append(_slim_event(ev))
            if len(evs) > 20:
                del evs[0]
            return inc
        self._seq += 1
        inc = {
            "id": f"inc-{self._seq}",
            "kind": kind,
            "subject": subject,
            "state": "open",
            "severity": severity or ev.get("severity") or "WARNING",
            "source": source,
            "slo": slo,
            "opened_at": now,
            "last_seen": now,
            "closed_at": None,
            "duration_s": None,
            "count": 1,
            "events": [_slim_event(ev)],
            "digest": {},
            "verdict": None,
        }
        # open incidents are keyed for merge; the id is the stable handle
        self._incidents[okey] = inc
        self.opened_total[kind] = self.opened_total.get(kind, 0) + 1
        try:
            inc["digest"] = self._build_digest(inc)
        except Exception:
            logger.exception("digest assembly failed for %s", inc["id"])
        self._evict()
        self._alert("open", inc)
        try:
            self._sch.record_cluster_event(
                "INCIDENT_OPENED",
                f"incident {inc['id']} [{kind}] opened for {subject}",
                severity=inc["severity"],
                source="INCIDENTS",
                incident_id=inc["id"],
                kind=kind,
                subject=subject,
            )
        except Exception:
            pass
        return inc

    def _evict(self) -> None:
        """Bound the table: evict closed incidents oldest-first; if every
        record is somehow open, evict oldest outright."""
        while len(self._incidents) > self._max:
            victim = None
            for key, rec in self._incidents.items():
                if rec["state"] == "closed":
                    victim = key
                    break
            if victim is None:
                victim = next(iter(self._incidents))
            del self._incidents[victim]

    def _cleared(self, inc: dict, now: float) -> bool:
        """Kind-specific recovery check — quiet time alone is not enough
        for conditions the head can still observe as bad."""
        kind, subject = inc["kind"], inc["subject"]
        sch = self._sch
        if kind == "SLO_BREACH":
            name, _, subj = subject.partition(":")
            st = self._slo_states.get((name, subj))
            spec = self._slos.get(name)
            if st is None or spec is None:
                return True
            return not st.breached
        if kind == "SLOW_LINK":
            for row in sch._net_links.values():
                if f"{row['src']}->{row['dst']}" == subject and row.get(
                    "slow"
                ):
                    return False
            return True
        if kind == "OBJECT_LEAK_SUSPECT":
            return subject not in sch._leak_suspects
        if kind == "ACTOR_LAUNCH_STALLED":
            stage = subject.split("@", 1)[0]
            for a in sch.actors.values():
                if a.state == "PENDING" and a.launch_stage == stage:
                    since = a.stage_ts.get(stage)
                    warn = float(
                        getattr(self._cfg, "actor_launch_warn_s", 30.0)
                        or 30.0
                    )
                    if since is not None and time.time() - since > warn:
                        return False
            return True
        return True  # event-burst kinds recover by going quiet

    def _check_closes(self, now: float) -> None:
        for inc in list(self._incidents.values()):
            if inc["state"] != "open":
                continue
            quiet = now - inc["last_seen"]
            if quiet < self._quiet_close_s:
                continue
            if not self._cleared(inc, now):
                inc["last_seen"] = now - self._quiet_close_s / 2
                continue
            inc["state"] = "closed"
            inc["closed_at"] = now
            inc["duration_s"] = round(now - inc["opened_at"], 3)
            try:
                inc["digest"] = self._build_digest(inc)
            except Exception:
                logger.exception("digest refresh failed for %s", inc["id"])
            inc["verdict"] = self._verdict(inc)
            self.closed_total += 1
            self._alert("close", inc)
            try:
                self._sch.record_cluster_event(
                    "INCIDENT_CLOSED",
                    f"incident {inc['id']} [{inc['kind']}] closed after "
                    f"{inc['duration_s']:.1f}s: {inc['verdict']}",
                    severity="INFO",
                    source="INCIDENTS",
                    incident_id=inc["id"],
                    kind=inc["kind"],
                    subject=inc["subject"],
                    duration_s=inc["duration_s"],
                )
            except Exception:
                pass

    def _alert(self, action: str, inc: dict) -> None:
        if not self._alert_dedup.should_fire((inc["id"], action)):
            return
        self.sinks.emit(
            {
                "action": action,
                "time": time.time(),
                **self.summary_row(inc),
                "verdict": inc.get("verdict"),
            }
        )

    # ---- cross-plane digest ---------------------------------------------

    def _build_digest(self, inc: dict) -> dict:
        """Join the planes around this incident by subject, trace id, and
        time.  Every section is optional; ``planes`` lists the non-empty
        ones (the chaos acceptance asserts >= 3)."""
        sch = self._sch
        kind, subject = inc["kind"], inc["subject"]
        t_lo = inc["opened_at"] - self._event_window_s
        t_hi = (inc.get("closed_at") or inc["last_seen"]) + self._event_window_s
        digest: dict = {}

        # failure-forensics plane: correlated cluster events in the window
        with sch._cluster_event_lock:
            evs = [
                ev
                for ev in sch._cluster_events
                if t_lo <= ev.get("time", 0) <= t_hi
                and ev.get("type") not in ("INCIDENT_OPENED",
                                           "INCIDENT_CLOSED")
            ]
        digest["events"] = [_slim_event(e) for e in evs[-50:]]

        # tracing plane: exemplar traces named by the trigger events (or,
        # for leaks, by the leaking objects' creation provenance)
        trace_ids: List[str] = []
        for ev in inc["events"]:
            tid = ev.get("trace_id")
            if tid:
                trace_ids.append(tid)
            for tid in ev.get("exemplar_trace_ids") or ():
                trace_ids.append(tid)
            for oh in ev.get("exemplar_object_ids") or ():
                rec = sch._obj_prov.get(oh)
                if rec and rec.get("trace"):
                    trace_ids.append(rec["trace"])
        trace_ids = list(dict.fromkeys(t for t in trace_ids if t))[:3]
        if trace_ids:
            digest["traces"] = self._trace_slices(trace_ids)

        # memory plane: the kill-time-style snapshot (store usage + top
        # callsites) — memory pressure is the classic confounder, so every
        # digest carries it; leak incidents add their suspect row
        try:
            mem = sch.memory_forensics_snapshot(top=5)
        except Exception:
            mem = {}
        if kind == "OBJECT_LEAK_SUSPECT":
            suspect = sch._leak_suspects.get(subject)
            if suspect:
                mem = dict(mem)
                mem["leak_suspect"] = {
                    k: v for k, v in suspect.items() if k != "first_flagged"
                }
        if mem:
            digest["memory"] = mem

        # transfer plane: the offending link's ledger rows + its most
        # recent completed transfers
        if kind in ("SLOW_LINK", "OBJECT_TRANSFER_STALLED") or (
            kind == "SLO_BREACH" and "->" in subject
        ):
            link = subject.rsplit(":", 1)[-1] if kind == "SLO_BREACH" else subject
            rows = [
                r
                for r in sch._net_link_rows()
                if f"{r['src']}->{r['dst']}" == link
            ]
            recent = [
                r
                for r in list(sch._net_recent)[-100:]
                if f"{r.get('src')}->{r.get('dst')}" == link
            ][-5:]
            if rows or recent:
                digest["net"] = {"links": rows, "recent_transfers": recent}

        # training step plane: the run's goodput-ledger slice
        if kind == "TRAIN_RECOMPILE" or (
            inc.get("slo")
            and self._slos.get(inc["slo"], None) is not None
            and self._slos[inc["slo"]].kind == "train_goodput_floor"
        ):
            run = subject.rsplit(":", 1)[-1]
            rows = [
                r
                for r in sch._train_index.list_runs()
                if str(r.get("run")) == run
            ]
            if rows:
                digest["train"] = rows[0]

        # control plane: decision-ring + launch-profile entries around the
        # window (actor/worker pathologies)
        if kind in (
            "ACTOR_LAUNCH_STALLED",
            "WORKER_KILL_STORM",
            "WORKER_SPAWN_FAILED",
            "OOM",
        ) or (
            inc.get("slo")
            and inc["slo"] in self._slos
            and self._slos[inc["slo"]].kind == "actor_launch_rate_floor"
        ):
            with sch._decision_lock:
                decisions = [
                    d
                    for d in list(sch._decisions)[-200:]
                    if t_lo <= d.get("t", 0) <= t_hi
                ][-10:]
            launches = [
                r
                for r in list(sch._launch_recent)[-50:]
                if t_lo <= r.get("t", 0) <= t_hi
            ][-10:]
            ctl: dict = {}
            if decisions:
                ctl["decisions"] = decisions
            if launches:
                ctl["launches"] = launches
            streaks = {
                nid.hex()[:12]: n
                for nid, n in sch._spawn_fail_streak.items()
                if n
            }
            if streaks:
                ctl["spawn_fail_streaks"] = streaks
            if ctl:
                digest["control"] = ctl

        digest["planes"] = [
            k for k in ("events", "traces", "memory", "net", "train",
                        "control")
            if digest.get(k)
        ]
        return digest

    def _trace_slices(self, trace_ids: List[str]) -> List[dict]:
        """One pass over the bounded event log collecting every wanted
        trace's events, folded into stage-decomposed summaries."""
        from ray_tpu_torch._private.trace import build_trace

        wanted = set(trace_ids)
        by_tid: Dict[str, List[dict]] = {t: [] for t in wanted}
        for ev in self._sch._task_events:
            tid = ev.get("trace_id")
            if tid in wanted:
                by_tid[tid].append(ev)
        out = []
        for tid in trace_ids:
            try:
                tr = build_trace(by_tid[tid], tid)
            except Exception:
                continue
            if not tr.spans:
                continue
            out.append(
                {
                    "trace_id": tid,
                    "duration_ms": _r(tr.duration_ms),
                    "spans": tr.span_count(),
                    "stages": {
                        k: _r(v) for k, v in tr.stage_totals().items()
                    },
                }
            )
        return out

    # ---- verdicts -------------------------------------------------------

    def _verdict(self, inc: dict) -> str:
        """One line naming the dominant attributed cause, with a number."""
        kind = inc["kind"]
        last = inc["events"][-1] if inc["events"] else {}
        d = inc.get("digest") or {}
        dur = inc.get("duration_s") or 0.0
        if kind == "SLOW_LINK":
            return (
                f"link {inc['subject']} ran at "
                f"{last.get('gib_per_s', '?')} GiB/s vs fleet median "
                f"{last.get('fleet_median_gib_per_s', '?')} GiB/s for "
                f"{dur:.0f}s — dominant cause: degraded wire throughput on "
                f"{inc['subject']}"
            )
        if kind == "OBJECT_TRANSFER_STALLED":
            return (
                f"transfer(s) over {inc['subject']} made no byte progress "
                f"for {last.get('stalled_s', '?')}s — dominant cause: "
                f"stalled wire stage on {inc['subject']}"
            )
        if kind == "OBJECT_LEAK_SUSPECT":
            suspect = (d.get("memory") or {}).get("leak_suspect") or last
            return (
                f"callsite {inc['subject']} grew monotonically "
                f"(+{suspect.get('growth_bytes', '?')} bytes, "
                f"{suspect.get('live_count', '?')} live objects) — dominant "
                f"cause: unreleased references allocated at {inc['subject']}"
            )
        if kind == "WORKER_KILL_STORM":
            return (
                f"{last.get('deaths', inc['count'])} worker deaths on node "
                f"{inc['subject']} within {last.get('window_s', '?')}s — "
                f"dominant cause: external kill/crash burst on "
                f"{inc['subject']}"
            )
        if kind == "WORKER_SPAWN_FAILED":
            return (
                f"worker spawn failures on {inc['subject']} "
                f"(x{inc['count']}) — dominant cause: node-local spawn "
                f"environment on {inc['subject']}"
            )
        if kind == "ACTOR_LAUNCH_STALLED":
            stage = inc["subject"].split("@", 1)[0]
            return (
                f"actor creation(s) stuck in stage '{stage}' up to "
                f"{last.get('stalled_s', '?')}s — dominant cause: "
                f"'{stage}' stage on {inc['subject'].split('@', 1)[-1]}"
            )
        if kind == "TRAIN_RECOMPILE":
            return (
                f"run {inc['subject']} recompiled (x{inc['count']}) — "
                f"dominant cause: changing jit shapes/donation in run "
                f"{inc['subject']}"
            )
        if kind == "OOM":
            top = ((d.get("memory") or {}).get("top_callsites") or [{}])
            top0 = top[0] if top else {}
            return (
                f"OOM on {inc['subject']} — dominant cause: store filled "
                f"by {top0.get('callsite', 'unknown callsite')} "
                f"({top0.get('bytes', '?')} bytes)"
            )
        if kind == "STRAGGLER":
            return (
                f"task {inc['subject']} ran {last.get('elapsed_s', '?')}s "
                f"vs p95 {last.get('p95_s', '?')}s — dominant cause: "
                f"outlier execution of {inc['subject']}"
            )
        if kind == "HUNG_GET":
            return (
                f"driver get() blocked (x{inc['count']}) — dominant cause: "
                f"unfinished upstream task chain"
            )
        if kind == "SLO_BREACH":
            traces = d.get("traces") or []
            if traces and traces[0].get("stages"):
                stage, ms = max(
                    traces[0]["stages"].items(), key=lambda kv: kv[1] or 0
                )
                return (
                    f"SLO {inc['subject']} burned its budget for "
                    f"{dur:.0f}s — dominant attributed stage: {stage} "
                    f"({ms}ms of exemplar trace "
                    f"{traces[0]['trace_id'][:12]})"
                )
            detail = {
                k: v
                for k, v in last.items()
                if k in ("p99_ms", "target_ms", "goodput", "floor",
                         "gib_per_s", "availability", "launches_per_s")
            }
            return (
                f"SLO {inc['subject']} burned its budget for {dur:.0f}s "
                f"({json.dumps(detail) if detail else 'no detail'})"
            )
        return (
            f"{kind} on {inc['subject']} (x{inc['count']}) resolved after "
            f"{dur:.0f}s"
        )

    # ---- read surfaces --------------------------------------------------

    def summary_row(self, inc: dict) -> dict:
        return {
            "id": inc["id"],
            "kind": inc["kind"],
            "subject": inc["subject"],
            "state": inc["state"],
            "severity": inc["severity"],
            "source": inc["source"],
            "slo": inc["slo"],
            "opened_at": inc["opened_at"],
            "closed_at": inc["closed_at"],
            "duration_s": inc["duration_s"],
            "count": inc["count"],
            "planes": (inc.get("digest") or {}).get("planes") or [],
            "verdict": inc["verdict"],
        }

    def list_incidents(
        self,
        limit: Optional[int] = None,
        state: Optional[str] = None,
        kind: Optional[str] = None,
    ) -> List[dict]:
        rows = [
            self.summary_row(inc)
            for inc in self._incidents.values()
            if (state is None or inc["state"] == state)
            and (kind is None or inc["kind"] == kind)
        ]
        rows.sort(key=lambda r: r["opened_at"], reverse=True)
        return rows[: limit] if limit else rows

    def get(self, incident_id: str) -> Optional[dict]:
        for inc in self._incidents.values():
            if inc["id"] == incident_id:
                out = dict(inc)
                if inc["state"] == "open":
                    # open incidents re-join the planes at read time so
                    # `incidents show` is live, not open-time-stale
                    try:
                        out["digest"] = self._build_digest(inc)
                    except Exception:
                        pass
                return out
        return None

    def open_count(self) -> int:
        return sum(
            1 for i in self._incidents.values() if i["state"] == "open"
        )

    def oldest_open_age(self, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        ages = [
            now - i["opened_at"]
            for i in self._incidents.values()
            if i["state"] == "open"
        ]
        return max(ages) if ages else 0.0

    def doctor_digest(self) -> dict:
        """One-shot cluster health digest (the `ray_tpu_torch doctor` payload):
        open incidents + verdict-bearing recent closes, SLO status, top
        anomaly counters, and the store snapshot."""
        sch = self._sch
        now = time.time()
        open_rows = self.list_incidents(state="open")
        closed_rows = self.list_incidents(state="closed", limit=5)
        with sch._cluster_event_lock:
            counts = dict(sch._cluster_event_counts)
        top_events = sorted(
            counts.items(), key=lambda kv: -kv[1]
        )[:10]
        try:
            mem = sch.memory_forensics_snapshot(top=3)
        except Exception:
            mem = {}
        healthy = not open_rows and all(
            s.get("ok", True) for s in self.list_slos()
        )
        return {
            "time": now,
            "healthy": healthy,
            "open_incidents": open_rows,
            "recently_closed": closed_rows,
            "slos": self.list_slos(),
            "nodes": 1 + len(getattr(sch, "nodes", {}) or {}),
            "workers": len(getattr(sch, "workers", {}) or {}),
            "event_counts": dict(top_events),
            "watchdogs": {
                "stragglers": sch._straggler_count,
                "slow_link_events": sch._slow_link_events,
                "launch_stalled": sch._launch_stalled_total,
                "leak_events": sch._leak_events_total,
                "spawn_failed": sch._spawn_failed_total,
            },
            "store": mem,
            "alerts": {
                "emitted": dict(self.sinks.emitted),
                "failed": dict(self.sinks.failed),
            },
        }


def _slim_event(ev: dict) -> dict:
    """Trigger-event copy without unbounded payloads (digests keep 20)."""
    out = {}
    for k, v in ev.items():
        if isinstance(v, (str, int, float, bool, type(None))):
            out[k] = v
        elif isinstance(v, (list, tuple)) and len(v) <= 8:
            out[k] = list(v)
    return out


def _r(v, nd: int = 4):
    return None if v is None else round(float(v), nd)


def _ring_at(ring: Deque[Tuple[float, Any]], cutoff: float):
    """Newest ring value stamped at or before ``cutoff`` (None if the ring
    doesn't reach back that far)."""
    old = None
    for t, v in ring:
        if t <= cutoff:
            old = v
        else:
            break
    return old


def ring_count_since(ring: Optional[Deque[float]], cutoff: float) -> int:
    if not ring:
        return 0
    return sum(1 for t in ring if t >= cutoff)
