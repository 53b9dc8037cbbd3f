"""Request-trace reconstruction and critical-path analysis.

The tracing plane (``util/tracing``) mints a ``(trace_id, span_id)`` at
every entry point and stamps it on every task spec; lifecycle events from
the scheduler, execution events from workers (with measured stage
decompositions), and PROFILE spans (serve proxy/handle/replica sections,
user ``profile()`` blocks, ``jax:*`` durations) all carry those ids through
the telemetry ring. This module folds one trace's merged events back into a
cross-process span tree and decomposes end-to-end latency into

    submit -> queue_wait -> dispatch -> arg_fetch (bytes + transfer path)
    -> execute -> result_put -> stream_yield (with TTFT for streaming)

Actor-creation spans (control-plane observability) refine this: the
scheduler ships a placement/worker_spawn split that partitions
queue_wait, and the worker reports runtime_env apply and actor-class
load (import) as measured stages ahead of ``__init__`` execution.

Surfaces: ``ray_tpu_torch.trace(trace_id)`` (returns :class:`Trace`), the
``ray_tpu_torch trace`` CLI, and the dashboard's ``/api/trace`` tab.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# derived inter-state gaps, in causal order; each value is (from, to)
_GAPS = [
    ("dep_wait_ms", ("SUBMITTED", "QUEUED")),
    ("queue_wait_ms", ("QUEUED", "DISPATCHED")),
    ("dispatch_ms", ("DISPATCHED", "RUNNING")),
]

# measured worker-side stages in presentation order. runtime_env apply and
# actor-class load run before the execute timer starts, so they are additive
# (non-overlapping) with execute_ms and belong in the covered sum.
_MEASURED = [
    "runtime_env_ms",
    "actor_class_load_ms",
    "arg_fetch_ms",
    "execute_ms",
    "result_put_ms",
    "stream_yield_ms",
]

# head-measured partition of an actor creation's queue_wait (scheduler
# stamps: QUEUED -> node/slot chosen -> worker process ready); when present
# these REPLACE the coarse queue_wait_ms gap — same wall, finer cut.
_QUEUE_SPLIT = ("placement_ms", "worker_spawn_ms")


class Span:
    """One task / actor call / serve section within a trace."""

    __slots__ = (
        "span_id",
        "parent_id",
        "trace_id",
        "name",
        "kind",
        "task_id",
        "actor_id",
        "pid",
        "start",
        "end",
        "states",
        "stages",
        "attempts",
        "children",
        "extra",
    )

    def __init__(self, span_id: str, trace_id: str):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id: Optional[str] = None
        self.name: str = ""
        self.kind: str = "task"  # task | span (PROFILE section)
        self.task_id: Optional[str] = None
        self.actor_id: Optional[str] = None
        self.pid: Optional[int] = None
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.states: Dict[str, float] = {}
        self.stages: Dict[str, Any] = {}
        self.attempts: int = 0
        self.children: List["Span"] = []
        self.extra: Dict[str, Any] = {}

    # -- derived -----------------------------------------------------------

    @property
    def duration_ms(self) -> Optional[float]:
        if self.start is None or self.end is None:
            return None
        return (self.end - self.start) * 1e3

    def stage_breakdown(self) -> Dict[str, float]:
        """Causal stage decomposition in ms; keys in presentation order.
        Inter-state gaps come from event timestamps, worker stages from the
        FINISHED event's measured durations."""
        out: Dict[str, float] = {}
        split = any(k in self.stages for k in _QUEUE_SPLIT)
        for key, (a, b) in _GAPS:
            if key == "queue_wait_ms" and split:
                # actor creation: the scheduler's placement/worker_spawn
                # stamps partition this gap — swap in the finer cut in place
                for sk in _QUEUE_SPLIT:
                    v = self.stages.get(sk)
                    if v is not None:
                        out[sk] = float(v)
                continue
            if a in self.states and b in self.states:
                out[key] = max(0.0, (self.states[b] - self.states[a]) * 1e3)
        for key in _MEASURED:
            v = self.stages.get(key)
            if v is not None:
                out[key] = float(v)
        # execution residue: RUNNING->FINISHED wall not covered by measured
        # stages (deserialize, loop overhead); keeps the sum honest
        if "RUNNING" in self.states and self.end is not None:
            run_wall = (self.end - self.states["RUNNING"]) * 1e3
            covered = sum(out.get(k, 0.0) for k in _MEASURED)
            residue = run_wall - covered
            if residue > 0.05 and any(k in out for k in _MEASURED):
                out["other_ms"] = residue
            elif not any(k in out for k in _MEASURED):
                out["execute_ms"] = max(0.0, run_wall)
        return out

    def to_dict(self) -> dict:
        d = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "name": self.name,
            "kind": self.kind,
            "task_id": self.task_id,
            "actor_id": self.actor_id,
            "pid": self.pid,
            "start": self.start,
            "end": self.end,
            "duration_ms": self.duration_ms,
            "attempts": self.attempts,
            "states": dict(self.states),
            "stages": dict(self.stages),
            "breakdown": {
                k: round(v, 3) for k, v in self.stage_breakdown().items()
            },
            "children": [c.to_dict() for c in self.children],
        }
        if self.extra:
            d["extra"] = dict(self.extra)
        return d


class Trace:
    """A reconstructed request: span tree + critical-path decomposition."""

    def __init__(self, trace_id: str, spans: Dict[str, Span], roots: List[Span]):
        self.trace_id = trace_id
        self.spans = spans
        self.roots = roots

    @property
    def start(self) -> Optional[float]:
        starts = [s.start for s in self.spans.values() if s.start is not None]
        return min(starts) if starts else None

    @property
    def end(self) -> Optional[float]:
        ends = [s.end for s in self.spans.values() if s.end is not None]
        return max(ends) if ends else None

    @property
    def duration_ms(self) -> Optional[float]:
        if self.start is None or self.end is None:
            return None
        return (self.end - self.start) * 1e3

    def span_count(self) -> int:
        return len(self.spans)

    def critical_path(self) -> List[dict]:
        """Greedy walk from the latest-finishing root: at each span, descend
        into the child whose end time is latest (the one the parent's
        completion actually waited on). Returns one row per span on the
        path with its stage breakdown."""
        path: List[dict] = []
        if not self.roots:
            return path
        cur = max(
            self.roots, key=lambda s: (s.end or s.start or 0.0)
        )
        seen = set()
        while cur is not None and cur.span_id not in seen:
            seen.add(cur.span_id)
            path.append(
                {
                    "span_id": cur.span_id,
                    "name": cur.name,
                    "duration_ms": cur.duration_ms,
                    "breakdown": {
                        k: round(v, 3)
                        for k, v in cur.stage_breakdown().items()
                    },
                }
            )
            nxt = None
            for c in cur.children:
                if c.end is None:
                    continue
                if nxt is None or c.end > (nxt.end or 0.0):
                    nxt = c
            cur = nxt
        return path

    def stage_totals(self) -> Dict[str, float]:
        """Stage sums across every span (coarse where-does-time-go view;
        note parallel child spans sum beyond wall time by design)."""
        totals: Dict[str, float] = {}
        for s in self.spans.values():
            for k, v in s.stage_breakdown().items():
                totals[k] = totals.get(k, 0.0) + v
        return {k: round(v, 3) for k, v in totals.items()}

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": self.duration_ms,
            "spans": self.span_count(),
            "tree": [r.to_dict() for r in self.roots],
            "critical_path": self.critical_path(),
            "stage_totals": self.stage_totals(),
        }

    # -- rendering ---------------------------------------------------------

    def summary(self) -> str:
        out = [
            f"trace {self.trace_id}  spans={self.span_count()}  "
            f"wall={_fmt_ms(self.duration_ms)}"
        ]
        t0 = self.start or 0.0
        for root in sorted(self.roots, key=lambda s: s.start or 0.0):
            self._render(root, t0, out, depth=0)
        cp = self.critical_path()
        if cp:
            out.append("critical path:")
            for row in cp:
                bd = "  ".join(
                    f"{k.replace('_ms', '')}={v:g}ms"
                    for k, v in row["breakdown"].items()
                )
                out.append(
                    f"  {row['name']}  {_fmt_ms(row['duration_ms'])}"
                    + (f"  [{bd}]" if bd else "")
                )
        return "\n".join(out)

    def _render(self, span: Span, t0: float, out: List[str], depth: int):
        pad = "  " * depth
        offset = (
            f"+{(span.start - t0) * 1e3:.1f}ms"
            if span.start is not None
            else "?"
        )
        bd = span.stage_breakdown()
        bd_str = "  ".join(
            f"{k.replace('_ms', '')}={v:g}ms" for k, v in bd.items()
        )
        extra = ""
        for key in ("queue_wait_ms", "ttft_ms"):
            if span.extra.get(key) is not None:
                extra += f"  {key.replace('_ms', '')}={span.extra[key]:g}ms"
        if span.extra.get("status") is not None:
            extra += f"  status={span.extra['status']}"
        # transfer plane: wire spans name the link they crossed and the
        # measured rate (which link a slow arg_fetch paid for)
        if span.extra.get("link"):
            extra += f"  link={span.extra['link']}"
        if span.extra.get("gib_per_s") is not None:
            extra += f"  {span.extra['gib_per_s']:g}GiB/s"
        if span.extra.get("hop"):
            extra += f"  hop={span.extra['hop']}"
        if span.stages.get("arg_bytes"):
            paths = span.stages.get("arg_paths") or {}
            path_str = ",".join(f"{p}:{n}" for p, n in sorted(paths.items()))
            extra += f"  args={span.stages['arg_bytes']}B({path_str})"
        if span.stages.get("first_yield_ms") is not None:
            extra += f"  ttft={span.stages['first_yield_ms']:g}ms"
        if span.attempts > 1:
            extra += f"  attempts={span.attempts}"
        out.append(
            f"{pad}- {span.name or span.span_id[:8]}  {offset}  "
            f"{_fmt_ms(span.duration_ms)}"
            + (f"  [{bd_str}]" if bd_str else "")
            + extra
        )
        for c in sorted(span.children, key=lambda s: s.start or 0.0):
            self._render(c, t0, out, depth + 1)


def _fmt_ms(v: Optional[float]) -> str:
    if v is None:
        return "?"
    return f"{v:.1f}ms" if v < 10_000 else f"{v / 1e3:.2f}s"


# worker-recorded states win over head-side records of the same state (real
# pids + wall-clock execution bounds); terminal states end the span
_TERMINAL = ("FINISHED", "FAILED")


def build_trace(events: List[dict], trace_id: str) -> Trace:
    """Fold one trace's merged telemetry events into a span tree."""
    spans: Dict[str, Span] = {}
    for ev in events:
        if ev.get("trace_id") != trace_id:
            continue
        span_id = ev.get("span_id")
        if not span_id:
            continue
        s = spans.get(span_id)
        if s is None:
            s = spans[span_id] = Span(span_id, trace_id)
        if ev.get("parent_id"):
            s.parent_id = ev["parent_id"]
        state = ev.get("state")
        ts = ev.get("time")
        if ev.get("type") == "PROFILE":
            # a PROFILE section IS a span (serve proxy/handle sections, user
            # profile() blocks). task:* wrapper spans only refine the task
            # span's bounds — their ids equal the task's span id, so the
            # name/kind of real task events below still win.
            if s.kind != "task" or not s.states:
                s.kind = "span"
                s.name = s.name or ev.get("name") or ""
            if ts is not None:
                s.start = ts if s.start is None else min(s.start, ts)
            end = ev.get("end_time")
            if end is None and ts is not None and ev.get("duration_ms"):
                end = ts + ev["duration_ms"] / 1e3
            if end is not None:
                s.end = end if s.end is None else max(s.end, end)
            for k, v in (ev.get("extra") or {}).items():
                if k not in ("trace_id", "span_id", "parent_id"):
                    s.extra.setdefault(k, v)
            continue
        s.kind = "task"
        s.name = ev.get("name") or s.name
        s.task_id = ev.get("task_id") or s.task_id
        s.actor_id = ev.get("actor_id") or s.actor_id
        if ev.get("pid") and ev.get("src") == "worker":
            s.pid = ev["pid"]
        if state and ts is not None:
            prev = s.states.get(state)
            worker = ev.get("src") == "worker"
            if state == "RUNNING" and worker:
                # one worker RUNNING record per execution attempt (head-side
                # RUNNING mirrors dispatch and must not count)
                s.attempts += 1
            # worker-sourced timestamps win; otherwise keep the EARLIEST
            # (retries re-record states — the span covers the whole request)
            if prev is None or worker:
                if state in _TERMINAL or state == "RUNNING":
                    # retried attempt: latest terminal/running wins
                    s.states[state] = ts if prev is None else max(prev, ts)
                else:
                    s.states[state] = min(prev, ts) if prev is not None else ts
            if state == "SUBMITTED":
                s.start = ts if s.start is None else min(s.start, ts)
            if state in _TERMINAL:
                s.end = ts if s.end is None else max(s.end, ts)
        if ev.get("stages"):
            s.stages.update(ev["stages"])
    # anchor spans missing explicit bounds
    for s in spans.values():
        if s.start is None and s.states:
            s.start = min(s.states.values())
        if s.end is None and s.states:
            s.end = max(s.states.values())
        if s.kind == "task" and s.attempts == 0 and "RUNNING" in s.states:
            s.attempts = 1  # head-relayed execution (no worker event yet)
    # tree links
    roots: List[Span] = []
    for s in spans.values():
        parent = spans.get(s.parent_id) if s.parent_id else None
        if parent is not None and parent is not s:
            parent.children.append(s)
        else:
            roots.append(s)
    return Trace(trace_id, spans, roots)
