"""Transfer-plane observability: read records + link health.

Answers "where did the *wire* go" the way the tracing plane answers
"where did the *time* go", the memory plane "where did the *bytes*
go", and the step plane "where did the *step* go". Parity: the
reference's per-chunk PushManager / ObjectBufferPool accounting
(``push_manager.h:30``, ``object_buffer_pool.h:41``).

Capture follows the memory plane's ride-existing-messages rule — no new
RPCs on the read path:

* **worker-side read records** — zero-copy peer-arena reads and
  spill-restores (no completion message exists for these) ride the
  telemetry batch ring (``TelemetryBuffer.record_transfer``), gated by a
  size floor so small-object gets stay unrecorded;
* **wire trace spans** — a worker blocked in arg-fetch records a
  ``wire:<path>`` PROFILE span under its task's active trace context.

Scheduler-side consumers: the bounded link ledger (``_net_links``), the
1 Hz slow-link watchdog and ``state.list_links`` /
``state.summarize_transfers`` (see ``Scheduler._net_watchdog_scan``).
Socket transfers between hosts belong to cluster mode, a later slice of
this port.
"""

from __future__ import annotations

import os
import time
from typing import Optional

# transfer paths (ledger key vocabulary)
PATH_SOCKET = "socket"
PATH_SHM_PEER = "shm_peer"
PATH_SPILL = "spill"
PATH_RELAY = "relay"

# stage keys every record may carry (ms; presentation order)
STAGE_KEYS = ("dial_ms", "request_ms", "first_byte_wait_ms", "wire_ms",
              "seal_ms")

# (runtime identity, verdict) — memoized like memplane: this check sits on
# read hot paths
_enabled_cache: tuple = (None, False)


def _runtime_cfg():
    from ray_tpu_torch._private import telemetry

    rt = telemetry._runtime()
    return getattr(rt, "config", None) if rt is not None else None


def enabled() -> bool:
    """Transfer plane on? Read from the connected runtime's config
    (memoized per runtime — read hot path)."""
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
        getattr(cfg, "transfer_plane_enabled", True)
    )
    _enabled_cache = (rt, verdict)
    return verdict


def min_record_bytes() -> int:
    cfg = _runtime_cfg()
    return int(getattr(cfg, "net_min_record_bytes", 256 * 1024))


# --------------------------------------------------------------------------
# worker-side read records + wire trace spans
# --------------------------------------------------------------------------


def _mint_span_id() -> str:
    return os.urandom(8).hex()


def record_read(
    path: str,
    oid,
    nbytes: int,
    wire_s: float,
    src_shm_dir: str = "",
    t0: Optional[float] = None,
) -> None:
    """One zero-copy peer-arena read or spill-restore completed in this
    process: ship a compact ledger record through the telemetry ring
    (these paths have no completion message to ride). Size-floored so
    small-object gets don't flood the batch pipeline."""
    if not enabled() or int(nbytes) < min_record_bytes():
        return
    try:
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch.util import tracing

        # compact positional record, decoded scheduler-side:
        # (path, oid_bin, bytes, wire_s, t0, src_shm_dir, trace_id)
        rec = (
            path,
            oid.binary() if hasattr(oid, "binary") else bytes(oid),
            int(nbytes),
            float(wire_s),
            float(t0 if t0 is not None else time.time() - wire_s),
            src_shm_dir or "",
            tracing.current_trace_id(),
        )
        if telemetry._runtime() is None:
            return
        buf = telemetry.get_buffer()
        buf.record_transfer(rec)
        buf.ensure_flusher()
    except Exception:
        pass  # observability must never fail the data path


def record_wire_span(
    path: str,
    nbytes: int,
    t0: float,
    duration_s: float,
    oid=None,
    link: str = "",
    with_rate: bool = True,
) -> None:
    """Record a ``wire:<path>`` PROFILE span under the CURRENT trace
    context (the task span whose arg_fetch blocked on this read), so
    ``ray_tpu_torch.trace(id)`` shows which path a slow fetch crossed even when
    the transfer itself ran in another process."""
    if not enabled() or duration_s < 0.001:
        return
    try:
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch.util import tracing

        ctx = tracing.get_current_context()
        if ctx is None:
            return
        extra = {
            "trace_id": ctx.trace_id,
            "span_id": _mint_span_id(),
            "parent_id": ctx.span_id,
            "path": path,
            "bytes": int(nbytes),
        }
        if link:
            extra["link"] = link
        # with_rate=False: the span covers a BLOCKED-READ window (polls
        # included), not a wire — a rate derived from it would mislead;
        # the scheduler's transfer span carries the authoritative GiB/s
        if with_rate and duration_s > 0 and nbytes:
            extra["gib_per_s"] = round(nbytes / 2**30 / duration_s, 4)
        if oid is not None:
            extra["object_id"] = oid.hex() if hasattr(oid, "hex") else str(oid)
        telemetry.record_span(
            {
                "event": f"wire:{path}",
                "start": t0,
                "end": t0 + duration_s,
                "duration_ms": duration_s * 1e3,
                "pid": os.getpid(),
                "extra": extra,
            }
        )
    except Exception:
        pass


def finish_blocked_read(
    path: str,
    nbytes: int,
    t_wall0: float,
    t_perf0: float,
    peer_dur: float,
    peer_dir: str,
    oid,
) -> None:
    """Shared tail of the driver/worker blocked-read window (worker.py and
    worker_process.py time the same state machine): emit the
    ``wire:<path>`` trace span — no rate: the window includes polls, and a
    zero-copy mapping moves no bytes; the scheduler's transfer span
    carries the authoritative GiB/s — and, for zero-copy peer reads (which
    have no completion message), the ledger byte record. No-op for a plain
    local-shm hit."""
    if path == "shm":
        return
    dur = time.perf_counter() - t_perf0
    record_wire_span(
        path, nbytes, t_wall0,
        peer_dur if path == "shm_peer" and peer_dur > 0 else dur,
        oid=oid, with_rate=False,
    )
    if path == "shm_peer":
        record_read(
            "shm_peer", oid, nbytes, peer_dur or dur,
            src_shm_dir=peer_dir, t0=t_wall0,
        )


