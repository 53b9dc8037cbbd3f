"""Pluggable backpressure policies + per-stage queue metrics.

Parity: ``python/ray/data/_internal/execution/backpressure_policy/`` — the
streaming executor consults a policy chain before submitting more work for a
stage. The round-4 fixed bounded window is now one policy
(:class:`ConcurrencyCapPolicy`); :class:`OutputMemoryPolicy` adds the
reference's streaming-output memory bound: a stage stops submitting while the
bytes of its produced-but-unconsumed blocks exceed the cap, so a slow sink
throttles a fast source under bounded memory.

Custom policies: append a factory to ``DataContext.backpressure_policies``;
it is called per stage as ``factory(stats)`` → policy.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional


class StageStats:
    """Per-stage queue metrics (parity: OpRuntimeMetrics): submission and
    consumption counters plus the ready-but-unconsumed byte estimate the
    memory policy throttles on."""

    def __init__(self, name: str):
        self.name = name
        self.submitted = 0
        self.consumed = 0
        self.started_at = time.monotonic()
        self.last_consumed_at = self.started_at
        self.pending: deque = deque()
        self._size_cache: Dict = {}
        # running mean of materialized block sizes: the memory policy uses
        # it to charge UNREADY in-flight tasks their expected output (the
        # reference throttles on estimated block sizes the same way)
        self.avg_block_bytes: Optional[float] = None
        self._avg_n = 0

    def observe_block(self, nbytes: int) -> None:
        self._avg_n += 1
        if self.avg_block_bytes is None:
            self.avg_block_bytes = float(nbytes)
        else:
            self.avg_block_bytes += (nbytes - self.avg_block_bytes) / self._avg_n

    @property
    def inflight(self) -> int:
        return len(self.pending)

    def ready_bytes(self) -> int:
        return self.ready_info()[0]

    def ready_info(self):
        """(bytes, count) of pending blocks whose result already
        materialized — the output queue the consumer hasn't drained."""
        from ray_tpu_torch._private.worker import get_runtime

        rt = get_runtime()
        # LOCAL readiness only: in worker processes object_ready falls back
        # to a head rpc per oid — O(window) round-trips per policy check
        # would load the very loop this plane offloads. A block that landed
        # remotely but not here reads as unready and is charged the average
        # estimate instead (conservative, still bounded).
        probe = getattr(rt, "object_ready_local", None) or rt.object_ready
        total = 0
        n = 0
        for ref in self.pending:
            oid = ref.id()
            size = self._size_cache.get(oid)
            if size is None:
                if not probe(oid):
                    continue
                size = self._block_size(rt, oid)
                self._size_cache[oid] = size
                self.observe_block(size)
            total += size
            n += 1
        return total, n

    @staticmethod
    def _block_size(rt, oid) -> int:
        try:
            entry = None
            ms = getattr(getattr(rt, "scheduler", None), "memory_store", None)
            if ms is not None:
                entry = ms.get_entry(oid)
            if entry is not None and entry[0] == "inline":
                return len(entry[1])
            store = getattr(rt, "store", None) or getattr(
                getattr(rt, "node", None), "store_client", None
            )
            if store is not None:
                mv = store.get(oid, timeout=0)
                if mv is not None:
                    n = mv.nbytes
                    del mv
                    return n
        except Exception:
            pass
        return 0

    def snapshot(self) -> dict:
        return {
            "stage": self.name,
            "submitted": self.submitted,
            "consumed": self.consumed,
            "inflight": self.inflight,
            "ready_bytes": self.ready_bytes(),
            "wall_s": round(self.last_consumed_at - self.started_at, 4),
        }

    def render(self) -> str:
        """One human line for Dataset.stats() (parity: the reference's
        per-operator stats summary)."""
        wall = self.last_consumed_at - self.started_at
        avg = (
            f", avg_block={int(self.avg_block_bytes):,}B"
            if self.avg_block_bytes
            else ""
        )
        rate = f", {self.consumed / wall:.1f} blocks/s" if wall > 1e-6 else ""
        return (
            f"{self.name}: {self.consumed} blocks in {wall:.2f}s"
            f"{rate}{avg}"
        )


class BackpressurePolicy:
    """Decides whether a stage may submit one more block task."""

    def can_submit(self, stats: StageStats) -> bool:  # pragma: no cover
        return True


class ConcurrencyCapPolicy(BackpressurePolicy):
    """The bounded in-flight window (parity:
    ``ConcurrencyCapBackpressurePolicy``)."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))

    def can_submit(self, stats: StageStats) -> bool:
        return stats.inflight < self.cap


class OutputMemoryPolicy(BackpressurePolicy):
    """Stop submitting while this stage's outstanding output exceeds the
    byte cap (parity: ``StreamingOutputBackpressurePolicy``). Ready blocks
    count their true size; UNREADY in-flight tasks are charged the running
    average block size — without the estimate, every task would be
    submitted before the first result lands and the cap could never bind.
    At least one block is always allowed so the pipeline cannot deadlock;
    until the first block calibrates the average, one task at a time runs."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)

    def can_submit(self, stats: StageStats) -> bool:
        if stats.inflight == 0:
            return True
        ready_b, ready_n = stats.ready_info()
        avg = stats.avg_block_bytes
        if avg is None:
            return False  # calibrating: serialize until a size is known
        est = ready_b + (stats.inflight - ready_n) * avg
        return est < self.max_bytes


def build_policies(stats: StageStats, window: int) -> List[BackpressurePolicy]:
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    policies: List[BackpressurePolicy] = [ConcurrencyCapPolicy(window)]
    if ctx.max_inflight_bytes:
        policies.append(OutputMemoryPolicy(ctx.max_inflight_bytes))
    for factory in ctx.backpressure_policies or ():
        policies.append(factory(stats))
    return policies


# stats of recent pipeline compositions (driver-side observability; each
# entry stays live while its stage streams)
last_execution_stats: List[StageStats] = []
_STATS_KEEP = 64


def track_stats(stats: StageStats) -> None:
    """Register a stage's stats, pruning old executions so a long-lived
    driver running many pipelines doesn't accumulate them forever."""
    last_execution_stats.append(stats)
    if len(last_execution_stats) > _STATS_KEEP:
        del last_execution_stats[: len(last_execution_stats) - _STATS_KEEP]
