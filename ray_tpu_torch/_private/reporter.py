"""Per-node stats collection + in-process stack sampling.

Parity: the dashboard reporter agent
(``python/ray/dashboard/modules/reporter/reporter_agent.py:314``) — each
node pushes cpu/mem/object-store stats to the head on its heartbeat, and
answers stack-dump / py-spy-style sampling requests. py-spy itself is not in
this offline image, so sampling reads ``sys._current_frames`` of the python
process (daemon + its in-process threads); one-shot dumps fan out to worker
processes through their pipes.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, Optional, Tuple

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_cpu_total() -> Optional[Tuple[int, int]]:
    """(busy_jiffies, total_jiffies) from /proc/stat, or None off-Linux."""
    try:
        with open("/proc/stat") as fh:
            parts = fh.readline().split()
        vals = [int(x) for x in parts[1:11]]
        total = sum(vals)
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def cpu_percent(prev: Optional[Tuple[int, int]], cur: Optional[Tuple[int, int]]) -> float:
    if not prev or not cur:
        return 0.0
    busy = cur[0] - prev[0]
    total = cur[1] - prev[1]
    return round(100.0 * busy / total, 1) if total > 0 else 0.0


def memory_stats() -> Dict[str, int]:
    out = {"mem_total": 0, "mem_available": 0}
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    out["mem_total"] = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    out["mem_available"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    return out


def process_rss() -> int:
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class StatsCollector:
    """Holds the cpu-delta state between heartbeats."""

    def __init__(self):
        self._prev_cpu = read_cpu_total()

    def collect(self, store=None, extra: Optional[dict] = None) -> dict:
        cur = read_cpu_total()
        stats = {
            "cpu_percent": cpu_percent(self._prev_cpu, cur),
            "rss_bytes": process_rss(),
            **memory_stats(),
        }
        self._prev_cpu = cur
        if store is not None:
            try:
                stats["object_store_bytes"] = int(store.usage_bytes())
            except Exception:
                pass
        if extra:
            stats.update(extra)
        return stats


def sample_stacks(duration_s: float, interval_s: float = 0.01) -> Dict[str, int]:
    """py-spy-style sampling of THIS process: aggregate thread stacks over
    ``duration_s`` into {rendered_stack: sample_count}, hottest first."""
    counts: Dict[str, int] = {}
    names = {}
    deadline = time.monotonic() + max(0.01, duration_s)
    me = threading.get_ident()
    while time.monotonic() < deadline:
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = traceback.extract_stack(frame)
            rendered = ";".join(
                f"{os.path.basename(f.filename)}:{f.name}:{f.lineno}"
                for f in stack[-12:]
            )
            key = f"[{names.get(tid, tid)}] {rendered}"
            counts[key] = counts.get(key, 0) + 1
        time.sleep(interval_s)
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
