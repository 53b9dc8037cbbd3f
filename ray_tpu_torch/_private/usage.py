"""Usage stats: opt-out local usage recording.

Parity: ``python/ray/_private/usage/usage_lib.py:20`` — tag recording and a
usage report. The reference phones home unless opted out; this environment has
no egress, so the report is written to the session dir only (the schema-level
behavior — tags, library usage, cluster metadata — is what matters for API
parity). Opt out with ``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_tags: Dict[str, str] = {}
_library_usages: set = set()


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") not in ("0", "false")


def record_extra_usage_tag(key: str, value: str) -> None:
    """Parity: ``usage_lib.record_extra_usage_tag``."""
    if not usage_stats_enabled():
        return
    with _lock:
        _tags[str(key)] = str(value)


def record_library_usage(library: str) -> None:
    """Parity: ``usage_lib.record_library_usage`` (data/train/tune/serve/rl)."""
    if not usage_stats_enabled():
        return
    with _lock:
        _library_usages.add(str(library))


def get_usage_report() -> Dict:
    import ray_tpu_torch

    with _lock:
        return {
            "schema_version": "0.1",
            "timestamp": time.time(),
            "ray_tpu_torch_version": getattr(ray_tpu_torch, "__version__", "dev"),
            "libraries_used": sorted(_library_usages),
            "extra_usage_tags": dict(_tags),
            "total_num_cpus": os.cpu_count(),
        }


def write_usage_report(session_dir: str) -> str:
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as fh:
            json.dump(get_usage_report(), fh, indent=2)
    except OSError:
        pass
    return path


def reset_for_test() -> None:
    with _lock:
        _tags.clear()
        _library_usages.clear()
