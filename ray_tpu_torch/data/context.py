"""DataContext: execution options for Dataset pipelines.

Parity: ``python/ray/data/context.py`` (``DataContext.get_current``) — the
knobs that matter for the streaming executor's backpressure: the bounded
in-flight window (blocks) that caps memory while a consumer iterates.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class DataContext:
    # max result-pending block tasks in flight per consuming iterator
    # (becomes the ConcurrencyCapPolicy of the pluggable policy chain,
    # parity: backpressure_policy/concurrency_cap_backpressure_policy.py)
    max_inflight_blocks: int = 4
    # cap on ready-but-unconsumed output bytes per stage; 0 = unbounded
    # (parity: StreamingOutputBackpressurePolicy — a slow sink throttles a
    # fast source under this memory bound)
    max_inflight_bytes: int = 0
    # extra policy factories, each called per stage as factory(stats)
    # -> BackpressurePolicy (see data/backpressure.py)
    backpressure_policies: list = None
    # rows per block targeted by repartition-by-size paths
    target_block_rows: int = 65536

    _local = threading.local()

    @classmethod
    def get_current(cls) -> "DataContext":
        ctx = getattr(cls._local, "ctx", None)
        if ctx is None:
            ctx = cls._local.ctx = cls()
        return ctx


class ActorPoolStrategy:
    """Compute strategy for ``map_batches``: run the transform in a pool of
    long-lived actors instead of stateless tasks (parity:
    ``ActorPoolMapOperator``, execution/operators/actor_pool_map_operator.py).
    Useful when the fn has expensive setup (model weights). With
    ``max_size > size`` the pool autoscales under backlog (parity:
    ``execution/autoscaler/``)."""

    def __init__(self, size: int = 2, max_size: int = 0):
        self.size = max(1, int(size))
        self.max_size = max(self.size, int(max_size)) if max_size else self.size
