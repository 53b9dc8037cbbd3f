"""ActorPool: map work over a fixed set of actors.

Parity: ``python/ray/util/actor_pool.py`` (API surface only; the
bookkeeping here is sequence-number based rather than index/future maps).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    """Round-robins ``fn(actor, value)`` calls over a fixed actor fleet.

    Internally each submission gets a monotonically increasing sequence
    number; ``get_next`` emits results in sequence order while
    ``get_next_unordered`` emits whichever future lands first.
    """

    def __init__(self, actors: List[Any]):
        self._available = deque(actors)
        # seq -> future, and future -> (seq, actor) for the reverse hop.
        self._by_seq: dict = {}
        self._inflight: dict = {}
        self._submit_seq = 0
        self._emit_seq = 0
        self._backlog: deque = deque()

    def submit(self, fn: Callable, value: Any) -> None:
        if not self._available:
            self._backlog.append((fn, value))
            return
        actor = self._available.pop()
        future = fn(actor, value)
        seq = self._submit_seq
        self._submit_seq += 1
        self._by_seq[seq] = future
        self._inflight[future] = (seq, actor)

    def has_next(self) -> bool:
        return bool(self._by_seq) or bool(self._backlog)

    def get_next(self, timeout=None) -> Any:
        future = self._by_seq.pop(self._emit_seq, None)
        if future is None:
            raise StopIteration("no pending results")
        self._emit_seq += 1
        value = ray_tpu_torch.get(future, timeout=timeout)
        self._recycle(future)
        return value

    def get_next_unordered(self, timeout=None) -> Any:
        if not self._inflight:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        seq, _actor = self._inflight[future]
        self._by_seq.pop(seq, None)
        value = ray_tpu_torch.get(future)
        self._recycle(future)
        return value

    def _recycle(self, future):
        _seq, actor = self._inflight.pop(future)
        self._available.append(actor)
        if self._backlog:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self._inflight or self._backlog:
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._available)

    def pop_idle(self):
        return self._available.pop() if self._available else None

    def push(self, actor):
        self._available.append(actor)
