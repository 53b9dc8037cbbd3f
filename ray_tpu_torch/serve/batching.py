"""Dynamic request batching.

Parity: ``python/ray/serve/batching.py`` (``@serve.batch``) — concurrent calls
inside a threaded replica are coalesced: the first caller becomes the batch
leader, waits ``batch_wait_timeout_s`` (or until ``max_batch_size``), runs the
wrapped function once on the gathered list, and distributes results. On the
card this is the path to full-batch inference steps.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[dict] = []
        self._leader_active = False

    def call(self, instance, item):
        entry = {"item": item, "done": threading.Event(), "result": None, "error": None}
        with self._cv:
            self._queue.append(entry)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
            else:
                self._cv.notify_all()
        if lead:
            self._run_leader(instance)
        entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def _run_leader(self, instance):
        # the leader keeps draining batches until the queue is empty, then
        # steps down — so requests queued behind the first batch are never
        # stranded leaderless
        while True:
            deadline = time.monotonic() + self.timeout
            with self._cv:
                while len(self._queue) < self.max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._queue[: self.max_batch_size]
                self._queue = self._queue[self.max_batch_size :]
                more = bool(self._queue)
                if not more:
                    self._leader_active = False
            if batch:
                self._process(batch, instance)
            if not more:
                return

    def _process(self, batch, instance):
        try:
            items = [e["item"] for e in batch]
            if instance is not None:
                results = self.fn(instance, items)
            else:
                results = self.fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"batched function returned {len(results)} results for {len(items)} inputs"
                )
            for e, r in zip(batch, results):
                e["result"] = r
        except Exception as err:  # noqa: BLE001
            for e in batch:
                e["error"] = err
        finally:
            for e in batch:
                e["done"].set()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: coalesce concurrent calls into one list-call.

    The batcher (which holds locks/conditions) is created lazily in the
    process that executes calls, so decorated classes stay cloudpicklable
    into replicas. Creation is GIL-atomic (list.append); a lost race only
    orphans a never-used batcher — no module-global lock, because cloudpickle
    captures closure-referenced globals by value.
    """

    def wrap(fn):
        holder: list = []

        @functools.wraps(fn)
        def method(self_or_item, *rest):
            if not holder:
                from ray_tpu_torch.serve.batching import _Batcher as B

                holder.append(B(fn, max_batch_size, batch_wait_timeout_s))
            batcher = holder[0]
            if rest:  # bound method: (self, item)
                return batcher.call(self_or_item, rest[0])
            return batcher.call(None, self_or_item)

        return method

    if _fn is not None:
        return wrap(_fn)
    return wrap
