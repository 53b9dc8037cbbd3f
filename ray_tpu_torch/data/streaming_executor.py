"""Streaming executor: a concurrent operator pipeline over bounded windows.

Parity: ``python/ray/data/_internal/execution/streaming_executor.py:48`` (the
operator loop at ``:270``) + the backpressure policies — redesigned around
object-ref future-chaining instead of a scheduler thread:

* a *stage* transforms a stream of block refs into a stream of block refs;
* task stages submit downstream tasks on upstream refs **without waiting**
  (refs are futures — the cluster scheduler starts the consumer task the
  moment its input lands), so every stage of the pipeline runs concurrently
  on workers while the driver merely tops up submission windows;
* each stage keeps at most ``DataContext.max_inflight_blocks`` (scaled by
  pool size for actor stages) results outstanding — the backpressure bound
  that lets arbitrarily large datasets stream through bounded memory;
* the rare driver-side stage (rebatch) prefetches a window of upstream refs
  so workers stay busy while the driver re-slices.

Stage kinds mirror the reference's physical operators: ``SourceStage`` =
InputDataBuffer + bounded read-task submission, ``TaskMapStage`` =
TaskPoolMapOperator (with op *fusion* — a chain of map/filter/flat_map runs
as ONE task per block), ``ActorMapStage`` = ActorPoolMapOperator,
``RebatchStage`` = the output-splitting/batching operators.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Batch,
    block_num_rows,
    concat_blocks,
    normalize_block,
    slice_block,
)


@dataclass
class ReadTask:
    """A lazy source block: ``fn.remote(*args)`` produces the block. Kept
    unsubmitted until the executor's source window has room, so reading a
    100k-file dataset does not flood the cluster with 100k tasks.

    ``supports_columns`` marks readers that can prune columns at the file
    (parquet): the logical optimizer pushes a leading select into
    ``columns`` so pruned data never leaves the source (parity: projection
    pushdown, ``_internal/logical/rules/``)."""

    fn: Any  # a ray_tpu_torch remote function
    args: Tuple
    columns: Optional[List[str]] = None
    supports_columns: bool = False

    def submit(self):
        # name-tagged so the transfer plane's by-task-name ledger rows give
        # per-operator cross-node bytes (summarize_transfers group_by=task)
        fn = self.fn.options(name="data:source")
        if self.columns is not None:
            return fn.remote(*self.args, columns=self.columns)
        return fn.remote(*self.args)


def _window() -> int:
    from ray_tpu_torch.data.context import DataContext

    return max(1, DataContext.get_current().max_inflight_blocks)


# per-operator throughput counters (parity: OpRuntimeMetrics exported by the
# reference's metrics agent): block submissions/consumptions per stage ride
# the batched telemetry plane into /metrics as
# ray_tpu_torch_data_blocks_{submitted,consumed}_total{stage=...}
_op_metrics: dict = {}


def _data_metrics() -> dict:
    if not _op_metrics:
        from ray_tpu_torch.util.metrics import Counter

        _op_metrics["submitted"] = Counter(
            "ray_tpu_torch_data_blocks_submitted_total",
            "block tasks submitted per streaming-executor operator",
            tag_keys=("stage",),
        )
        _op_metrics["consumed"] = Counter(
            "ray_tpu_torch_data_blocks_consumed_total",
            "blocks consumed downstream per streaming-executor operator",
            tag_keys=("stage",),
        )
    return _op_metrics


def _windowed(submitted: Iterator, window: int, name: str = "stage",
              collector: Optional[List] = None) -> Iterator:
    """The backpressure core shared by every stage: pull (and thereby
    submit) ahead of the consumer while the POLICY CHAIN allows, release in
    FIFO order (block order is always preserved). The fixed window is one
    policy; a memory cap on ready-but-unconsumed output is another — see
    ``data/backpressure.py``. When policies block, the stage drains instead
    of submitting: the slow consumer throttles the fast producer."""
    from ray_tpu_torch.data import backpressure as bp

    stats = bp.StageStats(name)
    policies = bp.build_policies(stats, window)
    bp.track_stats(stats)
    if collector is not None:
        collector.append(stats)
    metrics = _data_metrics()
    tags = {"stage": name}
    pending = stats.pending
    exhausted = False
    while True:
        while not exhausted and all(p.can_submit(stats) for p in policies):
            try:
                ref = next(submitted)
            except StopIteration:
                exhausted = True
                break
            pending.append(ref)
            stats.submitted += 1
            metrics["submitted"].inc(tags=tags)
        if not pending:
            if exhausted:
                return
            # every policy refused with nothing in flight — yield anyway via
            # one forced submission so the pipeline cannot wedge
            try:
                ref = next(submitted)
            except StopIteration:
                return
            pending.append(ref)
            stats.submitted += 1
            metrics["submitted"].inc(tags=tags)
        ref = pending.popleft()
        stats._size_cache.pop(ref.id(), None)
        stats.consumed += 1
        stats.last_consumed_at = time.monotonic()
        metrics["consumed"].inc(tags=tags)
        yield ref


class SourceStage:
    """Yields the dataset's source refs; lazy ReadTasks are submitted with a
    bounded look-ahead window."""

    def __init__(self, items: List):
        self.items = items

    def stream(self, collector: Optional[List] = None) -> Iterator:
        return _windowed(
            (
                item.submit() if isinstance(item, ReadTask) else item
                for item in self.items
            ),
            _window(),
            name="source",
            collector=collector,
        )


class TaskMapStage:
    """A fused chain of (kind, fn_blob) ops executed as one task per block.

    Submission chains on upstream refs, so this stage's task for block k
    starts the moment the upstream result for k exists — while upstream is
    still producing block k+n.
    """

    def __init__(self, ops: List):
        self.ops = list(ops)

    def fused(self, more_ops: List) -> "TaskMapStage":
        return TaskMapStage(self.ops + list(more_ops))

    def stream(self, upstream: Iterator, collector: Optional[List] = None) -> Iterator:
        from ray_tpu_torch.data.dataset import _exec_block

        # name-tagged per stage: the link ledger attributes cross-node
        # bytes pulled by these block tasks to `data:map[...]` rows
        stage_name = f"map[{len(self.ops)} ops]"
        fn = _exec_block.options(name=f"data:{stage_name}")
        return _windowed(
            (fn.remote(ref, self.ops) for ref in upstream),
            _window(),
            name=stage_name,
            collector=collector,
        )


class ActorMapStage:
    """Runs a transform in a pool of long-lived actors (expensive setup —
    model weights etc. — amortized across blocks).

    Lazy: the pool is created when the stream is first pulled, not at plan
    time, and blocks are dispatched least-loaded with a bounded per-pool
    window. The pool AUTOSCALES under backlog (parity:
    ``execution/autoscaler/``): when every worker already has
    ``grow_threshold`` unfinished blocks and the pool is below ``max_size``,
    a worker is added before the next dispatch.
    """

    GROW_THRESHOLD = 2  # outstanding blocks per worker before growing

    def __init__(self, fn_blob: bytes, size: int, max_size: Optional[int] = None):
        self.fn_blob = fn_blob
        self.size = max(1, int(size))
        self.max_size = max(self.size, int(max_size)) if max_size else self.size
        self._workers: Optional[List] = None
        self._outstanding: List = []  # per-worker lists of pending refs

    def _pool(self) -> List:
        # one pool per stage, created on first pull and reused across
        # consumptions — re-running expensive __init__ (model weights) for
        # every count()/take()/iter pass would defeat the pool's purpose
        if self._workers is None:
            self._workers = [
                _ActorBlockWorker.remote(self.fn_blob)
                for _ in range(self.size)
            ]
            self._outstanding = [[] for _ in self._workers]
        return self._workers

    def pool_size(self) -> int:
        return len(self._workers or ())

    def _reap(self) -> None:
        import ray_tpu_torch as _rt

        for lst in self._outstanding:
            if lst:
                ready, rest = _rt.wait(lst, num_returns=len(lst), timeout=0)
                lst[:] = rest

    def stream(self, upstream: Iterator, owned_actors: List,
               collector: Optional[List] = None) -> Iterator:
        workers = self._pool()
        # pin on the executing dataset so handle-count reaping cannot kill
        # the pool before its output blocks are consumed
        for w in workers:
            if w not in owned_actors:
                owned_actors.append(w)

        def submitted():
            for ref in upstream:
                self._reap()
                loads = [len(x) for x in self._outstanding]
                i = loads.index(min(loads))
                if (
                    loads[i] >= self.GROW_THRESHOLD
                    and len(workers) < self.max_size
                ):
                    # backlog on every worker: grow the pool
                    w = _ActorBlockWorker.remote(self.fn_blob)
                    workers.append(w)
                    owned_actors.append(w)
                    self._outstanding.append([])
                    i = len(workers) - 1
                out = workers[i].apply.remote(ref)
                self._outstanding[i].append(out)
                yield out

        return _windowed(
            submitted(), _window() * self.max_size, name="actor_map",
            collector=collector,
        )


@ray_tpu_torch.remote
class _ActorBlockWorker:
    def __init__(self, blob):
        import cloudpickle as cp

        obj = cp.loads(blob)
        # callable class -> instantiate once (expensive setup amortized)
        self._fn = obj() if isinstance(obj, type) else obj

    def apply(self, block):
        return normalize_block(self._fn(block))


class RebatchStage:
    """Re-slice the block stream into fixed-row blocks.

    Driver-side by necessity (output blocks span input-block boundaries),
    but *streaming*: a prefetch window of upstream refs keeps workers busy
    while the driver fetches (zero-copy shm reads), slices and re-puts one
    output block at a time. This replaces the old synchronous
    repartition_by_rows barrier on the map_batches(batch_size=...) path.
    """

    def __init__(self, rows_per_block: int):
        self.rows_per_block = int(rows_per_block)

    def stream(self, upstream: Iterator) -> Iterator:
        from ray_tpu_torch.data.dataset import _fetch

        window = _window()
        prefetch: deque = deque()

        def fill():
            while len(prefetch) < window:
                try:
                    prefetch.append(next(upstream))
                except StopIteration:
                    return

        pieces: List[Batch] = []
        buffered = 0
        fill()
        while prefetch:
            block = _fetch(prefetch.popleft())
            fill()
            off = 0
            n = block_num_rows(block)
            while off < n:
                take = min(self.rows_per_block - buffered, n - off)
                pieces.append(slice_block(block, off, off + take))
                buffered += take
                off += take
                if buffered == self.rows_per_block:
                    yield ray_tpu_torch.put(
                        pieces[0] if len(pieces) == 1 else concat_blocks(pieces)
                    )
                    pieces, buffered = [], 0
        if buffered:
            yield ray_tpu_torch.put(concat_blocks(pieces))


def iter_stage_refs(sources: List, stages: List, owned_actors: List,
                    collector: Optional[List] = None) -> Iterator:
    """Compose the stage generators into one lazily-driven pipeline, after
    the logical optimizer has rewritten the plan (projection algebra +
    pushdown into column-pruning reads). ``collector`` (a list) receives
    each stage's StageStats so the owning Dataset can report ITS OWN
    execution metrics, not some other pipeline's."""
    from ray_tpu_torch.data.optimizer import optimize_plan

    sources, stages = optimize_plan(sources, stages)
    stream: Iterator = SourceStage(sources).stream(collector)
    for stage in stages:
        if isinstance(stage, ActorMapStage):
            stream = stage.stream(stream, owned_actors, collector)
        elif isinstance(stage, RebatchStage):
            stream = stage.stream(stream)
        else:
            stream = stage.stream(stream, collector)
    return stream
