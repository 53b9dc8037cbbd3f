"""Dataset: lazy, distributed, streaming-consumable data.

Parity: ``python/ray/data/dataset.py`` — lazy logical plan → execution over
framework tasks with blocks in the object store; ``map_batches``
(``dataset.py:383``), ``iter_batches`` (``:3668``), ``streaming_split``
(``:1236``). Execution is an operator pipeline driven by the streaming
executor (``ray_tpu_torch/data/streaming_executor.py``): every stage — bounded
read submission, fused task maps, actor pools, rebatching — runs
concurrently over bounded windows, so stage 2 processes block k while
stage 1 is still reading block k+n (the role of the reference's
``StreamingExecutor``, ``streaming_executor.py:48``). A copy of
``ray_tpu/data/dataset.py`` on the port's runtime; its batches reach the
card through ``iter_torch_batches`` (no ``iter_jax_batches`` or
``iter_tf_batches``).
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Batch,
    block_num_rows,
    block_to_rows,
    concat_blocks,
    normalize_block,
    rows_to_block,
    slice_block,
)

# an operator is (kind, fn) applied block-wise; fused into one task per block
_PREFETCH = 4


def _apply_ops(block: Batch, ops) -> Batch:
    import cloudpickle

    for kind, payload in ops:
        # declarative column ops carry plain data (no closure): they stay
        # inspectable for the logical optimizer (ray_tpu_torch/data/optimizer.py)
        if kind == "select":
            missing = [c for c in payload if c not in block]
            if missing:
                raise KeyError(f"select_columns: missing {missing}")
            block = {k: block[k] for k in payload}
            continue
        if kind == "drop":
            block = {k: v for k, v in block.items() if k not in payload}
            continue
        if kind == "rename":
            block = {payload.get(k, k): v for k, v in block.items()}
            continue
        fn = cloudpickle.loads(payload)
        if kind == "map_batches":
            block = normalize_block(fn(block))
        elif kind == "map":
            block = rows_to_block([fn(r) for r in block_to_rows(block)])
        elif kind == "filter":
            block = rows_to_block([r for r in block_to_rows(block) if fn(r)])
        elif kind == "flat_map":
            out = []
            for r in block_to_rows(block):
                out.extend(fn(r))
            block = rows_to_block(out)
        else:
            raise ValueError(kind)
    return block


@ray_tpu_torch.remote
def _exec_block(block_or_ref, ops):
    block = block_or_ref
    return _apply_ops(block, ops)


class Dataset:
    """A lazy plan: sources (block refs / lazy read tasks) + operator stages
    executed by the streaming executor."""

    def __init__(
        self,
        block_refs: List,
        ops: Optional[List] = None,
        owned_actors=None,
        stages: Optional[List] = None,
    ):
        from ray_tpu_torch.data.streaming_executor import TaskMapStage

        self._block_refs = list(block_refs)
        self._stages: List = list(stages or [])
        if ops:
            self._stages.append(TaskMapStage(ops))
        # actor pools whose pending tasks produce our blocks: pinned here so
        # handle-count reaping can't kill them before the blocks materialize
        self._owned_actors = list(owned_actors or [])

    @property
    def _ops(self) -> Optional[List]:
        """The fused per-block op chain, when the whole plan is one fused
        task-map over materialized refs — the fast path remote helpers
        (_write_block, _block_unique, ...) can apply in a single task.
        None when the plan has other stage kinds or lazy read sources."""
        from ray_tpu_torch.data.streaming_executor import ReadTask, TaskMapStage

        if any(isinstance(r, ReadTask) for r in self._block_refs):
            return None
        ops: List = []
        for stage in self._stages:
            if not isinstance(stage, TaskMapStage):
                return None
            ops.extend(stage.ops)
        return ops

    def _refs_and_ops(self):
        """(source refs, fused ops) — materializing first when the plan is
        not a pure fused task-map chain."""
        ops = self._ops
        if ops is None:
            return self.materialize()._block_refs, []
        return self._block_refs, ops

    # -- transformations (lazy) -------------------------------------------

    def _with_op(self, kind: str, fn: Callable) -> "Dataset":
        import cloudpickle

        return self._with_raw_op((kind, cloudpickle.dumps(fn)))

    def _with_raw_op(self, op) -> "Dataset":
        from ray_tpu_torch.data.streaming_executor import TaskMapStage

        stages = list(self._stages)
        if stages and isinstance(stages[-1], TaskMapStage):
            # fuse into the trailing task-map: the chain runs as ONE task
            # per block (the reference's operator fusion)
            stages[-1] = stages[-1].fused([op])
        else:
            stages.append(TaskMapStage([op]))
        return Dataset(
            self._block_refs, owned_actors=self._owned_actors, stages=stages
        )

    def _with_stage(self, stage) -> "Dataset":
        return Dataset(
            self._block_refs,
            owned_actors=self._owned_actors,
            stages=self._stages + [stage],
        )

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op("map", fn)

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        compute=None,
    ) -> "Dataset":
        # batch_size=None applies fn per block (the common, fastest path);
        # with batch_size the plan gains a streaming rebatch stage first
        from ray_tpu_torch.data.streaming_executor import RebatchStage

        ds = (
            self
            if batch_size is None
            else self._with_stage(RebatchStage(batch_size))
        )
        from ray_tpu_torch.data.context import ActorPoolStrategy

        if isinstance(compute, ActorPoolStrategy):
            return ds._map_batches_actor_pool(fn, compute)
        return ds._with_op("map_batches", fn)

    def _map_batches_actor_pool(self, fn: Callable, strategy) -> "Dataset":
        """Run fn in a pool of long-lived actors (parity:
        ActorPoolMapOperator): callable classes are constructed once per
        actor; plain fns just avoid re-pickling per block. Lazy: the pool
        spins up when the pipeline is consumed, and blocks stream through
        it with a bounded window — upstream stages keep producing while
        the pool works (no plan-time drain barrier)."""
        import cloudpickle

        from ray_tpu_torch.data.streaming_executor import ActorMapStage

        return self._with_stage(
            ActorMapStage(
                cloudpickle.dumps(fn),
                strategy.size,
                max_size=getattr(strategy, "max_size", None),
            )
        )

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op("filter", fn)

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op("flat_map", fn)

    def union(self, other: "Dataset") -> "Dataset":
        if self._stages or other._stages:
            return Dataset(
                self.materialize()._block_refs + other.materialize()._block_refs,
                owned_actors=self._owned_actors + other._owned_actors,
            )
        return Dataset(
            self._block_refs + other._block_refs,
            owned_actors=self._owned_actors + other._owned_actors,
        )

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned zip: right-side blocks are re-sliced to the left's
        block boundaries (streaming, one block in driver memory at a time)."""
        left = self.materialize()
        right_blocks = other._iter_exec_blocks()
        buf: List[Batch] = []
        buffered = 0
        refs = []
        total_left = 0
        for lref in left._block_refs:
            lb = _fetch(lref)
            n = block_num_rows(lb)
            total_left += n
            while buffered < n:
                try:
                    nb = next(right_blocks)
                except StopIteration:
                    raise ValueError(
                        "zip(): datasets have different row counts"
                    ) from None
                buf.append(nb)
                buffered += block_num_rows(nb)
            merged = concat_blocks(buf)
            rb = slice_block(merged, 0, n)
            buf = [slice_block(merged, n, block_num_rows(merged))]
            buffered -= n
            out = dict(lb)
            for k, v in rb.items():
                out[k if k not in out else f"{k}_1"] = v
            refs.append(ray_tpu_torch.put(out))
        for nb in right_blocks:
            buffered += block_num_rows(nb)
        if buffered:
            raise ValueError("zip(): datasets have different row counts")
        return Dataset(refs)

    # -- column ops (parity: Dataset.add_column/drop_columns/select_columns/
    # rename_columns, python/ray/data/dataset.py) -------------------------

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        """fn receives the whole batch (dict of columns) and returns the new
        column as an array (the reference's batch-wise contract)."""

        def _add(batch):
            out = dict(batch)
            out[name] = np.asarray(fn(batch))
            return out

        return self._with_op("map_batches", _add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        # declarative (no closure): the logical optimizer coalesces chains
        # of these and pushes projections into column-pruning reads
        return self._with_raw_op(("drop", list(cols)))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._with_raw_op(("select", list(cols)))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._with_raw_op(("rename", dict(mapping)))

    def unique(self, column: str) -> List:
        """Distinct values of one column: per-block remote uniques, only the
        small distinct sets travel to the driver."""
        seen: set = set()
        src_refs, ops = self._refs_and_ops()
        refs = [_block_unique.remote(ref, ops, column) for ref in src_refs]
        for vals in ray_tpu_torch.get(refs, timeout=600):
            seen.update(vals)
        return sorted(seen)

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli sample of rows (parity: ``Dataset.random_sample``).

        Seeded per (seed, block index) so a seeded sample is reproducible —
        including across task retries and lineage reconstruction — regardless
        of block content or dtype."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        base = seed if seed is not None else int.from_bytes(os.urandom(4), "little")
        mat = self.materialize()
        refs = [
            _sample_block.remote(ref, fraction, base, i)
            for i, ref in enumerate(mat._block_refs)
        ]
        return Dataset(refs, owned_actors=mat._owned_actors)

    def take_batch(self, batch_size: int = 20) -> Batch:
        """First batch_size rows as one batch dict (parity: take_batch)."""
        pieces = []
        taken = 0
        for block in self._iter_exec_blocks():
            n = block_num_rows(block)
            take = min(batch_size - taken, n)
            if take:
                pieces.append(slice_block(block, 0, take))
                taken += take
            if taken >= batch_size:
                break
        if not pieces:
            raise ValueError("dataset is empty")
        return concat_blocks(pieces)

    def limit(self, n: int) -> "Dataset":
        out_blocks = []
        taken = 0
        for block in self._iter_exec_blocks():
            rows = block_num_rows(block)
            if taken + rows > n:
                block = slice_block(block, 0, n - taken)
                rows = block_num_rows(block)
            if rows:
                out_blocks.append(ray_tpu_torch.put(block))
                taken += rows
            if taken >= n:
                break
        return Dataset(out_blocks)

    def repartition(self, num_blocks: int) -> "Dataset":
        """Streaming repartition: two passes over materialized blocks (block
        fetches are zero-copy shm maps), one block resident at a time."""
        mat = self.materialize()
        total = sum(block_num_rows(_fetch(r)) for r in mat._block_refs)
        per = max(1, (total + num_blocks - 1) // num_blocks)
        return mat.repartition_by_rows(per)

    def repartition_by_rows(self, rows_per_block: int) -> "Dataset":
        """Re-slice the block stream into fixed-size blocks. Executes the
        rebatch (streaming: prefetch window upstream, one output block
        resident in the driver at a time) so block-count metadata is
        immediately correct; map_batches(batch_size=...) uses the lazy
        RebatchStage form instead, which defers the work into the
        consumer-driven pipeline."""
        from ray_tpu_torch.data.streaming_executor import RebatchStage

        return self._with_stage(RebatchStage(rows_per_block)).materialize()

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Distributed exchange shuffle (parity: the reference's push-based
        shuffle in ``_internal/planner/exchange/``): each source block is
        split into k random slices by tasks, each output block merges one
        slice from every source and permutes — no global materialization."""
        mat = self.materialize()
        k = max(1, len(mat._block_refs))
        if seed is None:
            import os as _os

            base = int.from_bytes(_os.urandom(4), "little")  # random per call
        else:
            base = int(seed)
        split_refs = [
            _shuffle_split.options(num_returns=k).remote(ref, k, base + i)
            for i, ref in enumerate(mat._block_refs)
        ]
        if k == 1:
            split_refs = [[r] for r in split_refs]
        out = [
            _shuffle_merge.remote(base + 7919 + j, *[row[j] for row in split_refs])
            for j in range(k)
        ]
        return Dataset(out)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed range-partition sort (parity: the sort exchange,
        ``python/ray/data/_internal/planner/exchange/sort_task_spec.py:1``):
        sample boundaries -> range-partition map stage -> per-range sorted
        merge, all as tasks over blocks."""
        from ray_tpu_torch.data.aggregate import (
            _range_partition,
            _sample_keys,
            _sort_merge,
        )

        mat = self.materialize()
        if not mat._block_refs:
            return mat  # empty dataset is trivially sorted
        k = len(mat._block_refs)
        if k == 1:
            out = [_sort_merge.remote(key, descending, mat._block_refs[0])]
            return Dataset(out)
        sample_arrays = [
            np.asarray(s)
            for s in ray_tpu_torch.get(
                [_sample_keys.remote(r, key, 32) for r in mat._block_refs],
                timeout=600,
            )
            if len(s)
        ]
        if not sample_arrays:
            return mat  # all blocks empty
        samples = np.concatenate(sample_arrays)
        samples.sort()
        # k-1 boundaries at even quantiles
        bounds = [samples[int(i * len(samples) / k)] for i in range(1, k)]
        parts = [
            _range_partition.options(num_returns=k).remote(ref, key, bounds)
            for ref in mat._block_refs
        ]
        out = [
            _sort_merge.remote(key, descending, *[row[j] for row in parts])
            for j in range(k)
        ]
        if descending:
            out = out[::-1]
        return Dataset(out)

    def groupby(self, key: str):
        """Parity: ``Dataset.groupby`` -> GroupedData (hash exchange)."""
        from ray_tpu_torch.data.aggregate import GroupedData

        return GroupedData(self, key)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Global aggregation: per-block partials + driver-side merge."""
        from ray_tpu_torch.data.aggregate import _partial_agg

        import cloudpickle

        mat = self.materialize()
        blobs = [cloudpickle.dumps(a) for a in aggs]
        partials = ray_tpu_torch.get(
            [_partial_agg.remote(ref, blobs) for ref in mat._block_refs],
            timeout=600,
        )
        out = {}
        for i, a in enumerate(aggs):
            acc = a.init()
            for row in partials:
                acc = a.merge(acc, row[i])
            out[a.name] = a.finalize(acc)
        return out

    def sum(self, on: str) -> float:
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on))[f"sum({on})"]

    def min(self, on: str) -> float:
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on))[f"min({on})"]

    def max(self, on: str) -> float:
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on))[f"max({on})"]

    def mean(self, on: str) -> float:
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1) -> float:
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof))[f"std({on})"]

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        ds = self.materialize()
        if equal:
            block = concat_blocks([_fetch(r) for r in ds._block_refs])
            total = block_num_rows(block)
            per = total // n
            return [
                Dataset([ray_tpu_torch.put(slice_block(block, i * per, (i + 1) * per))])
                for i in range(n)
            ]
        shards: List[List] = [[] for _ in range(n)]
        for i, ref in enumerate(ds._block_refs):
            shards[i % n].append(ref)
        return [Dataset(refs) for refs in shards]

    def streaming_split(self, n: int, *, equal: bool = False) -> List["DataIterator"]:
        """Per-consumer iterators over disjoint shards (parity:
        ``dataset.py:1236``; feeds one trainer worker each)."""
        from ray_tpu_torch.data.iterator import DataIterator

        return [DataIterator(shard) for shard in self.split(n, equal=equal)]

    # -- execution ---------------------------------------------------------

    def _iter_exec_block_refs(self) -> Iterator:
        """Drive the streaming executor: all stages run concurrently over
        bounded windows (DataContext.max_inflight_blocks per stage), so a
        dataset arbitrarily larger than memory streams through a consumer
        while every pipeline stage stays busy."""
        from ray_tpu_torch.data.streaming_executor import ReadTask, iter_stage_refs

        if not self._stages and not any(
            isinstance(r, ReadTask) for r in self._block_refs
        ):
            yield from self._block_refs
            return
        self._exec_stats = []
        yield from iter_stage_refs(
            self._block_refs, self._stages, self._owned_actors,
            collector=self._exec_stats,
        )

    def _iter_exec_blocks(self) -> Iterator[Batch]:
        for ref in self._iter_exec_block_refs():
            yield _fetch(ref)

    def materialize(self) -> "Dataset":
        """Execute the plan; returns a Dataset of plain block refs."""
        from ray_tpu_torch.data.streaming_executor import ReadTask

        if not self._stages and not any(
            isinstance(r, ReadTask) for r in self._block_refs
        ):
            return self
        return Dataset(
            list(self._iter_exec_block_refs()), owned_actors=self._owned_actors
        )

    def to_block(self) -> Batch:
        return concat_blocks(list(self._iter_exec_blocks()))

    # -- consumption -------------------------------------------------------

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self._iter_exec_blocks())

    def take(self, n: int = 20) -> List[Dict]:
        out = []
        for block in self._iter_exec_blocks():
            for row in block_to_rows(block):
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict]:
        return [r for b in self._iter_exec_blocks() for r in block_to_rows(b)]

    def iter_rows(self) -> Iterator[Dict]:
        for block in self._iter_exec_blocks():
            yield from block_to_rows(block)

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        drop_last: bool = False,
    ) -> Iterator[Batch]:
        """Re-batch the block stream to exactly batch_size rows. Linear: each
        row is copied at most once (pieces are sliced views until concat)."""
        import collections

        blocks: collections.deque = collections.deque()  # (block, offset)
        buffered = 0
        for block in self._iter_exec_blocks():
            n = block_num_rows(block)
            if n:
                blocks.append((block, 0))
                buffered += n
            while buffered >= batch_size:
                pieces = []
                need = batch_size
                while need:
                    blk, off = blocks[0]
                    n = block_num_rows(blk) - off
                    take = min(need, n)
                    pieces.append(slice_block(blk, off, off + take))
                    need -= take
                    if take == n:
                        blocks.popleft()
                    else:
                        blocks[0] = (blk, off + take)
                buffered -= batch_size
                yield pieces[0] if len(pieces) == 1 else concat_blocks(pieces)
        if buffered and not drop_last:
            yield concat_blocks([slice_block(b, o, block_num_rows(b)) for b, o in blocks])

    def iter_torch_batches(self, **kw) -> Iterator[Dict]:
        """Parity: the framework batch iterator lives on Dataset too (the
        reference's ``Dataset.iter_torch_batches``): a DataIterator over
        this plan (its keywords: ``DataIterator.iter_torch_batches``)."""
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self).iter_torch_batches(**kw)

    def to_pandas(self):
        import pandas as pd

        block = self.to_block()
        return pd.DataFrame({k: list(v) if getattr(v, "ndim", 1) > 1 else v
                             for k, v in block.items()})

    def to_arrow(self):
        """Single pyarrow.Table of the whole dataset (parity: to_arrow_refs
        collapsed to one table — the common interop shape). Numeric numpy
        columns wrap zero-copy; object columns convert."""
        return _to_arrow_table(self.to_block())

    def to_arrow_refs(self) -> List:
        """Per-block Arrow conversion as refs (parity: to_arrow_refs)."""
        src_refs, ops = self._refs_and_ops()
        return [_block_to_arrow.remote(r, ops) for r in src_refs]

    def to_numpy_refs(self) -> List:
        return list(self._iter_exec_block_refs())

    # -- writes (parity: Dataset.write_parquet/csv/json — one file per
    # block, written by distributed tasks) --------------------------------

    def _write(self, path: str, ext: str, writer_fn) -> List[str]:
        import cloudpickle

        from ray_tpu_torch._private import external_storage as storage

        if not storage.has_scheme(path):
            os.makedirs(path, exist_ok=True)
        blob = cloudpickle.dumps(writer_fn)
        src_refs, ops = self._refs_and_ops()
        refs = [
            _write_block.remote(
                ref,
                ops,
                storage.join(path, f"part-{i:05d}{ext}")
                if storage.has_scheme(path)
                else os.path.join(path, f"part-{i:05d}{ext}"),
                blob,
            )
            for i, ref in enumerate(src_refs)
        ]
        return ray_tpu_torch.get(refs, timeout=600)

    def write_parquet(self, path: str) -> List[str]:
        def _w(block, out_path):
            import pyarrow as pa
            import pyarrow.parquet as pq

            pq.write_table(pa.table({k: list(v) for k, v in block.items()}), out_path)

        return self._write(path, ".parquet", _w)

    def write_csv(self, path: str) -> List[str]:
        def _w(block, out_path):
            import csv

            cols = list(block)
            with open(out_path, "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(cols)
                for i in builtins.range(block_num_rows(block)):
                    w.writerow([block[c][i] for c in cols])

        return self._write(path, ".csv", _w)

    def write_json(self, path: str) -> List[str]:
        def _w(block, out_path):
            import json

            with open(out_path, "w") as fh:
                for row in block_to_rows(block):
                    fh.write(json.dumps({k: v.tolist() if hasattr(v, "tolist") else v
                                         for k, v in row.items()}) + "\n")

        return self._write(path, ".json", _w)

    def schema(self) -> Dict[str, str]:
        for block in self._iter_exec_blocks():
            return {k: str(v.dtype) for k, v in block.items()}
        return {}

    def num_blocks(self) -> int:
        """Block count of the plan's OUTPUT. For lazy plans with
        count-changing stages (rebatch) this requires executing the plan —
        metadata calls on lazy pipelines are rare; prefer asking a
        materialized dataset."""
        from ray_tpu_torch.data.streaming_executor import RebatchStage

        if any(isinstance(s, RebatchStage) for s in self._stages):
            return len(self.materialize()._block_refs)
        return len(self._block_refs)

    def stats(self) -> str:
        """Plan summary + per-stage metrics of THIS dataset's most recent
        execution (parity: ``Dataset.stats()``'s per-operator breakdown —
        block counts, wall time, throughput, mean block size)."""
        lines = [
            f"Dataset(blocks={len(self._block_refs)}, "
            f"stages={len(self._stages)})"
        ]
        own = getattr(self, "_exec_stats", None)
        if own:
            lines.append("Last execution:")
            for st in own[-8:]:
                lines.append("  " + st.render())
        return "\n".join(lines)

    def __repr__(self):
        return self.stats()


@ray_tpu_torch.remote
def _sample_block(block: Batch, fraction: float, base: int, index: int) -> Batch:
    rng = np.random.default_rng([base, index])
    keep = rng.random(block_num_rows(block)) < fraction
    return {k: np.asarray(v)[keep] for k, v in block.items()}


def _to_arrow_table(block: Batch):
    """dict-of-columns block -> pyarrow.Table (zero-copy for contiguous
    numerics; object columns convert element-wise)."""
    import pyarrow as pa

    return pa.table(
        {
            k: pa.array(list(v)) if getattr(v, "dtype", None) is not None
            and v.dtype == object else pa.array(np.asarray(v))
            for k, v in block.items()
        }
    )


@ray_tpu_torch.remote
def _block_to_arrow(block, ops):
    return _to_arrow_table(_apply_ops(block, ops))


@ray_tpu_torch.remote
def _block_unique(block, ops, column: str):
    block = _apply_ops(block, ops)
    return np.unique(np.asarray(block[column])).tolist()


@ray_tpu_torch.remote
def _write_block(block, ops, out_path: str, writer_blob):
    import cloudpickle

    from ray_tpu_torch._private import external_storage as storage

    block = _apply_ops(block, ops)
    writer = cloudpickle.loads(writer_blob)
    if out_path.startswith("file://"):
        # already local: write straight to the resolved path
        local = storage.resolve(out_path)[1]
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        writer(block, local)
    elif storage.has_scheme(out_path):
        # scheme'd target: stage locally, then hand the bytes to the backend
        import tempfile

        suffix = os.path.splitext(out_path)[1]
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
            local = tmp.name
        try:
            writer(block, local)
            with open(local, "rb") as fh:
                storage.write_bytes(out_path, fh.read())
        finally:
            try:
                os.unlink(local)
            except OSError:
                pass
    else:
        writer(block, out_path)
    return out_path


@ray_tpu_torch.remote
def _shuffle_split(block: Batch, k: int, seed: int):
    """Randomly partition a block's rows into k slices."""
    n = block_num_rows(block)
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, k, n)
    out = tuple(
        {key: v[assignment == j] for key, v in block.items()} for j in range(k)
    )
    return out if k > 1 else out[0]


@ray_tpu_torch.remote
def _shuffle_merge(seed: int, *slices: Batch) -> Batch:
    merged = concat_blocks(list(slices))
    n = block_num_rows(merged)
    perm = np.random.default_rng(seed).permutation(n)
    return {k: v[perm] for k, v in merged.items()}


def _fetch(ref) -> Batch:
    if isinstance(ref, ray_tpu_torch.ObjectRef):
        return ray_tpu_torch.get(ref, timeout=120)
    return ref
