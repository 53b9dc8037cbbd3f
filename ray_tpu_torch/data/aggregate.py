"""Aggregations + grouped data over the exchange shuffle.

Parity: ``python/ray/data/aggregate.py`` (AggregateFn, Count/Sum/Min/Max/
Mean/Std) and the hash/range exchange operators in
``python/ray/data/_internal/planner/exchange/`` (``sort_task_spec.py:1``):
a map stage partitions every block into k slices (hash of the group key, or
range via sampled boundaries for sort), and reduce task j combines slice j
of every block. All stages are framework tasks over blocks in the object
store — the driver never materializes the dataset.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Batch, block_num_rows, concat_blocks


class AggregateFn:
    """A named aggregation: init/accumulate-block/merge/finalize."""

    def __init__(self, name: str, init, accumulate_block, merge, finalize=None):
        self.name = name
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize or (lambda a: a)


def Count():
    return AggregateFn(
        "count",
        init=lambda: 0,
        accumulate_block=lambda a, block: a + block_num_rows(block),
        merge=lambda a, b: a + b,
    )


def Sum(on: str):
    return AggregateFn(
        f"sum({on})",
        init=lambda: 0.0,
        accumulate_block=lambda a, block: a + float(np.sum(block[on])) if block_num_rows(block) else a,
        merge=lambda a, b: a + b,
    )


def Min(on: str):
    return AggregateFn(
        f"min({on})",
        init=lambda: float("inf"),
        accumulate_block=lambda a, block: min(a, float(np.min(block[on]))) if block_num_rows(block) else a,
        merge=min,
    )


def Max(on: str):
    return AggregateFn(
        f"max({on})",
        init=lambda: float("-inf"),
        accumulate_block=lambda a, block: max(a, float(np.max(block[on]))) if block_num_rows(block) else a,
        merge=max,
    )


def Mean(on: str):
    return AggregateFn(
        f"mean({on})",
        init=lambda: (0.0, 0),
        accumulate_block=lambda a, block: (
            a[0] + float(np.sum(block[on])),
            a[1] + block_num_rows(block),
        )
        if block_num_rows(block)
        else a,
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda a: a[0] / a[1] if a[1] else float("nan"),
    )


def Std(on: str, ddof: int = 1):
    # Welford-style mergeable (count, mean, M2)
    def acc(a, block):
        n = block_num_rows(block)
        if not n:
            return a
        col = np.asarray(block[on], dtype=np.float64)
        bn, bmean, bm2 = n, float(col.mean()), float(((col - col.mean()) ** 2).sum())
        return _merge_moments(a, (bn, bmean, bm2))

    def _merge_moments(a, b):
        (na, ma, m2a), (nb, mb, m2b) = a, b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        delta = mb - ma
        return (n, ma + delta * nb / n, m2a + m2b + delta * delta * na * nb / n)

    return AggregateFn(
        f"std({on})",
        init=lambda: (0, 0.0, 0.0),
        accumulate_block=acc,
        merge=_merge_moments,
        finalize=lambda a: (a[2] / (a[0] - ddof)) ** 0.5 if a[0] > ddof else float("nan"),
    )


# ---------------------------------------------------------------------------
# exchange tasks
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
def _hash_partition(block: Batch, key: str, k: int):
    """Map stage of the hash exchange: k slices keyed by hash(key) % k."""
    n = block_num_rows(block)
    if n == 0:
        return [dict() for _ in range(k)] if k > 1 else {}
    col = block[key]
    if col.dtype.kind in "SUO":
        # deterministic across processes (Python's str hash is salted per
        # process, which would scatter equal keys to different partitions)
        import zlib

        idx = np.array([zlib.crc32(str(v).encode()) % k for v in col])
    else:
        idx = np.abs(col.astype(np.int64, copy=False)) % k
    out = []
    for j in range(k):
        mask = idx == j
        out.append({c: v[mask] for c, v in block.items()})
    return out if k > 1 else out[0]


@ray_tpu_torch.remote
def _range_partition(block: Batch, key: str, boundaries):
    """Map stage of the range exchange (sort): len(boundaries)+1 slices."""
    k = len(boundaries) + 1
    if block_num_rows(block) == 0:
        return [dict() for _ in range(k)] if k > 1 else {}
    col = block[key]
    idx = np.searchsorted(np.asarray(boundaries), col, side="right")
    out = []
    for j in range(k):
        mask = idx == j
        out.append({c: v[mask] for c, v in block.items()})
    return out if k > 1 else out[0]


@ray_tpu_torch.remote
def _sort_merge(key: str, descending: bool, *slices: Batch) -> Batch:
    merged = concat_blocks(list(slices))
    if not merged:
        return {}
    order = np.argsort(merged[key], kind="stable")
    if descending:
        order = order[::-1]
    return {c: v[order] for c, v in merged.items()}


@ray_tpu_torch.remote
def _sample_keys(block: Batch, key: str, m: int):
    n = block_num_rows(block)
    if n == 0:
        return np.array([])
    step = max(1, n // m)
    return np.sort(np.asarray(block[key]))[::step][:m]


def _iter_groups(merged: Batch, key: str):
    """Yield (key_value, group_block) over a merged partition, grouped by
    a stable sort on the key column."""
    col = merged[key]
    order = np.argsort(col, kind="stable")
    sorted_block = {c: v[order] for c, v in merged.items()}
    keys_sorted = sorted_block[key]
    uniq, starts = np.unique(keys_sorted, return_index=True)
    bounds = list(starts) + [len(keys_sorted)]
    for gi in range(len(uniq)):
        s, e = bounds[gi], bounds[gi + 1]
        yield uniq[gi], {c: v[s:e] for c, v in sorted_block.items()}


@ray_tpu_torch.remote
def _group_reduce(key: str, agg_blobs, *slices: Batch):
    """Reduce stage of the hash exchange: group rows, apply aggregations."""
    import cloudpickle

    aggs: List[AggregateFn] = [cloudpickle.loads(b) for b in agg_blobs]
    merged = concat_blocks(list(slices))
    if not merged:
        return {}
    out: Dict[str, list] = {key: []}
    for a in aggs:
        out[a.name] = []
    for key_value, group in _iter_groups(merged, key):
        out[key].append(key_value)
        for a in aggs:
            acc = a.accumulate_block(a.init(), group)
            out[a.name].append(a.finalize(acc))
    return {c: np.asarray(v) for c, v in out.items()}


@ray_tpu_torch.remote
def _map_groups_reduce(key: str, fn_blob, *slices: Batch):
    import cloudpickle

    from ray_tpu_torch.data.block import normalize_block

    fn = cloudpickle.loads(fn_blob)
    merged = concat_blocks(list(slices))
    if not merged:
        return {}
    outs = []
    for _, group in _iter_groups(merged, key):
        outs.append(normalize_block(fn(group)))
    return concat_blocks(outs)


@ray_tpu_torch.remote
def _partial_agg(block: Batch, agg_blobs):
    import cloudpickle

    aggs = [cloudpickle.loads(b) for b in agg_blobs]
    return [a.accumulate_block(a.init(), block) for a in aggs]


class GroupedData:
    """Parity: ``ray.data.grouped_data.GroupedData``."""

    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _exchange(self, reduce_task, payload):
        """Hash exchange: partition every block by key, then reduce each
        partition with ``reduce_task(key, payload, *slices)``."""
        from ray_tpu_torch.data.dataset import Dataset

        mat = self._ds.materialize()
        k = max(1, len(mat._block_refs))
        parts = [
            _hash_partition.options(num_returns=k).remote(ref, self._key, k)
            for ref in mat._block_refs
        ]
        if k == 1:
            parts = [[p] for p in parts]
        out = [
            reduce_task.remote(self._key, payload, *[row[j] for row in parts])
            for j in range(k)
        ]
        return Dataset(out)

    def aggregate(self, *aggs: AggregateFn):
        import cloudpickle

        return self._exchange(_group_reduce, [cloudpickle.dumps(a) for a in aggs])

    def map_groups(self, fn: Callable):
        import cloudpickle

        return self._exchange(_map_groups_reduce, cloudpickle.dumps(fn))

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof))
