"""Blocks: the unit of data movement.

Parity: ``python/ray/data/block.py`` — a Dataset is a list of block refs in
the object store; blocks here are columnar dicts of numpy arrays (the arrow
table role) with zero-copy store reads feeding the pinned host-to-device
copy of ``DataIterator.iter_torch_batches``. A copy of
``ray_tpu/data/block.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Union

import numpy as np

Row = Dict[str, Any]
Batch = Dict[str, np.ndarray]


def rows_to_block(rows: List[Row]) -> Batch:
    if not rows:
        return {}
    cols: Dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r[k])
    return {k: np.asarray(v) for k, v in cols.items()}


def block_num_rows(block: Batch) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_to_rows(block: Batch) -> Iterable[Row]:
    n = block_num_rows(block)
    keys = list(block.keys())
    for i in range(n):
        yield {k: block[k][i] for k in keys}


def slice_block(block: Batch, start: int, end: int) -> Batch:
    return {k: v[start:end] for k, v in block.items()}


def concat_blocks(blocks: List[Batch]) -> Batch:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def normalize_block(data: Union[Batch, List[Row]]) -> Batch:
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    if isinstance(data, list):
        return rows_to_block(data)
    raise TypeError(f"cannot interpret {type(data)} as a block")
