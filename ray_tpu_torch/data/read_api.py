"""Dataset constructors.

Parity: ``python/ray/data/read_api.py`` — ``range``, ``from_items``,
``from_numpy``, ``read_parquet``, ``read_csv``, ``read_json``; file reads are
distributed tasks, one per file (the reference's datasource split model).
"""

from __future__ import annotations

import builtins
import glob as globlib
import os
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import rows_to_block
from ray_tpu_torch.data.dataset import Dataset

_DEFAULT_BLOCK_ROWS = 1000


def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    num_blocks = num_blocks or max(1, min(32, n // _DEFAULT_BLOCK_ROWS or 1))
    per = max(1, (n + num_blocks - 1) // num_blocks)
    if n == 0:
        return Dataset([ray_tpu_torch.put({"id": np.arange(0)})])
    refs = []
    for start in builtins.range(0, n, per):
        end = min(start + per, n)
        refs.append(ray_tpu_torch.put({"id": np.arange(start, end)}))
    return Dataset(refs)


def from_items(items: List[Any], *, num_blocks: int = 4) -> Dataset:
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    per = max(1, (len(rows) + num_blocks - 1) // num_blocks)
    refs = []
    for i in builtins.range(0, len(rows), per):
        refs.append(ray_tpu_torch.put(rows_to_block(rows[i : i + per])))
    return Dataset(refs)


def from_numpy(arr, *, column: str = "data", num_blocks: int = 4) -> Dataset:
    """Accepts a single ndarray (named ``column``) or a dict of columns."""
    if isinstance(arr, dict):
        n = len(next(iter(arr.values())))
        per = max(1, (n + num_blocks - 1) // num_blocks)
        refs = []
        for i in builtins.range(0, n, per):
            refs.append(ray_tpu_torch.put({k: np.asarray(v)[i : i + per] for k, v in arr.items()}))
        return Dataset(refs)
    per = max(1, (len(arr) + num_blocks - 1) // num_blocks)
    refs = []
    for i in builtins.range(0, len(arr), per):
        refs.append(ray_tpu_torch.put({column: arr[i : i + per]}))
    return Dataset(refs)


def from_pandas(df) -> Dataset:
    block = {c: df[c].to_numpy() for c in df.columns}
    return Dataset([ray_tpu_torch.put(block)])


def _expand_paths(paths, suffix: str) -> List[str]:
    from ray_tpu_torch._private import external_storage as storage

    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if storage.has_scheme(p):
            # scheme'd prefix: expand through the backend's listing first
            # (directories look like existing keys on the file backend);
            # fall back to treating p as one exact key
            listed = [
                u
                for u in storage.list_uri(p.rstrip("/") + "/")
                if u.endswith(suffix)
            ]
            if listed:
                out.extend(listed)
            elif storage.exists(p):
                out.append(p)
        elif os.path.isdir(p):
            out.extend(sorted(globlib.glob(os.path.join(p, f"*{suffix}"))))
        elif "*" in p:
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


import contextlib


@contextlib.contextmanager
def _local_copy(path: str):
    """Scheme'd URIs download to a local temp file for the parser (removed
    after the read); plain paths pass through (parity: pyarrow.fs
    resolution in Data reads)."""
    from ray_tpu_torch._private import external_storage as storage

    if not storage.has_scheme(path):
        yield path
        return
    if path.startswith("file://"):
        # already local: no point copying a multi-GB file through memory
        yield storage.resolve(path)[1]
        return
    import tempfile

    data = storage.read_bytes(path)
    if data is None:
        raise FileNotFoundError(path)
    suffix = os.path.splitext(path)[1]
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
        tmp.write(data)
        local = tmp.name
    try:
        yield local
    finally:
        try:
            os.unlink(local)
        except OSError:
            pass


@ray_tpu_torch.remote
def _read_parquet_file(path: str, columns=None):
    import pyarrow.parquet as pq

    with _local_copy(path) as local:
        table = pq.read_table(local, columns=columns)
    return {c: table.column(c).to_numpy(zero_copy_only=False) for c in table.column_names}


@ray_tpu_torch.remote
def _read_csv_file(path: str):
    import csv

    with _local_copy(path) as local, open(local, newline="") as fh:
        reader = csv.DictReader(fh)
        rows = list(reader)
    block = rows_to_block(rows)
    # best-effort numeric conversion
    out = {}
    for k, v in block.items():
        try:
            out[k] = v.astype(np.int64)
        except ValueError:
            try:
                out[k] = v.astype(np.float64)
            except ValueError:
                out[k] = v
    return out


@ray_tpu_torch.remote
def _read_json_file(path: str):
    import json

    rows = []
    with _local_copy(path) as local, open(local) as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == "[":
            rows = json.load(fh)
        else:  # jsonl
            rows = [json.loads(line) for line in fh if line.strip()]
    return rows_to_block(rows)


@ray_tpu_torch.remote
def _read_text_file(path: str):
    with _local_copy(path) as local, open(local) as fh:
        lines = [ln.rstrip("\r\n") for ln in fh]
    return {"text": np.array(lines, dtype=object)}


@ray_tpu_torch.remote
def _read_binary_file(path: str):
    with _local_copy(path) as local, open(local, "rb") as fh:
        data = fh.read()
    return {"bytes": np.array([data], dtype=object),
            "path": np.array([path], dtype=object)}


def read_text(paths) -> Dataset:
    """One block per file of ``{"text": line}`` rows (parity: read_text)."""
    return _lazy_read(_read_text_file, _expand_paths(paths, ".txt"))


def read_binary_files(paths) -> Dataset:
    """One row per file: ``{"bytes": ..., "path": ...}``."""
    return _lazy_read(_read_binary_file, _expand_paths(paths, ""))


def from_arrow(table, *, num_blocks: int = 1) -> Dataset:
    """Arrow table(s) → Dataset. Slicing is zero-copy on the Arrow side;
    numeric columns convert to numpy without a copy where the layout
    allows (parity: ``from_arrow``/ArrowBlockAccessor)."""
    tables = table if isinstance(table, (list, tuple)) else [table]
    refs = []
    for t in tables:
        n = t.num_rows
        per = max(1, (n + num_blocks - 1) // num_blocks)
        for start in builtins.range(0, max(n, 1), per):
            sl = t.slice(start, min(per, n - start))
            refs.append(
                ray_tpu_torch.put(
                    {
                        c: sl.column(c).to_numpy(zero_copy_only=False)
                        for c in sl.column_names
                    }
                )
            )
    return Dataset(refs)


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    """Parquet read with column pruning: ``columns`` (or a subsequent
    ``select_columns``, via the logical optimizer's projection pushdown)
    restricts what is decoded from the files."""
    return _lazy_read(
        _read_parquet_file,
        _expand_paths(paths, ".parquet"),
        columns=list(columns) if columns else None,
        supports_columns=True,
    )


def read_csv(paths) -> Dataset:
    return _lazy_read(_read_csv_file, _expand_paths(paths, ".csv"))


def read_json(paths) -> Dataset:
    return _lazy_read(_read_json_file, _expand_paths(paths, ".json"))


def _lazy_read(
    remote_fn,
    paths: List[str],
    columns: Optional[List[str]] = None,
    supports_columns: bool = False,
) -> Dataset:
    """Source blocks as lazy ReadTasks: the streaming executor submits them
    with a bounded window instead of flooding the cluster with one task per
    file up front (parity: the reference's read-op backpressure)."""
    from ray_tpu_torch.data.streaming_executor import ReadTask

    return Dataset(
        [
            ReadTask(
                remote_fn, (p,), columns=columns, supports_columns=supports_columns
            )
            for p in paths
        ]
    )
