"""Distributed datasets of the port (Ray Data equivalent; port of
``ray_tpu.data``).

Parity: ``python/ray/data``: lazy plans over object-store blocks on the
port's runtime, task-parallel execution with bounded in-flight windows,
``streaming_split`` and ``train.get_dataset_shard`` feeding trainer
workers, file datasources. The device feed is
``DataIterator.iter_torch_batches``: pinned host staging and a
``non_blocking`` copy on the iterator's own CUDA stream (``device``
defaults to ``"cuda"``). The reference's ``iter_jax_batches`` and
``iter_tf_batches`` have no counterpart here.
"""

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.context import ActorPoolStrategy, DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004
    read_binary_files,
    read_csv,
    read_json,
    read_parquet,
    read_text,
)

__all__ = [
    "Dataset",
    "DataIterator",
    "DataContext",
    "ActorPoolStrategy",
    "aggregate",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "Std",
    "range",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "read_binary_files",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_text",
]

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("data")
del _usage
