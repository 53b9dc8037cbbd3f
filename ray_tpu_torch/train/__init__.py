"""Distributed training library of the port (Ray Train equivalent; port of
``ray_tpu.train``).

Parity: ``python/ray/train`` — ``BaseTrainer.fit`` (``base_trainer.py:567``),
``DataParallelTrainer`` (``data_parallel_trainer.py:25``), ``BackendExecutor``
(``_internal/backend_executor.py:67``), in-worker session with
``train.report`` (``_internal/session.py:667``). The worker group is one
actor per rank on the port's runtime (``ScalingConfig(use_gpu=True)``: one
GPU each); with ``use_torch_distributed`` the ranks join one
``torch.distributed`` process group (NCCL on GPUs, gloo on the CPU) through
the runtime's KV before the loop runs. Pytree checkpoints of a train state
are ``save_pytree`` / ``load_pytree``. ``datasets=`` attaches
``ray_tpu_torch.data`` datasets, which the loop reads through
``train.get_dataset_shard`` (each rank a disjoint lazy shard; batches
reach the card through ``iter_torch_batches``). Not in the port: the
TensorFlow trainer.
"""

from ray_tpu_torch.train import checkpointing, elastic
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._result import Result
from ray_tpu_torch.train._session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    load_elastic,
    report,
    report_elastic,
)
from ray_tpu_torch.train.checkpointing import CheckpointManager, register_preemption_hook
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_trainer import TorchTrainer, prepare_data_loader, prepare_model
from ray_tpu_torch.train.torch_utils import load_pytree, save_pytree

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "checkpointing",
    "register_preemption_hook",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "Result",
    "DataParallelTrainer",
    "TorchTrainer",
    "prepare_model",
    "prepare_data_loader",
    "report",
    "report_elastic",
    "load_elastic",
    "elastic",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
    "load_pytree",
    "save_pytree",
]

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("train")
del _usage
