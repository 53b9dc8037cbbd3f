"""TorchTrainer: data-parallel PyTorch training on the worker group (port of
``ray_tpu/train/torch_trainer.py``).

Parity: ``TorchTrainer`` (``python/ray/train/torch/torch_trainer.py``) and
its backend (``python/ray/train/torch/config.py:65``,
``_setup_torch_process_group``). The reference opens a second, socket-based
gloo rendezvous of its own; here the process group is the one
``DataParallelTrainer`` joins with ``use_torch_distributed``: NCCL for GPU
workers, gloo for CPU workers, the address agreed through the runtime's KV.

``prepare_model`` / ``prepare_data_loader`` mirror
``python/ray/train/torch/train_loop_utils.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer


def prepare_model(model):
    """Move the model to this rank's device and wrap it in DDP when the
    group has more than one rank (parity: ``train.torch.prepare_model``,
    ``train_loop_utils.py``)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from ray_tpu_torch.parallel import distributed

    if not (dist.is_available() and dist.is_initialized()):
        return model
    dev = distributed.device()
    model = model.to(dev)
    if dist.get_world_size() > 1:
        return DistributedDataParallel(model, device_ids=[dev.index] if dev.type == "cuda" else None)
    return model


def prepare_data_loader(data_loader):
    """Shard a DataLoader across the group with a DistributedSampler,
    preserving the source loader's ordering and settings."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return data_loader
    shuffle = isinstance(getattr(data_loader, "sampler", None), RandomSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=shuffle)
    loader = DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        pin_memory=data_loader.pin_memory,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
    )
    return _EpochAdvancingLoader(loader, sampler)


class _EpochAdvancingLoader:
    """Advances the DistributedSampler epoch per iteration so shuffled
    loaders reshuffle each epoch (the reference's prepare_data_loader does
    this inside its iterator wrapper)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0

    def __iter__(self):
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


class TorchTrainer(DataParallelTrainer):
    """``DataParallelTrainer`` whose workers always join the process group."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        scaling = dataclasses.replace(scaling_config or ScalingConfig(), use_torch_distributed=True)
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            scaling_config=scaling,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
