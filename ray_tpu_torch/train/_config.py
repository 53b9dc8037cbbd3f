"""Train/Tune shared configs (port of ``ray_tpu/train/_config.py``).

Parity: ``python/ray/air/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``, ``CheckpointConfig``). ``ScalingConfig.use_gpu`` asks for
one ``GPU`` per worker (the port's runtime hands each such worker its own
``CUDA_VISIBLE_DEVICES``), and ``use_torch_distributed`` makes the workers
join one ``torch.distributed`` process group before the loop runs. The
reference's slice ``topology`` is TPU-only: GPU nodes carry no slice-head
resource, so naming one raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    # one GPU per worker: the worker's process sees only its card
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # TPU slice topology in the reference; no GPU counterpart
    topology: Optional[str] = None
    # Multi-process SPMD: each worker joins one torch.distributed process
    # group (the address agreed through the cluster KV) before the loop
    # runs: NCCL for GPU workers, gloo for CPU workers. Parity:
    # _setup_torch_process_group (python/ray/train/torch/config.py:65).
    use_torch_distributed: bool = False
    # runtime_env applied to each train worker actor (env_vars etc.)
    worker_runtime_env: Optional[Dict] = None

    def __post_init__(self):
        if self.topology is not None:
            raise ValueError(
                f"ScalingConfig(topology={self.topology!r}): a slice topology names TPU "
                "hosts and is TPU-only; GPU nodes carry no slice-head resource. Use "
                "num_workers (and use_gpu=True) instead"
            )
        if self.use_gpu:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ScalingConfig(use_gpu=True) needs a CUDA device, and none is "
                    "available; use use_gpu=False to train on CPU workers"
                )

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1.0}
        if self.use_gpu:
            res["GPU"] = 1.0
        return res

    @property
    def total_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, v in self.worker_resources().items():
            out[k] = v * self.num_workers
        return out


@dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = infinite
    # Backoff between whole-gang restart attempts: exponential from
    # retry_backoff_s (doubling per consecutive failure) capped at
    # retry_backoff_max_s, with +/- retry_backoff_jitter fraction of
    # randomization so a crash-looping gang doesn't hammer the scheduler
    # in lockstep. jitter=0 makes the schedule deterministic.
    retry_backoff_s: float = 1.0
    retry_backoff_max_s: float = 30.0
    retry_backoff_jitter: float = 0.5


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    # fit() drains in-flight checkpoint commits for at most this long
    # before returning; a drain timeout surfaces as a CHECKPOINT_FAILED
    # cluster event plus CheckpointDrainError context on Result.error
    # (never a silent return that looks fully committed)
    drain_timeout_s: float = 120.0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser("~/ray_tpu_torch_results")
