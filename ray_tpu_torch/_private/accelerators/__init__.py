"""Accelerator managers. Parity: ``python/ray/_private/accelerators/``."""

from ray_tpu_torch._private.accelerators import nvidia_gpu

__all__ = ["nvidia_gpu"]
