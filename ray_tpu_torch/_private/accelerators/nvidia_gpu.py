"""NVIDIA GPU accelerator manager: device detection and visibility.

The port's counterpart of ``ray_tpu/_private/accelerators/tpu.py`` (design
parity: ``NvidiaGPUAcceleratorManager``, ``python/ray/_private/
accelerators/nvidia_gpu.py``). The count comes from ``CUDA_VISIBLE_DEVICES``
when it is set, else from NVML (the cards this process may use), else from
the ``/dev/nvidia<N>`` device nodes. None of these initialise CUDA: the
driver process may not have touched the card yet, and the worker processes
forked later must find it untouched. ``RAY_TPU_TORCH_FAKE_GPUS`` gives a count on a host with no card
(the CPU tests), as ``RAY_TPU_FAKE_CHIPS`` does for the reference's chips.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
from typing import List, Optional

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
FAKE_GPUS_ENV = "RAY_TPU_TORCH_FAKE_GPUS"


def _visible_devices() -> Optional[List[str]]:
    raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if raw is None or raw == "":
        return None
    return [d for d in raw.split(",") if d != ""]


def _nvml_count() -> int:
    """Device count from NVML (no CUDA context); 0 without the library."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        count = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
        return int(count.value)
    finally:
        nvml.nvmlShutdown()


def detect_gpu_count() -> int:
    """Number of NVIDIA GPUs this host gives the runtime (0 if none)."""
    vis = _visible_devices()
    if vis is not None:
        return len(vis)
    # NVML first: a container may hold device nodes of cards it cannot use
    count = _nvml_count()
    if count:
        return count
    nodes = [p for p in glob.glob("/dev/nvidia*") if re.fullmatch(r"/dev/nvidia\d+", p)]
    if nodes:
        return len(nodes)
    if os.environ.get(FAKE_GPUS_ENV):
        return int(os.environ[FAKE_GPUS_ENV])
    return 0


# this process's own view, before a task's assignment narrows it: the
# runtime numbers the devices it detected 0..n-1, and a task's device i is
# the i-th of these (or CUDA ordinal i when the variable was unset)
_BASE_VISIBLE = _visible_devices()


def device_ids(indices: List[int]) -> str:
    """``CUDA_VISIBLE_DEVICES`` for the runtime's device indices."""
    return ",".join(_BASE_VISIBLE[i] if _BASE_VISIBLE else str(i) for i in indices)
