"""Device resolution for the port's entry points.

Every public function or constructor that allocates takes an explicit
``device`` whose default is ``"cuda"``. Asking for CUDA on a machine
without a usable GPU is an error: the port never carries on quietly on
the CPU. Callers that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
