"""MNIST-scale models (MLP and a small CNN) (plain torch).

Port of ``ray_tpu/models/mnist.py``: the same nested parameter pytrees
(``{"layers": [{"w", "b"}, ...]}``; the CNN's ``conv1``/``conv2`` in HWIO
and ``fc1``/``fc2``), fp32, images in NHWC. The convolutions and pooling,
``lax.conv_general_dilated`` and ``reduce_window`` in the reference (no
Pallas kernel), are ``F.conv2d`` and ``F.max_pool2d`` here, with the layout
permuted at their edges only.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


def _normal(gen, shape, scale, dev):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(scale)


def init_mlp(generator: torch.Generator, hidden: Tuple[int, ...] = (128, 128),
             num_classes: int = 10, input_dim: int = 784, *, device="cuda") -> Dict:
    """He-initialised MLP (the reference's scales) from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)
    sizes = (input_dim,) + tuple(hidden) + (num_classes,)
    return {
        "layers": [
            {
                "w": _normal(generator, (sizes[i], sizes[i + 1]), math.sqrt(2.0 / sizes[i]), dev),
                "b": torch.zeros(sizes[i + 1], device=dev),
            }
            for i in range(len(sizes) - 1)
        ]
    }


def apply_mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(params["layers"]) - 1:
            h = torch.relu(h)
    return h


def init_cnn(generator: torch.Generator, num_classes: int = 10, *, device="cuda") -> Dict:
    dev = resolve_device(device)
    g = generator
    return {
        "conv1": _normal(g, (3, 3, 1, 16), 0.1, dev),
        "conv2": _normal(g, (3, 3, 16, 32), 0.1, dev),
        "fc1": {"w": _normal(g, (7 * 7 * 32, 128), 0.02, dev), "b": torch.zeros(128, device=dev)},
        "fc2": {
            "w": _normal(g, (128, num_classes), 0.02, dev),
            "b": torch.zeros(num_classes, device=dev),
        },
    }


def _conv_relu_pool(h: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """NCHW activations: 'SAME' stride-1 convolution with an HWIO kernel,
    relu, 2x2 max pool ('VALID')."""
    h = F.conv2d(h, w_hwio.permute(3, 2, 0, 1), padding="same")
    return F.max_pool2d(torch.relu(h), kernel_size=2, stride=2)


def apply_cnn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> logits (B, 10)."""
    h = x.permute(0, 3, 1, 2)
    h = _conv_relu_pool(h, params["conv1"])
    h = _conv_relu_pool(h, params["conv2"])
    # flatten in NHWC order, as the reference does
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return (logz - gold).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=logits.device).long()
    return (logits.argmax(-1) == labels).float().mean()
