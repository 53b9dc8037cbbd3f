"""Entry point of the port: the counterpart of ``__graft_entry__.entry``.

``entry()`` returns ``(fn, example_args)``: a forward step on the flagship
model, a GPT-J-architecture decoder (parallel attention + MLP block, gelu
MLP) with the reference's flagship configuration, its parameters and
example tokens on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, forward, init_params


def flagship_config() -> TransformerConfig:
    """The reference's flagship configuration (``__graft_entry__``)."""
    return TransformerConfig(
        vocab_size=50432,
        d_model=1024,
        n_layers=8,
        n_heads=16,
        d_ff=4096,
        max_seq_len=1024,
        parallel_block=True,
        use_swiglu=False,
    )


def entry(device: DeviceLike = "cuda"):
    """Returns (fn, (params, tokens)): ``fn(params, tokens)`` is the
    flagship forward, tokens (2, 256) -> logits (2, 256, vocab)."""
    dev = resolve_device(device)
    cfg = flagship_config()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
