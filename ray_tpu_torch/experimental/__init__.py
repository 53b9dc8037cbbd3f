"""Experimental subsystems (parity: ``python/ray/experimental``)."""

from ray_tpu_torch.experimental.channel import Channel, ChannelClosedError

__all__ = ["Channel", "ChannelClosedError"]
