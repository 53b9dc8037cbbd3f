"""Training utilities of the port: pytree checkpoints."""

from ray_tpu_torch.train.torch_utils import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
