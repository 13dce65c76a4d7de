"""Utilities: weights carried over from and back to the JAX package,
logging and accounting helpers."""

from aec_tpu_torch.utils import tools, torch_compat

__all__ = ["tools", "torch_compat"]
