"""Ops of the port: plain PyTorch (``tensor``, ``nn``, ``misc``,
``random_ops``, ``more``, ``optimizer_ops``), and the hand-written CUDA
kernels with their plain versions (``flash_attention``, ``fused_conv``).
``random_ops`` registers before ``more``, whose per-parameter samplers
take the names ``sample_uniform``/``sample_normal`` from it, as in the
reference."""

from . import flash_attention, fused_conv, misc, nn, tensor
from . import random_ops, more, optimizer_ops  # noqa: I001  (order matters)

__all__ = ["flash_attention", "fused_conv", "misc", "more", "nn",
           "optimizer_ops", "random_ops", "tensor"]
