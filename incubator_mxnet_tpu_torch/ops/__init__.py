"""Ops of the port: plain PyTorch (``tensor``, ``nn``, ``misc``,
``random_ops``, ``more``, ``optimizer_ops``; ``numpy_ops``, ``fft_ops`` and
``linalg``, which also call ``torch.fft`` and ``torch.linalg``;
``detection``), and the hand-written CUDA
kernels with their plain versions (``flash_attention``, ``fused_conv``).
``random_ops`` registers before ``more``, whose per-parameter samplers
take the names ``sample_uniform``/``sample_normal`` from it, as in the
reference."""

from . import flash_attention, fused_conv, misc, nn, tensor
from . import random_ops, more, optimizer_ops  # noqa: I001  (order matters)
from . import detection, fft_ops, linalg, numpy_ops

__all__ = ["detection", "fft_ops", "flash_attention", "fused_conv", "linalg", "misc",
           "more", "nn", "numpy_ops", "optimizer_ops", "random_ops",
           "tensor"]
