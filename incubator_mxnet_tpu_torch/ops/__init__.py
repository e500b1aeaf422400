"""Ops of the port: plain PyTorch (``nn``), and the hand-written CUDA
kernels with their plain versions (``flash_attention``)."""

from . import flash_attention, nn

__all__ = ["flash_attention", "nn"]
