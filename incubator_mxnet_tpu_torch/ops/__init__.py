"""Ops of the port: plain PyTorch (``nn``), and the hand-written CUDA
kernels with their plain versions (``flash_attention``, ``fused_conv``)."""

from . import flash_attention, fused_conv, nn

__all__ = ["flash_attention", "fused_conv", "nn"]
