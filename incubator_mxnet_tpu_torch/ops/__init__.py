"""Ops of the port: plain PyTorch (``tensor``, ``nn``, ``misc``), and the
hand-written CUDA kernels with their plain versions (``flash_attention``,
``fused_conv``)."""

from . import flash_attention, fused_conv, misc, nn, tensor

__all__ = ["flash_attention", "fused_conv", "misc", "nn", "tensor"]
