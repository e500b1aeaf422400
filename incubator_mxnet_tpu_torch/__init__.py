"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of the JAX package.

The JAX package beside it stays the reference; this package is its port
to PyTorch on an NVIDIA H100, built slice by slice. It imports ``torch``
and never ``jax`` or any module of the JAX package.

Slice 1 is greedy KV-cache decode serving for the GPT decoder
(``serving.DecodeSession`` over ``gluon.model_zoo.get_gpt``); its one TPU
kernel, the flash-attention forward, is a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, wrapped by ``ops.flash_attention``).

Devices are explicit: every entry point takes a ``ctx``; the default is
``gpu(0)`` (``cuda:0``) and raises when there is no card. The CPU runs only
when the caller passes ``cpu()``.
"""

import torch

# Mirror the reference's jax_default_matmul_precision="highest" pin: fp32
# matrix products and convolutions run in full fp32, never TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import base, config, device, initializer, random  # noqa: E402
from . import ops, gluon, serving  # noqa: E402
from .base import MXTPUError  # noqa: E402
from .device import Context, cpu, current_context, gpu  # noqa: E402

__all__ = ["Context", "MXTPUError", "base", "config", "cpu",
           "current_context", "device", "gluon", "gpu", "initializer", "ops",
           "random", "serving"]
