"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of the JAX package.

The JAX package beside it stays the reference; this package is its port
to PyTorch on an NVIDIA H100, built slice by slice. It imports ``torch``
and never ``jax`` or any module of the JAX package.

Slice 1 is greedy KV-cache decode serving for the GPT decoder
(``serving.DecodeSession`` over ``gluon.model_zoo.get_gpt``); slice 2 is
its training, through ``autograd.record`` + ``gluon.Trainer`` and through
``parallel.SPMDTrainer``. Their TPU kernels, the flash-attention forward
and its two backward kernels, are hand-written CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, wrapped by
``ops.flash_attention``). Slice 3 trains the fused ResNet-50 with the
conv + BatchNorm kernels (``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``).
Slice 4 is MXNet's imperative front door: ``mx.nd`` (NDArrays over torch
tensors, the op registry, ``mx.nd.Custom``), ``autograd.Function`` and
``mark_variables``, ``mx.operator`` custom ops, and ``mx.rtc.CudaModule``,
which compiles CUDA source at run time with NVRTC and launches it on
NDArrays. Slice 15 trains BERT (``models.get_bert``) through the same
flash kernels, with per-sample key lengths and no causal mask. Slice 20
is the numpy front door: ``mx.np`` (with ``linalg``, ``fft`` and
``random``) and ``mx.npx``, loaded on first use. Slice 23 is hybridize and
export: ``gluon.Parameter``/``ParameterDict``, ``HybridBlock`` with its
``CachedOp`` on CUDA graphs, ``export``/``SymbolBlock`` over ``mx.sym``,
and ``mx.contrib``'s control flow. Slice 24 is mixed precision and
detection: ``amp`` (the reference's cast policy and loss scaling), every
optimizer of the JAX package with ``multi_precision`` master weights,
``ops.detection`` and SSD-300 (``models.get_ssd``).

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
from . import autograd, lr_scheduler, optimizer  # noqa: E402
from . import ops, ndarray, operator, rtc  # noqa: E402
from . import gluon, models, parallel, serving  # noqa: E402
from . import contrib, executor, symbol  # noqa: E402
from . import amp  # noqa: E402
from .base import MXTPUError  # noqa: E402
from .device import Context, cpu, current_context, gpu  # noqa: E402
from .ops import rtc_kernels  # noqa: E402,F401  (registers softmax_ce_rtc)

nd = ndarray
sym = symbol


def __getattr__(name):
    # mx.np and mx.npx load on first use, as in the JAX package
    if name in ("np", "npx"):
        import importlib
        import sys

        mod = importlib.import_module(
            {"np": ".numpy", "npx": ".numpy_extension"}[name], __name__)
        setattr(sys.modules[__name__], name, mod)
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Context", "MXTPUError", "amp", "autograd", "base", "config", "contrib",
           "cpu", "current_context", "device", "executor", "gluon", "gpu",
           "initializer", "lr_scheduler", "models", "nd", "ndarray",
           "operator", "ops", "optimizer", "parallel", "random", "rtc",
           "serving", "sym", "symbol"]
