"""Neural-network ops of the ported path.

Counterparts of the ops of the JAX package's ``ops/nn.py`` that the GPT
decoder and the fused ResNet run, and the registered ops of ``mx.nd``
(``FullyConnected``, ``relu``, ``sigmoid``, ``softmax``, ``log_softmax``).
None of them is a TPU kernel there (XLA compiles them), so here they are
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["activation", "dropout", "embedding", "fully_connected",
           "layer_norm", "log_softmax", "pooling", "relu", "sigmoid",
           "softmax"]


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x·Wᵀ + b with weight (units, in_units), as the reference's
    FullyConnected; ``flatten`` folds every axis after the first into
    the input features. ``num_hidden`` is the reference's attribute (the
    weight gives the width); ``no_bias`` drops ``bias``."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("softmax")
def softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


def layer_norm(x, gamma, beta, eps=1e-5):
    """Layer norm over the last axis, population variance."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def embedding(indices, weight):
    """Rows of ``weight`` at integer ``indices``."""
    return F.embedding(indices.long(), weight)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation, and the reference's
    # Activation("gelu") takes that default
    return F.gelu(x, approximate="tanh")


_ACTS = {"gelu": _gelu}


def activation(x, act_type):
    """Reference ``Activation(act_type=...)``."""
    if act_type not in _ACTS:
        raise ValueError(f"unknown act_type {act_type!r}; known "
                         f"{sorted(_ACTS)}")
    return _ACTS[act_type](x)


def dropout(x, p=0.5, training=False,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout; the identity unless ``training``. The mask is drawn
    from ``generator`` (the device's ``random.generator`` by default)."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        from .. import random as _random
        from ..device import Context

        ctx = Context("cpu") if x.device.type == "cpu" else \
            Context("gpu", x.device.index or 0)
        generator = _random.generator(ctx)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


def pooling(x, kernel=(2, 2), pool_type="max", stride=None, pad=(0, 0),
            layout="NCHW"):
    """2-D max pooling (reference ``Pooling``), padded with -inf as the JAX
    package's ``lax.reduce_window``; ``stride`` defaults to ``kernel``.
    ``layout="NHWC"`` takes and returns channels-last tensors without a
    copy. Only ``pool_type="max"`` is ported."""
    if pool_type != "max":
        raise NotImplementedError(f"pool_type {pool_type!r}: the port has "
                                  "max pooling only")
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout {layout!r}: NCHW or NHWC")
    stride = kernel if stride is None else stride
    if layout == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = F.max_pool2d(x, kernel, stride, pad)
    return out.permute(0, 2, 3, 1) if layout == "NHWC" else out
