"""``mx.nd``: the imperative NDArray op namespace.

Counterpart of the JAX package's ``ndarray/__init__.py`` for the ops the
port has: wrappers generated from the op registry (``ops/tensor.py``,
``ops/nn.py``, with ``Convolution``, ``Pooling``, ``BatchNorm`` and
``Activation``, ``scaled_dot_product_attention``, and the kernel ops
``flash_attention``/``fused_conv_bn``),
every call through :func:`invoke`, so autograd recording and the naive
engine's sync apply alike. ``mx.nd.flash_attention`` launches the flash
kernels on a CUDA array; ``invoke_op("fused_conv_bn", ...)`` the conv
kernels; ``mx.nd.Custom`` runs a registered ``mx.operator`` op.
"""

from __future__ import annotations

import sys as _sys

from ..ops import flash_attention as _flash  # noqa: F401  (registers ops)
from ..ops import fused_conv as _fused_conv  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _tensor  # noqa: F401
from .ndarray import (NDArray, arange, array, as_nd, empty, eye, full,
                      invoke, invoke_op, load, ones, ones_like, save,
                      waitall, zeros, zeros_like)

_this = _sys.modules[__name__]


def _wrap(name, narr):
    """``mx.nd.<name>``: the first ``narr`` arguments are arrays, options
    are keywords."""
    opdef = _registry.get(name)
    assert opdef is not None, name

    def op(*args, **kwargs):
        if len(args) > narr:
            raise TypeError(f"{name} takes {narr} array arguments; pass "
                            "options as keywords")
        return invoke(opdef.fn, args, kwargs, name=opdef.name,
                      differentiable=opdef.differentiable)

    op.__name__ = name
    op.__doc__ = opdef.doc
    return op


_UNARY = ["abs", "negative", "sign", "square", "sqrt", "exp", "log", "tanh",
          "clip", "sum", "sum_axis", "mean", "prod", "nansum", "nanprod",
          "max", "max_axis", "min", "min_axis", "argmax", "argmin", "norm",
          "cumsum", "logsumexp", "reshape", "transpose", "expand_dims",
          "squeeze", "broadcast_to", "cast", "relu", "sigmoid", "softmax",
          "log_softmax"]
_BINARY = [
    "elemwise_add", "broadcast_add", "add", "elemwise_sub", "broadcast_sub",
    "subtract", "elemwise_mul", "broadcast_mul", "multiply", "elemwise_div",
    "broadcast_div", "divide", "broadcast_power", "power",
    "broadcast_maximum", "maximum", "broadcast_minimum", "minimum",
    "broadcast_mod", "mod", "broadcast_hypot", "broadcast_equal", "equal",
    "broadcast_not_equal", "not_equal", "broadcast_greater", "greater",
    "broadcast_greater_equal", "greater_equal", "broadcast_lesser", "lesser",
    "broadcast_lesser_equal", "lesser_equal", "broadcast_logical_and",
    "logical_and", "broadcast_logical_or", "logical_or",
    "broadcast_logical_xor", "logical_xor", "dot", "batch_dot", "take",
    "pick"]
for _n in _UNARY:
    setattr(_this, _n, _wrap(_n, 1))
for _n in _BINARY:
    setattr(_this, _n, _wrap(_n, 2))

#: q, k, v positional; ``lengths`` (an NDArray), ``scale``, ``causal`` and
#: ``cache_offset`` as keywords (the JAX op's contract)
flash_attention = _wrap("flash_attention", 3)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    from ..base import resolve_dtype

    return invoke_op("one_hot", indices, depth=depth, on_value=on_value,
                     off_value=off_value, dtype=resolve_dtype(dtype))


def FullyConnected(data, weight, bias=None, **kwargs):
    args = [data, weight] + ([bias] if bias is not None else [])
    if bias is None:
        kwargs["no_bias"] = True
    return invoke_op("FullyConnected", *args, **kwargs)


def Convolution(data, weight, bias=None, **kwargs):
    args = [data, weight] + ([bias] if bias is not None else [])
    if bias is None:
        kwargs["no_bias"] = True
    return invoke_op("Convolution", *args, **kwargs)


#: data; (data, gamma, beta, moving_mean, moving_var); options as keywords
Pooling = _wrap("Pooling", 1)
BatchNorm = _wrap("BatchNorm", 5)
Activation = _wrap("Activation", 1)


def scaled_dot_product_attention(q, k, v, mask=None, **kwargs):
    """The dense attention chain (``ops.nn.scaled_dot_product_attention``):
    q, k, v and an optional ``mask`` are arrays; ``scale`` and ``causal``
    keywords."""
    args = [q, k, v] + ([mask] if mask is not None else [])
    return invoke_op("scaled_dot_product_attention", *args, **kwargs)


def slice(data, begin, end, step=None):  # noqa: A001 (mxnet name)
    return data.slice(begin, end, step)


def slice_axis(data, axis, begin, end):
    return data.slice_axis(axis, begin, end)


def swapaxes(data, dim1, dim2):
    return data.swapaxes(dim1, dim2)


SwapAxis = swapaxes


def flatten(data):
    return data.flatten()


Flatten = flatten


def stop_gradient(data):
    return data.detach()


BlockGrad = stop_gradient
Cast = _this.cast
Reshape = _this.reshape


def Custom(*data, op_type=None, **kwargs):
    """Invoke a registered custom op (reference ``mx.nd.Custom`` over
    ``mx.operator.register``)."""
    from ..operator import invoke_custom

    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return invoke_custom(op_type, list(data), kwargs)


__all__ = ["Activation", "BatchNorm", "BlockGrad", "Cast", "Convolution",
           "Custom", "Flatten", "FullyConnected", "NDArray", "Pooling", "Reshape", "SwapAxis", "arange", "array", "as_nd",
           "empty", "eye", "flash_attention", "flatten", "full", "invoke",
           "invoke_op", "load", "one_hot", "ones", "ones_like", "save",
           "scaled_dot_product_attention", "slice", "slice_axis",
           "stop_gradient", "swapaxes", "waitall",
           "zeros", "zeros_like"] + _UNARY + _BINARY
