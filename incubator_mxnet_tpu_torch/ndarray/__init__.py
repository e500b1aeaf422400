"""``mx.nd``: the imperative NDArray op namespace.

Counterpart of the JAX package's ``ndarray/__init__.py`` for the ops the
port has: wrappers generated from the op registry (``ops/tensor.py``,
``ops/nn.py``, ``ops/misc.py``, and the kernel ops
``flash_attention``/``fused_conv_bn``), every call through :func:`invoke`,
so autograd recording and the naive engine's sync apply alike.
``mx.nd.flash_attention`` launches the flash kernels on a CUDA array;
``invoke_op("fused_conv_bn", ...)`` the conv kernels; ``mx.nd.Custom``
runs a registered ``mx.operator`` op. The MXNet 1.x spellings the
reference keeps (``Concat``, ``SliceChannel``, ``SequenceMask``, ...) name
the same wrappers.
"""

from __future__ import annotations

import sys as _sys

from ..ops import flash_attention as _flash  # noqa: F401  (registers ops)
from ..ops import fused_conv as _fused_conv  # noqa: F401
from ..ops import misc as _misc  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _tensor  # noqa: F401
from .ndarray import (NDArray, arange, array, as_nd, empty, eye, full,
                      invoke, invoke_op, load, ones, save, waitall, zeros)

_this = _sys.modules[__name__]


def _wrap(name, narr, variadic=False):
    """``mx.nd.<name>``: the first ``narr`` arguments are arrays (every
    positional argument where ``variadic``), options are keywords."""
    opdef = _registry.get(name)
    assert opdef is not None, name

    def op(*args, **kwargs):
        if not variadic and len(args) > narr:
            raise TypeError(f"{name} takes {narr} array arguments; pass "
                            "options as keywords")
        return invoke(opdef.fn, args, kwargs, name=opdef.name,
                      differentiable=opdef.differentiable)

    op.__name__ = name
    op.__doc__ = opdef.doc
    return op


_UNARY = [
    "abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "square", "sqrt",
    "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10", "log2", "log1p",
    "expm1", "reciprocal", "negative", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "erf", "erfinv", "gamma", "gammaln", "digamma", "clip",
    "isnan", "isinf", "isfinite", "sum", "sum_axis", "mean", "prod",
    "nansum", "nanprod", "max", "max_axis", "min", "min_axis", "argmax",
    "argmin", "norm", "cumsum", "logsumexp", "reshape", "transpose",
    "expand_dims", "squeeze", "flip", "reverse", "tile", "repeat", "pad",
    "depth_to_space", "space_to_depth", "split", "sort", "argsort", "topk",
    "cast", "zeros_like", "ones_like", "shape_array", "size_array", "diag",
    "broadcast_axis", "broadcast_axes", "broadcast_to", "softmax",
    "log_softmax", "relu", "sigmoid", "softsign", "softrelu", "gelu",
    "silu", "mish", "hard_sigmoid", "Activation", "activation",
    "l2_normalization", "L2Normalization", "adaptive_avg_pool2d",
    # ops/misc.py
    "degrees", "radians", "round", "logical_not", "erfc", "log_sigmoid",
    "index_array", "moments", "UpSampling", "BilinearResize2D",
    "GridGenerator", "MakeLoss", "make_loss", "Pooling", "Pooling_v1"]
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
    "broadcast_logical_xor", "logical_xor", "broadcast_minus",
    "broadcast_plus", "dot", "batch_dot", "matmul", "linalg_gemm2", "take",
    "pick", "gather_nd", "boolean_mask", "slice_like", "sequence_mask",
    "sequence_last", "sequence_reverse", "Embedding", "embedding",
    "softmax_cross_entropy", "SoftmaxOutput", "softmax_output",
    # ops/misc.py
    "batch_take", "BilinearSampler", "SpatialTransformer", "ROIPooling",
    "ROIAlign", "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput"]
_TERNARY = ["where", "scatter_nd"]
_VARIADIC = ["concat", "concatenate", "stack", "khatri_rao"]
for _n in _UNARY:
    setattr(_this, _n, _wrap(_n, 1))
for _n in _BINARY:
    setattr(_this, _n, _wrap(_n, 2))
for _n in _TERNARY:
    setattr(_this, _n, _wrap(_n, 3))
for _n in _VARIADIC:
    setattr(_this, _n, _wrap(_n, 0, variadic=True))

#: q, k, v positional; ``lengths`` (an NDArray), ``scale``, ``causal`` and
#: ``cache_offset`` as keywords (the JAX op's contract)
flash_attention = _wrap("flash_attention", 3)
#: (data, gamma, beta, moving_mean, moving_var); options as keywords
BatchNorm = _wrap("BatchNorm", 5)
BatchNorm_v1 = _wrap("BatchNorm_v1", 5)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    from ..base import resolve_dtype

    return invoke_op("one_hot", indices, depth=depth, on_value=on_value,
                     off_value=off_value, dtype=resolve_dtype(dtype))


def _with_bias(name):
    """``mx.nd.<name>(data, weight, bias=None, **options)``: no bias sets
    ``no_bias``."""
    def op(data, weight, bias=None, **kwargs):
        args = [data, weight] + ([bias] if bias is not None else [])
        if bias is None:
            kwargs["no_bias"] = True
        return invoke_op(name, *args, **kwargs)

    op.__name__ = name
    return op


FullyConnected = _with_bias("FullyConnected")
Convolution = _with_bias("Convolution")
Deconvolution = _with_bias("Deconvolution")


def LayerNorm(data, gamma, beta, **kwargs):
    return invoke_op("LayerNorm", data, gamma, beta, **kwargs)


def GroupNorm(data, gamma, beta, **kwargs):
    return invoke_op("GroupNorm", data, gamma, beta, **kwargs)


def InstanceNorm(data, gamma, beta, **kwargs):
    return invoke_op("InstanceNorm", data, gamma, beta, **kwargs)


def rms_norm(data, gamma, **kwargs):
    return invoke_op("RMSNorm", data, gamma, **kwargs)


def Dropout(data, p=0.5, **kwargs):
    """Dropout of rate ``p``; ``training`` defaults to
    ``autograd.is_training()`` (on inside ``autograd.record()``)."""
    from .. import autograd

    kwargs.setdefault("training", autograd.is_training())
    return invoke_op("Dropout", data, p=p, **kwargs)


def LeakyReLU(data, gamma=None, **kwargs):
    """``gamma`` (an array) is read by ``act_type="prelu"`` alone."""
    if kwargs.get("act_type") == "prelu" and gamma is not None:
        return invoke_op("LeakyReLU", data, gamma, **kwargs)
    return invoke_op("LeakyReLU", data, **kwargs)


def scaled_dot_product_attention(q, k, v, mask=None, **kwargs):
    """The dense attention chain (``ops.nn.scaled_dot_product_attention``):
    q, k, v and an optional ``mask`` are arrays; ``scale`` and ``causal``
    keywords."""
    args = [q, k, v] + ([mask] if mask is not None else [])
    return invoke_op("scaled_dot_product_attention", *args, **kwargs)


def ravel_multi_index(data, shape):
    return invoke_op("ravel_multi_index", data, shape=tuple(shape))


def unravel_index(data, shape):
    return invoke_op("unravel_index", data, shape=tuple(shape))


def slice(data, begin, end, step=None):  # noqa: A001 (mxnet name)
    return data.slice(begin, end, step)


def slice_axis(data, axis, begin, end):
    return data.slice_axis(axis, begin, end)


def swapaxes(data, dim1, dim2):
    return data.swapaxes(dim1, dim2)


def flatten(data):
    return data.flatten()


def stop_gradient(data):
    return data.detach()


def SoftmaxActivation(data, mode="instance"):
    """The deprecated reference op: softmax over the channels (axis 1,
    ``mode="channel"``) or each instance's last axis."""
    return softmax(data, axis=1 if mode == "channel" else -1)  # noqa: F821


def Custom(*data, op_type=None, **kwargs):
    """Invoke a registered custom op (reference ``mx.nd.Custom`` over
    ``mx.operator.register``)."""
    from ..operator import invoke_custom

    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return invoke_custom(op_type, list(data), kwargs)


# the reference's MXNet 1.x spellings
BlockGrad = block_grad = stop_gradient
Cast = _this.cast
Concat = _this.concat
Flatten = flatten
Pad = _this.pad
Reshape = _this.reshape
SequenceLast = _this.sequence_last
SequenceMask = _this.sequence_mask
SequenceReverse = _this.sequence_reverse
SliceChannel = slice_channel = _this.split
SwapAxis = swapaxes

__all__ = ["BatchNorm", "BatchNorm_v1", "BlockGrad", "Cast", "Concat",
           "Convolution", "Custom", "Deconvolution", "Dropout", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "NDArray", "Pad", "Reshape", "SequenceLast",
           "SequenceMask", "SequenceReverse", "SliceChannel",
           "SoftmaxActivation", "SwapAxis", "arange", "array", "as_nd",
           "block_grad", "empty", "eye", "flash_attention", "flatten",
           "full", "invoke", "invoke_op", "load", "one_hot", "ones",
           "ravel_multi_index", "rms_norm", "save",
           "scaled_dot_product_attention", "slice", "slice_axis",
           "slice_channel", "stop_gradient", "swapaxes", "unravel_index",
           "waitall", "zeros"] + _UNARY + _BINARY + _TERNARY + _VARIADIC
