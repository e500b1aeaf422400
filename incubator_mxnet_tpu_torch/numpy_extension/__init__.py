"""``mx.npx``: the numpy-extension namespace (the reference's
``python/mxnet/numpy_extension/``): the neural-network and framework ops
that numpy has no name for, beside ``mx.np``.

``set_np``/``reset_np`` exist for the reference's API: there they switch
MXNet to numpy semantics; here numpy semantics are the arrays' own, so
they record the flag that ``is_np_array``/``is_np_shape`` read.
"""

from __future__ import annotations

from ..ndarray import (Activation as activation, BatchNorm as batch_norm,
                       Convolution as convolution, Dropout as dropout,
                       Embedding as embedding,
                       FullyConnected as fully_connected,
                       LayerNorm as layer_norm, Pooling as pooling,
                       batch_dot, gather_nd, gelu, log_softmax, one_hot, pick,
                       relu, reshape_like, sequence_mask, sigmoid, silu,
                       softmax, topk)

__all__ = ["activation", "batch_dot", "batch_norm", "convolution", "dropout",
           "embedding", "fully_connected", "gather_nd", "gelu",
           "is_np_array", "is_np_shape", "layer_norm", "log_softmax",
           "one_hot", "pick", "pooling", "relu", "reset_np", "reshape_like",
           "sequence_mask", "set_np", "sigmoid", "silu", "softmax", "topk",
           "use_np"]

_np_active = False


def set_np(shape=True, array=True, dtype=False):
    """Record numpy semantics as on (they are the arrays' own)."""
    global _np_active
    _np_active = True


def reset_np():
    global _np_active
    _np_active = False


def is_np_array():
    return _np_active


def is_np_shape():
    return _np_active


def use_np(func_or_cls):
    """The reference's ``mx.util.use_np``: the callable as it is."""
    return func_or_cls
