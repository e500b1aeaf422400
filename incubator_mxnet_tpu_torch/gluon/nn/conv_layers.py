"""Convolution and pooling layers.

Counterpart of the JAX package's ``gluon/nn/conv_layers.py``: ``Conv1D``,
``Conv2D``, ``Conv3D``, ``Conv1DTranspose``, ``Conv2DTranspose``, the
max, average and global pools of 1-3 spatial axes and
``ReflectionPad2D``, over ``ops.nn.convolution``, ``ops.nn.deconvolution``
and ``ops.nn.pooling`` (cuDNN on the card; the JAX package leaves them to
XLA, outside its Pallas kernels). Layout NC + spatial axes, weight
``(channels, in_channels / groups, *kernel)`` (a transposed convolution's
``(in_channels, channels / groups, *kernel)``), as the reference's.
``in_channels=0`` takes ``x.shape[1]`` from the first input
(``Block.infer_shape``).
"""

from __future__ import annotations

import torch.nn.functional as TF

from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "Conv1D",
           "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "ReflectionPad2D"]


class _Conv(HybridBlock):
    """Convolution of ``ndim`` spatial axes with an optional bias and
    activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not layout.startswith("NC"):
            raise NotImplementedError(f"layout {layout!r}: the port's "
                                      "convolutions are NC + spatial axes")
        self._channels = channels
        self._kernel = F._ntuple(kernel_size, ndim)
        self._strides = F._ntuple(strides, ndim)
        self._padding = F._ntuple(padding, ndim)
        self._dilation = F._ntuple(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._declare("weight", (channels, in_channels // groups)
                      + self._kernel, init=weight_initializer)
        if use_bias:
            self._declare("bias", (channels,), init=bias_initializer)
        else:
            self.register_parameter("bias", None)

    def infer_shape(self, x, *args):
        return {"weight": (self._channels, x.shape[1] // self._groups)
                + self._kernel}

    def forward(self, x):
        # the reference's arguments, so the op records its attributes
        kw = dict(kernel=self._kernel, stride=self._strides,
                  pad=self._padding, dilate=self._dilation,
                  num_filter=self._channels, num_group=self._groups)
        if self.bias is None:
            out = F.convolution(x, self.weight, no_bias=True, **kw)
        else:
            out = F.convolution(x, self.weight, self.bias, **kw)
        return out if self._act is None else \
            F.activation(out, act_type=self._act)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, **kwargs)


class _ConvTranspose(HybridBlock):
    """Transposed convolution of ``ndim`` spatial axes
    (``ops.nn.deconvolution``): each output axis is ``(n - 1) * stride +
    dilation * (k - 1) + 1 - 2 * padding + output_padding``."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = F._ntuple(kernel_size, ndim)
        self._strides = F._ntuple(strides, ndim)
        self._padding = F._ntuple(padding, ndim)
        self._out_padding = F._ntuple(output_padding, ndim)
        self._dilation = F._ntuple(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._declare("weight", (in_channels, channels // groups)
                      + self._kernel, init=weight_initializer)
        if use_bias:
            self._declare("bias", (channels,), init=bias_initializer)
        else:
            self.register_parameter("bias", None)

    def infer_shape(self, x, *args):
        return {"weight": (x.shape[1], self._channels // self._groups)
                + self._kernel}

    def forward(self, x):
        kw = dict(kernel=self._kernel, stride=self._strides,
                  pad=self._padding, adj=self._out_padding,
                  dilate=self._dilation, num_filter=self._channels,
                  num_group=self._groups)
        if self.bias is None:
            out = F.deconvolution(x, self.weight, no_bias=True, **kw)
        else:
            out = F.deconvolution(x, self.weight, self.bias, **kw)
        return out if self._act is None else \
            F.activation(out, act_type=self._act)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, ndim=1, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, ndim=2, **kwargs)


class ReflectionPad2D(HybridBlock):
    """The two spatial axes of NCHW padded by ``padding`` (an int or
    ``(h, w)``) on both sides, mirrored about the edge (numpy's
    ``"reflect"``)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._padding = F._ntuple(padding, 2)

    def forward(self, x):
        ph, pw = self._padding
        return TF.pad(x, (pw, pw, ph, ph), mode="reflect")


class _Pool(HybridBlock):
    """Pooling of ``ndim`` spatial axes (``ops.nn.pooling``); ``strides``
    defaults to ``pool_size``, ``ceil_mode`` is the reference's "full"
    convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, ndim, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kernel = F._ntuple(pool_size, ndim)
        self._strides = F._ntuple(pool_size if strides is None else strides,
                                  ndim)
        self._padding = F._ntuple(padding, ndim)
        self._convention = "full" if ceil_mode else "valid"
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return F.pooling(x, self._kernel, self._type, self._strides,
                         self._padding, global_pool=self._global,
                         count_include_pad=self._count_include_pad,
                         pooling_convention=self._convention)


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 1, prefix=prefix, params=params)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 2, prefix=prefix, params=params)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 3, prefix=prefix, params=params)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, ceil_mode=False,
                 count_include_pad=True, prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 1, count_include_pad,
                         prefix=prefix, params=params)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 2, count_include_pad,
                         prefix=prefix, params=params)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 3, count_include_pad,
                         prefix=prefix, params=params)


class GlobalMaxPool1D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "max", 1,
                         prefix=prefix, params=params)


class GlobalMaxPool2D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "max", 2,
                         prefix=prefix, params=params)


class GlobalMaxPool3D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "max", 3,
                         prefix=prefix, params=params)


class GlobalAvgPool1D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "avg", 1,
                         prefix=prefix, params=params)


class GlobalAvgPool2D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "avg", 2,
                         prefix=prefix, params=params)


class GlobalAvgPool3D(_Pool):
    def __init__(self, prefix=None, params=None):
        super().__init__(1, None, 0, False, True, "avg", 3,
                         prefix=prefix, params=params)
