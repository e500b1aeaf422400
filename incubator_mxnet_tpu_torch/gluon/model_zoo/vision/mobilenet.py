"""MobileNet v1, v2 and v3 (Howard et al. 1704.04861, Sandler et al.
1801.04381, Howard et al. 1905.02244).

Counterpart of the JAX package's ``gluon/model_zoo/vision/mobilenet.py``.
v1: ``_add_conv``/``_add_conv_dw`` (a depthwise 3x3 conv, ``groups`` equal
to its channels, then a 1x1 conv, each with BatchNorm and ReLU). v2:
``LinearBottleneck`` (1x1 expansion, depthwise 3x3, linear 1x1
projection, ReLU6, a shortcut when the shape allows) and a bias-free 1x1
conv head. v3: ``_V3Bottleneck`` with squeeze-and-excite (``_SE``,
hard-sigmoid gate) and hard-swish, in the "large" and "small"
configurations (``_V3_LARGE``, ``_V3_SMALL``). The depthwise convs go to
cuDNN's grouped kernels on the card, weights ``(C, 1, k, k)``.
"""

from __future__ import annotations

from ....ops.nn import relu
from ....ops.tensor import _div_scalar, _plus_scalar, add, clip, mul
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential)
from ._zoo import build

__all__ = ["LinearBottleneck", "MobileNet", "MobileNetV2", "MobileNetV3",
           "mobilenet0_25", "mobilenet0_5", "mobilenet0_75", "mobilenet1_0",
           "mobilenet_v2_0_25", "mobilenet_v2_0_5", "mobilenet_v2_0_75",
           "mobilenet_v2_1_0", "mobilenet_v3_large", "mobilenet_v3_small"]


def _hard_sigmoid(x):
    """``clip(x + 3, 0, 6) / 6`` in registered ops (an export records
    them)."""
    return _div_scalar(clip(_plus_scalar(x, scalar=3.0), a_min=0.0,
                            a_max=6.0), scalar=6.0)


class _ReLU6(HybridBlock):
    def forward(self, x):
        return clip(x, a_min=0.0, a_max=6.0)


class _HardSigmoid(HybridBlock):
    def forward(self, x):
        return _hard_sigmoid(x)


class _HardSwish(HybridBlock):
    def forward(self, x):
        return mul(x, _hard_sigmoid(x))


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False), BatchNorm())
    if active:
        out.add(_ReLU6() if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: expand by ``t``, depthwise 3x3 at
    ``stride``, project linearly to ``channels``."""

    def __init__(self, in_channels, channels, t, stride,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.use_shortcut = stride == 1 and in_channels == channels
            self.out = HybridSequential(prefix="")
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False)

    def forward(self, x):
        out = self.out(x)
        return add(out, x) if self.use_shortcut else out


class MobileNet(HybridBlock):
    """MobileNet v1 at width ``multiplier``; input (N, 3, H, W)."""

    def __init__(self, multiplier=1.0, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(GlobalAvgPool2D(), Flatten())
            self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2 at width ``multiplier``; input (N, 3, H, W)."""

    def __init__(self, multiplier=1.0, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1, relu6=True)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                                 + [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                              + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(LinearBottleneck(in_c, c, t, s, prefix=""))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                else 1280
            _add_conv(self.features, last_channels, relu6=True)
            self.features.add(GlobalAvgPool2D())
            self.output = HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(Conv2D(classes, 1, use_bias=False,
                                       prefix="pred_"), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


class _SE(HybridBlock):
    """Squeeze-and-excite with a hard-sigmoid gate."""

    def __init__(self, channels, reduction=4, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.pool = GlobalAvgPool2D()
            self.fc1 = Conv2D(max(1, channels // reduction), 1)
            self.fc2 = Conv2D(channels, 1)
            self.gate = _HardSigmoid()

    def forward(self, x):
        w = self.gate(self.fc2(relu(self.fc1(self.pool(x)))))
        return mul(x, w)


class _V3Bottleneck(HybridBlock):
    def __init__(self, in_channels, exp, channels, kernel, stride, se, act,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.use_shortcut = stride == 1 and in_channels == channels

            def nonlinearity():
                return _HardSwish() if act == "hswish" else Activation("relu")

            self.out = HybridSequential(prefix="")
            if exp != in_channels:
                self.out.add(Conv2D(exp, 1, use_bias=False), BatchNorm(),
                             nonlinearity())
            self.out.add(Conv2D(exp, kernel, stride, kernel // 2, groups=exp,
                                use_bias=False), BatchNorm(), nonlinearity())
            if se:
                self.out.add(_SE(exp))
            self.out.add(Conv2D(channels, 1, use_bias=False), BatchNorm())

    def forward(self, x):
        out = self.out(x)
        return add(out, x) if self.use_shortcut else out


# (kernel, exp, out, SE, activation, stride)
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1), (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1), (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]


class MobileNetV3(HybridBlock):
    """MobileNet v3 ``mode`` "large" or "small" at width ``multiplier``
    (every width at least 8); input (N, 3, H, W)."""

    def __init__(self, mode="large", multiplier=1.0, classes=1000,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            if mode not in ("large", "small"):
                raise ValueError(
                    f"mode must be 'large' or 'small', got {mode!r}")
            cfg = _V3_LARGE if mode == "large" else _V3_SMALL
            last_exp = 960 if mode == "large" else 576
            last_ch = 1280 if mode == "large" else 1024

            def _c(v):
                return max(8, int(v * multiplier))

            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(_c(16), 3, 2, 1, use_bias=False),
                              BatchNorm(), _HardSwish())
            in_ch = _c(16)
            for k, exp, out_ch, se, act, stride in cfg:
                self.features.add(_V3Bottleneck(in_ch, _c(exp), _c(out_ch), k,
                                                stride, se, act))
                in_ch = _c(out_ch)
            self.features.add(Conv2D(_c(last_exp), 1, use_bias=False),
                              BatchNorm(), _HardSwish(), GlobalAvgPool2D())
            self.output = HybridSequential(prefix="output_")
            self.output.add(Flatten(), Dense(last_ch, in_units=_c(last_exp)),
                            _HardSwish(), Dense(classes, in_units=last_ch))

    def forward(self, x):
        return self.output(self.features(x))


def mobilenet1_0(**kwargs):
    return build(MobileNet, 1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return build(MobileNet, 0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return build(MobileNet, 0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return build(MobileNet, 0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return build(MobileNetV2, 1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return build(MobileNetV2, 0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return build(MobileNetV2, 0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return build(MobileNetV2, 0.25, **kwargs)


def mobilenet_v3_large(**kwargs):
    return build(MobileNetV3, "large", **kwargs)


def mobilenet_v3_small(**kwargs):
    return build(MobileNetV3, "small", **kwargs)
