"""ResNet v1/v2 of the gluon layer set (the unfused zoo models).

Counterpart of the JAX package's ``gluon/model_zoo/vision/resnet.py`` (He
et al. 1512.03385 and 1603.05027): ``BasicBlockV1/V2``,
``BottleneckV1/V2`` (the stride on the 3x3, as the reference),
``ResNetV1/V2`` with ``thumbnail`` for small images, ``get_resnet`` and
``resnet{18,34,50,101,152}_v{1,2}``. Every conv, BatchNorm and pool is a
gluon layer (``gluon.nn``), NCHW with OIHW weights, and no hand-written
kernel runs here: the JAX package leaves these convs to XLA, the port to
cuDNN. Parameter names are the JAX package's structural names
(``features.0.weight``, ``features.4.0.body.0.weight``,
``features.4.0.downsample.1.running_var``, ``output.weight``), so
``load_jax_params`` carries weights across by name, and the prefix names
are the reference's (``name_scope``, ``stage1_``). The ReLU after the sum,
the sum and the flatten are registered ops, as the reference's, so the
net exports. Channel counts not given by ``in_channels`` are filled in by
the first forward.
"""

from __future__ import annotations

from ....ops.nn import relu
from ....ops.tensor import add as elemwise_add
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ...nn.basic_layers import flatten
from ._zoo import build

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "resnet101_v1",
           "resnet101_v2", "resnet152_v1", "resnet152_v2", "resnet18_v1",
           "resnet18_v2", "resnet34_v1", "resnet34_v2", "resnet50_v1",
           "resnet50_v2"]


def _conv3x3(channels, stride, in_channels):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels)


def _downsample_v1(channels, stride, in_channels):
    ds = HybridSequential(prefix="")
    ds.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels))
    ds.add(BatchNorm())
    return ds


class BasicBlockV1(HybridBlock):
    """Two 3x3 convs with BatchNorm, ReLU after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.body = HybridSequential(prefix="")
            self.body.add(_conv3x3(channels, stride, in_channels),
                          BatchNorm(), Activation("relu"),
                          _conv3x3(channels, 1, channels), BatchNorm())
            self.downsample = _downsample_v1(channels, stride,
                                             in_channels) \
                if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return relu(elemwise_add(x, residual))


class BottleneckV1(HybridBlock):
    """1x1, 3x3 (strided), 1x1 convs with BatchNorm, ReLU after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.body = HybridSequential(prefix="")
            self.body.add(Conv2D(channels // 4, kernel_size=1, strides=1,
                                 use_bias=False), BatchNorm(),
                          Activation("relu"),
                          _conv3x3(channels // 4, stride, channels // 4),
                          BatchNorm(), Activation("relu"),
                          Conv2D(channels, kernel_size=1, strides=1,
                                 use_bias=False), BatchNorm())
            self.downsample = _downsample_v1(channels, stride,
                                             in_channels) \
                if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return relu(elemwise_add(x, residual))


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BatchNorm and ReLU before each conv."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.bn1 = BatchNorm()
            self.conv1 = _conv3x3(channels, stride, in_channels)
            self.bn2 = BatchNorm()
            self.conv2 = _conv3x3(channels, 1, channels)
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels) \
                if downsample else None

    def forward(self, x):
        residual = x
        x = relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(relu(self.bn2(x)))
        return elemwise_add(x, residual)


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: BatchNorm and ReLU before each conv."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.bn1 = BatchNorm()
            self.conv1 = Conv2D(channels // 4, 1, 1, use_bias=False)
            self.bn2 = BatchNorm()
            self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
            self.bn3 = BatchNorm()
            self.conv3 = Conv2D(channels, 1, 1, use_bias=False)
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels) \
                if downsample else None

    def forward(self, x):
        residual = x
        x = relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(relu(self.bn2(x)))
        x = self.conv3(relu(self.bn3(x)))
        return elemwise_add(x, residual)


def _make_layer(block, layers, channels, stride, stage, in_channels):
    layer = HybridSequential(prefix=f"stage{stage}_")
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return layer


class ResNetV1(HybridBlock):
    """ResNet v1: a 7x7/2 stem with max pooling (a 3x3 conv when
    ``thumbnail``), ``len(layers)`` stages of ``block``, global average
    pooling and a ``classes``-way ``Dense``. Input (N, 3, H, W)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3,
                                         use_bias=False),
                                  BatchNorm(), Activation("relu"),
                                  MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, channels[i]))
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(flatten(self.features(x)))


class ResNetV2(HybridBlock):
    """ResNet v2: a BatchNorm of the input (no scale, no shift), the stem
    of v1, ``len(layers)`` stages of pre-activation ``block``, BatchNorm,
    ReLU, global average pooling and a ``classes``-way ``Dense``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3,
                                         use_bias=False),
                                  BatchNorm(), Activation("relu"),
                                  MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels))
                in_channels = channels[i + 1]
            self.features.add(BatchNorm(), Activation("relu"),
                              GlobalAvgPool2D(), Flatten())
            self.output = Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` 1 or 2 of depth ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to ``ResNetV1``/``ResNetV2`` (``classes``,
    ``thumbnail``). No pretrained weights: there are none to fetch."""
    if num_layers not in resnet_spec:
        raise ValueError(f"invalid resnet depth {num_layers}")
    if version not in (1, 2):
        raise ValueError("version must be 1 or 2")
    block_type, layers, channels = resnet_spec[num_layers]
    return build(resnet_net_versions[version - 1],
                 resnet_block_versions[version - 1][block_type], layers,
                 channels, pretrained=pretrained, ctx=ctx, root=root,
                 **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
