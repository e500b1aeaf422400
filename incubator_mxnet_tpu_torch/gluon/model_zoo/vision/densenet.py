"""DenseNet 121/161/169/201 (Huang et al. 1608.06993).

Counterpart of the JAX package's ``gluon/model_zoo/vision/densenet.py``:
``_DenseLayer`` (BatchNorm, ReLU, 1x1 conv to ``bn_size * growth_rate``,
BatchNorm, ReLU, 3x3 conv to ``growth_rate``, an optional ``Dropout``; its
input and its output concatenated on the channels), ``_make_transition``
(BatchNorm, ReLU, 1x1 conv, 2x2 average pool) and ``DenseNet``, with
``densenet_spec`` for the four published depths. The concatenations grow
the activations with depth: the memory of a training step grows with
them.
"""

from __future__ import annotations

from ....ops.tensor import concat
from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ._zoo import build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet_spec"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.body = HybridSequential(prefix="")
            self.body.add(BatchNorm(), Activation("relu"),
                          Conv2D(bn_size * growth_rate, 1, use_bias=False),
                          BatchNorm(), Activation("relu"),
                          Conv2D(growth_rate, 3, padding=1, use_bias=False))
            if dropout:
                self.body.add(Dropout(dropout))

    def forward(self, x):
        return concat(x, self.body(x), axis=1)


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm(), Activation("relu"),
            Conv2D(num_output_features, 1, use_bias=False), AvgPool2D(2, 2))
    return out


class DenseNet(HybridBlock):
    """DenseNet: a 7x7/2 stem with a 3x3/2 max pool, ``block_config``
    dense blocks of ``growth_rate`` with transitions that halve the
    channels between them, BatchNorm, ReLU, global average pooling and the
    ``classes``-way output. Input (N, 3, H, W)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, 7, 2, 3,
                                     use_bias=False),
                              BatchNorm(), Activation("relu"),
                              MaxPool2D(3, 2, 1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                block = HybridSequential(prefix=f"denseblock{i + 1}_")
                with block.name_scope():
                    for _ in range(num_layers):
                        block.add(_DenseLayer(growth_rate, bn_size, dropout,
                                              prefix=""))
                self.features.add(block)
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features //= 2
                    self.features.add(_make_transition(num_features))
            self.features.add(BatchNorm(), Activation("relu"),
                              GlobalAvgPool2D(),
                              Flatten())
            self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _get_densenet(num_layers, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return build(DenseNet, num_init_features, growth_rate, block_config,
                 **kwargs)


def densenet121(**kwargs):
    return _get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return _get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return _get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return _get_densenet(201, **kwargs)
