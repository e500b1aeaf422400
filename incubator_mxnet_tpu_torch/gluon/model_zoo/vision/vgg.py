"""VGG 11/13/16/19, with and without BatchNorm (Simonyan & Zisserman
1409.1556).

Counterpart of the JAX package's ``gluon/model_zoo/vision/vgg.py``:
``VGG(layers, filters, batch_norm)`` stacks ``layers[i]`` 3x3 convs of
``filters[i]`` channels (each with BatchNorm when ``batch_norm``, then
ReLU) and a 2x2 max pool a stage, then two 4096-wide ``Dense`` layers with
``Dropout(0.5)`` and the ``classes``-way output. The first ``Dense`` takes
its width from the first forward (25088 at 224x224).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout, Flatten,
                   HybridSequential, MaxPool2D)
from ._zoo import build

__all__ = ["VGG", "get_vgg", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn",
           "vgg16", "vgg16_bn", "vgg19", "vgg19_bn", "vgg_spec"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    """VGG; input (N, 3, H, W), 224x224 as published."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            for num, width in zip(layers, filters):
                for _ in range(num):
                    self.features.add(Conv2D(width, 3, padding=1))
                    if batch_norm:
                        self.features.add(BatchNorm())
                    self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(2, 2))
            self.features.add(Flatten(), Dense(4096, activation="relu"),
                              Dropout(0.5), Dense(4096, activation="relu"),
                              Dropout(0.5))
            self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, batch_norm=False, **kwargs):
    """VGG of depth ``num_layers`` (11, 13, 16 or 19)."""
    layers, filters = vgg_spec[num_layers]
    return build(VGG, layers, filters, batch_norm=batch_norm, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
