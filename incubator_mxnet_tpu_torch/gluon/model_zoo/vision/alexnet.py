"""AlexNet (Krizhevsky et al. 2012).

Counterpart of the JAX package's ``gluon/model_zoo/vision/alexnet.py``:
five convs with ReLU and three max pools, then two 4096-wide ``Dense``
layers with ``Dropout(0.5)`` and the ``classes``-way output. The first
``Dense`` takes its width from the first forward (9216 at 224x224), so the
parameter count depends on the image size. NCHW with OIHW weights; the
JAX package leaves these convs to XLA, the port to cuDNN.
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D
from ._zoo import build

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """AlexNet; input (N, 3, H, W), 224x224 as published."""

    def __init__(self, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(64, 11, 4, 2, activation="relu"),
                              MaxPool2D(3, 2),
                              Conv2D(192, 5, padding=2, activation="relu"),
                              MaxPool2D(3, 2),
                              Conv2D(384, 3, padding=1, activation="relu"),
                              Conv2D(256, 3, padding=1, activation="relu"),
                              Conv2D(256, 3, padding=1, activation="relu"),
                              MaxPool2D(3, 2), Flatten(),
                              Dense(4096, activation="relu"), Dropout(0.5),
                              Dense(4096, activation="relu"), Dropout(0.5))
            self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(**kwargs):
    """AlexNet (reference ``vision.alexnet``)."""
    return build(AlexNet, **kwargs)
