"""SqueezeNet 1.0 and 1.1 (Iandola et al. 1602.07360).

Counterpart of the JAX package's ``gluon/model_zoo/vision/squeezenet.py``:
``_Fire`` (a 1x1 squeeze, then 1x1 and 3x3 expands concatenated on the
channels) and ``SqueezeNet("1.0" | "1.1")``, whose 3x3/2 max pools take
``ceil_mode`` (the reference's "full" convention), ``Dropout(0.5)`` and a
1x1 conv head averaged over the map.
"""

from __future__ import annotations

from ....ops.tensor import concat
from ...block import HybridBlock
from ...nn import (Conv2D, Dropout, Flatten, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ._zoo import build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.squeeze = Conv2D(squeeze, 1, activation="relu")
            self.expand1 = Conv2D(expand1x1, 1, activation="relu")
            self.expand3 = Conv2D(expand3x3, 3, padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return concat(self.expand1(x), self.expand3(x), axis=1)


def _pool():
    return MaxPool2D(3, 2, ceil_mode=True)


class SqueezeNet(HybridBlock):
    """SqueezeNet ``version`` "1.0" or "1.1"; input (N, 3, H, W)."""

    def __init__(self, version="1.0", classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, 7, 2, activation="relu"), _pool(),
                                  _Fire(16, 64, 64), _Fire(16, 64, 64),
                                  _Fire(32, 128, 128), _pool(),
                                  _Fire(32, 128, 128), _Fire(48, 192, 192),
                                  _Fire(48, 192, 192), _Fire(64, 256, 256),
                                  _pool(), _Fire(64, 256, 256))
            else:
                self.features.add(Conv2D(64, 3, 2, activation="relu"),
                                  _pool(), _Fire(16, 64, 64),
                                  _Fire(16, 64, 64), _pool(),
                                  _Fire(32, 128, 128), _Fire(32, 128, 128),
                                  _pool(), _Fire(48, 192, 192),
                                  _Fire(48, 192, 192), _Fire(64, 256, 256),
                                  _Fire(64, 256, 256))
            self.features.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, 1, activation="relu"),
                            GlobalAvgPool2D(), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return build(SqueezeNet, "1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return build(SqueezeNet, "1.1", **kwargs)
