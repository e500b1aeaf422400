"""Basic layers of the ported path.

Counterpart of the JAX package's ``gluon/nn/basic_layers.py``: ``Dense``,
``Embedding``, ``LayerNorm``, ``Dropout``, ``Sequential`` and
``HybridSequential``, with the reference's parameter names and layouts
(Dense weight ``(units, in_units)``, LayerNorm ``gamma``/``beta``; the
children of a sequential block are named ``0``, ``1``, ..., so their
parameters read ``stages.0.0.conv1_weight`` as in the JAX package).
"""

from __future__ import annotations

from ... import autograd
from ...ops import nn as F
from ..block import Block

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm",
           "Sequential"]


class Sequential(Block):
    """Stack of blocks run in order (reference ``nn.Sequential``)."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x):
        for b in self._modules.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential):
    """Reference ``nn.HybridSequential``: the same stack here, since the
    port runs eagerly (there is nothing to hybridize)."""


class Dense(Block):
    """Fully-connected layer: y = x·Wᵀ + b."""

    def __init__(self, units, use_bias=True, flatten=True, in_units=0):
        super().__init__()
        if not in_units:
            raise ValueError("Dense needs in_units: the port has no "
                             "deferred shape inference")
        self._flatten = flatten
        self._declare("weight", (units, in_units))
        if use_bias:
            self._declare("bias", (units,))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.fully_connected(x, self.weight, self.bias,
                                 flatten=self._flatten)


class Embedding(Block):
    """Lookup table (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self._declare("weight", (input_dim, output_dim))

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(Block):
    """Layer normalization over the last axis."""

    def __init__(self, epsilon=1e-5, in_channels=0):
        super().__init__()
        if not in_channels:
            raise ValueError("LayerNorm needs in_channels")
        self._eps = epsilon
        self._declare("gamma", (in_channels,))
        self._declare("beta", (in_channels,))

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, eps=self._eps)


class Dropout(Block):
    """Inverted dropout, active iff ``autograd.is_training()`` (on inside
    ``autograd.record()`` and ``train_mode()``, off elsewhere), as in the
    JAX package. The mask is drawn from the device's ``random.generator``."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        return F.dropout(x, self._rate, training=autograd.is_training())
