"""Activation blocks.

Counterpart of the JAX package's ``gluon/nn/activations.py`` (reference
``python/mxnet/gluon/nn/activations.py``): ``LeakyReLU``, ``PReLU`` (a
learned slope a channel, on axis 1), ``ELU``, ``SELU``, ``GELU``
(``approximate=True``: the tanh form) and ``SiLU`` (``Swish``), over the
registered ``LeakyReLU``, ``gelu`` and ``silu`` ops.
"""

from __future__ import annotations

from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["ELU", "GELU", "LeakyReLU", "PReLU", "SELU", "SiLU", "Swish"]


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of ``in_channels`` values
    (one a channel of axis 1, or one for every channel), drawn by
    ``alpha_initializer`` (zeros, as the reference's)."""

    def __init__(self, alpha_initializer="zeros", in_channels=1,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._declare("alpha", (in_channels,), init=alpha_initializer)

    def forward(self, x):
        return F.leaky_relu(x, self.alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` where positive, ``alpha * (exp(x) - 1)`` elsewhere."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """GELU: the tanh approximation when ``approximate``, else the erf
    form."""

    def __init__(self, approximate=True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._approx = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approx)


class SiLU(HybridBlock):
    """``x * sigmoid(x)``."""

    def forward(self, x):
        return F.silu(x)


Swish = SiLU
