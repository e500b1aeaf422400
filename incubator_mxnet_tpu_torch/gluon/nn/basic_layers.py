"""Basic layers of the ported path.

Counterpart of the JAX package's ``gluon/nn/basic_layers.py``: ``Dense``,
``Activation``, ``Flatten``, ``BatchNorm``, ``Embedding``, ``LayerNorm``,
``Dropout``, ``Sequential`` and ``HybridSequential``, with the reference's
parameter names, layouts and defaults (Dense weight ``(units,
in_units)``, BatchNorm ``gamma``/``beta``/``running_mean``/
``running_var``; the children of a sequential block are named ``0``,
``1``, ..., so their parameters read ``features.4.0.body.0.weight`` as in
the JAX package). ``Dense`` without ``in_units`` and ``BatchNorm``
without ``in_channels`` take them from their first input
(``Block.infer_shape``).
"""

from __future__ import annotations

import math

import torch

from ... import autograd
from ...ops import nn as F
from ..block import Block

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridSequential", "LayerNorm", "Sequential"]


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
    """Fully-connected layer: ``y = act(x·Wᵀ + b)``, weight ``(units,
    in_units)``. ``in_units=0`` takes ``prod(x.shape[1:])`` (``flatten``)
    or ``x.shape[-1]`` from the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._act = activation
        self._declare("weight", (units, in_units), init=weight_initializer,
                      dtype=dtype)
        if use_bias:
            self._declare("bias", (units,), init=bias_initializer,
                          dtype=dtype)
        else:
            self.register_parameter("bias", None)

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        return {"weight": (self._units, in_units)}

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                flatten=self._flatten)
        return out if self._act is None else F.activation(out, self._act)


class Activation(Block):
    """``Activation(act_type)`` of ``ops.nn.activation`` (relu, sigmoid,
    tanh, softrelu, softsign, gelu, ...)."""

    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return F.activation(x, self._act)


class Flatten(Block):
    """``(N, ...) -> (N, prod(...))``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class BatchNorm(Block):
    """Batch normalization over every axis but ``axis``, with running
    statistics (reference ``nn.BatchNorm``).

    In training (``autograd.is_training()`` and not ``use_global_stats``)
    the output takes the batch's mean and biased variance, and the running
    statistics move in place, ``running <- running * momentum + batch * (1
    - momentum)``, as the reference's; elsewhere the running statistics
    normalize. They are ``grad_req="null"`` parameters: no trainer updates
    them, and ``parallel.SPMDTrainer`` carries them as its auxiliary state
    (the update lands in whatever tensors the module holds, the ones
    ``torch.func.functional_call`` swapped in included). ``scale=False``
    fixes gamma at ones and ``center=False`` beta at its initial value
    (neither is trained). ``in_channels=0`` takes ``x.shape[axis]`` from
    the first input."""

    _STATS = ("gamma", "beta", "running_mean", "running_var")

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self._declare("gamma", shape, grad_req="write" if scale else "null",
                      init=gamma_initializer)
        self._declare("beta", shape, grad_req="write" if center else "null",
                      init=beta_initializer)
        self._declare("running_mean", shape, grad_req="null",
                      init=running_mean_initializer)
        self._declare("running_var", shape, grad_req="null",
                      init=running_variance_initializer)

    def infer_shape(self, x, *args):
        return dict.fromkeys(self._STATS, (x.shape[self._axis],))

    def forward(self, x):
        training = autograd.is_training() and not self._use_global_stats
        out = F.batch_norm(x, self.gamma, self.beta, self.running_mean,
                           self.running_var, eps=self._eps,
                           fix_gamma=not self._scale, axis=self._axis,
                           use_global_stats=self._use_global_stats,
                           training=training)
        if not training:
            return out
        out, mean, var = out
        m = self._momentum
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.copy_(running * m + batch * (1 - m))
        return out


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
