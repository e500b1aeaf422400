"""Basic layers of the ported path.

Counterpart of the JAX package's ``gluon/nn/basic_layers.py``: ``Dense``,
``Activation``, ``Flatten``, ``BatchNorm``, ``Embedding`` (with
``sparse_grad``), ``LayerNorm``, ``GroupNorm``, ``InstanceNorm``,
``RMSNorm``, ``Dropout``, ``Lambda``, ``HybridLambda``, ``Sequential``
and ``HybridSequential``, with the reference's
parameter names, layouts and defaults (Dense weight ``(units,
in_units)``, BatchNorm ``gamma``/``beta``/``running_mean``/
``running_var``; the children of a sequential block are named ``0``,
``1``, ..., so their parameters read ``features.4.0.body.0.weight`` as in
the JAX package). ``Dense`` without ``in_units`` and the norms without
``in_channels`` take them from their first input (``Block.infer_shape``).
"""

from __future__ import annotations

import math

import torch

from ... import autograd
from ...ndarray.ndarray import NDArray
from ...ndarray.sparse import embedding_grad
from ...ops import nn as F
from ...ops.registry import get as _get_op
from ...ops.tensor import reshape, wrap_index
from ..block import Block, HybridBlock

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "GroupNorm", "HybridLambda", "HybridSequential",
           "InstanceNorm", "Lambda", "LayerNorm", "RMSNorm", "Sequential"]


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


class HybridSequential(Sequential, HybridBlock):
    """Reference ``nn.HybridSequential``: a ``Sequential`` that hybridizes
    (one captured graph for the stack on the card)."""


class Dense(HybridBlock):
    """Fully-connected layer: ``y = act(x·Wᵀ + b)``, weight ``(units,
    in_units)``. ``in_units=0`` takes ``prod(x.shape[1:])`` (``flatten``)
    or ``x.shape[-1]`` from the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
        # the reference's arguments, so the op records its attributes
        if self.bias is None:
            out = F.fully_connected(x, self.weight, num_hidden=self._units,
                                    no_bias=True, flatten=self._flatten)
        else:
            out = F.fully_connected(x, self.weight, self.bias,
                                    num_hidden=self._units,
                                    flatten=self._flatten)
        return out if self._act is None else \
            F.activation(out, act_type=self._act)


class Activation(HybridBlock):
    """``Activation(act_type)`` of ``ops.nn.activation`` (relu, sigmoid,
    tanh, softrelu, softsign, gelu, ...)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act = activation

    def forward(self, x):
        return F.activation(x, act_type=self._act)


class Flatten(HybridBlock):
    """``(N, ...) -> (N, prod(...))``."""

    def forward(self, x):
        return flatten(x)


def flatten(x):
    """``(N, ...) -> (N, prod(...))`` through the registered ``reshape``,
    which an export records, to ``(-1, prod(...))``: the reference's
    ``x.flatten()`` records ``(N, -1)``, which fixes the batch of the
    exported graph (a served bucket of another size fails); this shape
    runs at any batch, in either package."""
    features = math.prod(x.shape[1:])
    if x.dim() == 0 or features == 0 or x.shape[0] == 0:
        return reshape(x, shape=(x.shape[0] if x.dim() else 1, -1))
    return reshape(x, shape=(-1, features))


class BatchNorm(HybridBlock):
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
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
                           momentum=self._momentum,
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


class _SparseGradEmbedding(torch.autograd.Function):
    """The lookup of ``ops.nn.embedding`` whose weight gradient is
    row-sparse (reference ``_SparseGradEmbedding``): one row a distinct id
    of the batch, the repeats summed, in ascending order, as a coalesced
    sparse COO tensor. The padding id -1 counts from the end (row
    ``input_dim - 1``, the row it reads); an id outside ``[-n, n)`` reads
    NaN and adds no row."""

    @staticmethod
    def forward(ctx, indices, weight):
        ctx.save_for_backward(indices)
        ctx.shape = tuple(weight.shape)
        return F.embedding(indices, weight)

    @staticmethod
    def backward(ctx, dy):
        (indices,) = ctx.saved_tensors
        ids, outside = wrap_index(indices, ctx.shape[0])
        return None, embedding_grad(ids, outside, dy, ctx.shape)


class Embedding(HybridBlock):
    """Lookup table ``(input_dim, output_dim)`` of ``dtype``, drawn by
    ``weight_initializer`` (or the global initializer). With
    ``sparse_grad``, a backward under ``autograd.record()`` leaves the
    weight a row-sparse gradient (a coalesced sparse COO ``.grad``,
    ``gluon.Trainer`` and ``optimizer.SGD``'s lazy update read it); inside
    ``autograd.dense_grads()`` (the step engines' bodies) the gradient is
    dense, as under the JAX package's trace."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._sparse_grad = sparse_grad
        self._dims = dict(input_dim=input_dim, output_dim=output_dim)
        self._declare("weight", (input_dim, output_dim),
                      init=weight_initializer, dtype=dtype,
                      grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, x):
        w = self.weight
        if self._sparse_grad and autograd.sparse_grads_enabled() \
                and w.requires_grad and w.grad_fn is None:
            return _SparseGradEmbedding.apply(x, w)
        return F.embedding(x, w, **self._dims)


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis."""

    def __init__(self, epsilon=1e-5, in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not in_channels:
            raise ValueError("LayerNorm needs in_channels")
        self._eps = epsilon
        self._declare("gamma", (in_channels,))
        self._declare("beta", (in_channels,))

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, eps=self._eps)


class _Norm(HybridBlock):
    """A norm with ``gamma`` (and ``beta``) of the channel count on
    ``axis``, taken from the first input when ``in_channels`` is 0."""

    def __init__(self, axis, in_channels, gamma_initializer,
                 beta_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._declare("gamma", (in_channels,), init=gamma_initializer)
        if beta_initializer is not None:
            self._declare("beta", (in_channels,), init=beta_initializer)

    def infer_shape(self, x, *args):
        return dict.fromkeys(self._parameters, (x.shape[self._axis],))


class GroupNorm(_Norm):
    """Each sample's channels (axis 1) in ``num_groups`` groups of
    consecutive channels, each normalized over its channels and spatial
    axes, then scaled and shifted a channel. ``center`` and ``scale`` are
    accepted and both parameters train, as in the reference."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(1, in_channels, gamma_initializer,
                         beta_initializer, prefix=prefix, params=params)
        self._num_groups = num_groups
        self._eps = epsilon

    def forward(self, x):
        return F.group_norm(x, self.gamma, self.beta,
                            num_groups=self._num_groups, eps=self._eps)


class InstanceNorm(_Norm):
    """Each (sample, channel) normalized over its spatial axes (channels
    on axis 1; ``axis``, ``center`` and ``scale`` are accepted, as the
    reference accepts them)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(1, in_channels, gamma_initializer,
                         beta_initializer, prefix=prefix, params=params)
        self._eps = epsilon

    def forward(self, x):
        return F.instance_norm(x, self.gamma, self.beta, eps=self._eps)


class RMSNorm(_Norm):
    """``x / sqrt(mean(x**2 over axis) + eps) * gamma``."""

    def __init__(self, axis=-1, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, in_channels, gamma_initializer,
                         prefix=prefix, params=params)
        self._eps = epsilon

    def forward(self, x):
        return F.rms_norm(x, self.gamma, axis=self._axis, eps=self._eps)


def _op_function(name):
    """``mx.nd.<name>`` for NDArrays, the registered op's function for
    tensors (a block on tensors returns tensors)."""
    from ... import ndarray as nd

    opdef = _get_op(name)
    if opdef is None:
        raise ValueError(f"Lambda: no op named {name!r}")
    on_nd = getattr(nd, name, None) or (
        lambda *a, **k: nd.invoke_op(name, *a, **k))

    def call(*args, **kwargs):
        if any(isinstance(a, NDArray) for a in args):
            return on_nd(*args, **kwargs)
        return opdef.fn(*args, **kwargs)

    return call


class Lambda(Block):
    """A function as a block (reference ``nn.Lambda``): ``function`` is a
    callable or the name of an ``mx.nd`` op. It gets the block's
    arguments as they are (NDArrays or tensors)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._func = _op_function(function) if isinstance(function, str) \
            else function

    def __call__(self, *args, **kwargs):
        return self._func(*args, **kwargs)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(Lambda, HybridBlock):
    """Reference ``nn.HybridLambda``: a ``Lambda`` that is a
    ``HybridBlock`` (its function runs as called; a hybridized parent
    captures it)."""


class Dropout(HybridBlock):
    """Inverted dropout, active iff ``autograd.is_training()`` (on inside
    ``autograd.record()`` and ``train_mode()``, off elsewhere), as in the
    JAX package. The mask is drawn from the device's ``random.generator``."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        return F.dropout(x, p=self._rate, axes=self._axes,
                         training=autograd.is_training())
