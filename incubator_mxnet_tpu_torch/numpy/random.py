"""``mx.np.random``: numpy-style samplers (the reference's
``python/mxnet/numpy/random.py``). Each draws on ``ctx`` (the default
context, the card, when None) from the package's generator of that device,
as ``mx.nd.random`` does."""

from __future__ import annotations

from .. import ndarray as _nd


def _size(size):
    return size if size is not None else ()


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    return _nd.random.uniform(low, high, shape=_size(size),
                              dtype=dtype or "float32", ctx=ctx)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return _nd.random.normal(loc, scale, shape=_size(size),
                             dtype=dtype or "float32", ctx=ctx)


def randint(low, high=None, size=None, dtype=None, ctx=None):
    if high is None:
        low, high = 0, low
    return _nd.random.randint(low, high, shape=_size(size),
                              dtype=dtype or "int32", ctx=ctx)


def rand(*size, ctx=None):
    return uniform(0.0, 1.0, size=size or (), ctx=ctx)


def randn(*size, ctx=None):
    return normal(0.0, 1.0, size=size or (), ctx=ctx)


def exponential(scale=1.0, size=None, ctx=None):
    return _nd.random.exponential(1.0 / scale, shape=_size(size), ctx=ctx)


def gamma(shape, scale=1.0, size=None, ctx=None):
    return _nd.random.gamma(shape, scale, shape=_size(size), ctx=ctx)


def poisson(lam=1.0, size=None, ctx=None):
    return _nd.random.poisson(lam, shape=_size(size), ctx=ctx)


def shuffle(x):
    """Permute ``x``'s rows (axis 0) in place, in its own tensor."""
    x._write(_nd.shuffle(x))


def seed(s):
    from .. import random as _random

    _random.seed(s)
