"""Weight initializers.

Counterpart of the JAX package's ``initializer.py``: ``zeros``, ``ones``,
``constant``, ``uniform`` (the default: ``create(None)`` is
``Uniform(0.07)``, as in MXNet), ``normal``, ``orthogonal``, ``xavier``,
``msraprelu``, ``lecunn`` and ``bilinear``, with the reference's
name-pattern dispatch (names ending in ``bias``/``beta`` or in
``running_mean``/``moving_mean`` take zeros; ``gamma`` and
``running_var``/``moving_var`` take ones). Values are drawn with numpy
from ``random.next_seed()``.
"""

from __future__ import annotations

import math

import numpy as np

from . import random as _random

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        return cls
    return deco


def create(spec) -> "Initializer":
    if isinstance(spec, Initializer):
        return spec
    if spec is None:
        return Uniform(0.07)
    if isinstance(spec, str):
        name = spec.lower()
        if name not in _REGISTRY:
            raise ValueError(f"unknown initializer {spec!r}; known "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[name]()
    raise TypeError(f"cannot create initializer from {spec!r}")


class Initializer:
    """Base class: ``init(name, shape)`` returns a float32 numpy array."""

    def __call__(self, name: str, shape) -> np.ndarray:
        shape = tuple(int(s) for s in shape)
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            return np.zeros(shape, np.float32)
        if name.endswith(("gamma", "running_var", "moving_var")):
            return np.ones(shape, np.float32)
        return self._init_weight(name, shape)

    def _init_weight(self, name, shape):
        raise NotImplementedError


@register("zeros")
class Zero(Initializer):
    def _init_weight(self, name, shape):
        return np.zeros(shape, np.float32)


@register("ones")
class One(Initializer):
    def _init_weight(self, name, shape):
        return np.ones(shape, np.float32)


@register("uniform")
class Uniform(Initializer):
    """Weights uniform on ``[-scale, scale]``."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, shape):
        rng = np.random.default_rng(_random.next_seed())
        return rng.uniform(-self.scale, self.scale, shape).astype(np.float32)


def _fan(shape, factor_type):
    hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    if factor_type == "in":
        return float(fan_in)
    return float(fan_out)


@register("xavier")
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, name, shape):
        scale = math.sqrt(self.magnitude / _fan(shape, self.factor_type))
        rng = np.random.default_rng(_random.next_seed())
        if self.rnd_type == "uniform":
            return rng.uniform(-scale, scale, shape).astype(np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)


@register("constant")
class Constant(Initializer):
    """Weights all ``value``."""

    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, name, shape):
        return np.full(shape, self.value, np.float32)


@register("normal")
class Normal(Initializer):
    """Weights from N(0, ``sigma``^2)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, shape):
        rng = np.random.default_rng(_random.next_seed())
        return (rng.standard_normal(shape) * self.sigma).astype(np.float32)


@register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times an orthonormal (out, prod(in)) matrix: the rows or
    the columns, whichever are fewer, are orthonormal (the SVD of a
    uniform or normal draw)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, shape):
        nout, nin = shape[0], int(np.prod(shape[1:]))
        rng = np.random.default_rng(_random.next_seed())
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rng.standard_normal((nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        return (self.scale * q.reshape(shape)).astype(np.float32)


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU of ``slope``: normal, magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register("lecunn")
class LeCunN(Xavier):
    """LeCun normal: N(0, 1 / fan_in)."""

    def __init__(self):
        super().__init__("gaussian", "in", 1)


@register("bilinear")
class Bilinear(Initializer):
    """Bilinear upsampling weights for a deconvolution (N, C, H, W)."""

    def _init_weight(self, name, shape):
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = np.arange(shape[3])
        y = np.arange(shape[2])[:, None]
        tile = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        return np.broadcast_to(tile, shape).astype(np.float32)
