"""Weight initializers.

Counterpart of the JAX package's ``initializer.py``, cut to what the
ported models use: ``zeros``, ``ones``, ``uniform`` (the default:
``create(None)`` is ``Uniform(0.07)``, as in MXNet) and ``xavier``, with
the reference's
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
