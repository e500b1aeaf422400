"""Inception v3 (Szegedy et al. 1512.00567).

Counterpart of the JAX package's ``gluon/model_zoo/vision/inception.py``:
``_make_basic_conv`` (a bias-free conv, ``BatchNorm(epsilon=0.001)``,
ReLU), ``_make_branch`` (an optional pool, then basic convs), the blocks
``_make_A`` through ``_make_E`` (``gluon.contrib.nn.HybridConcurrent``
over the branches, concatenated on the channels) and ``Inception3``. The
input is 299x299: the closing ``AvgPool2D(pool_size=8)`` needs the 8x8
map that size leaves. Children are built in the reference's order, so
parameter names read as the JAX package's (``features.7.0.0.0.weight``:
the first A block's first branch's conv).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent as Concurrent
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   HybridSequential, MaxPool2D)
from ._zoo import build

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(channels, **kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, use_bias=False, **kwargs),
            BatchNorm(epsilon=0.001), Activation("relu"))
    return out


_SETTING_NAMES = ("channels", "kernel_size", "strides", "padding")


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        out.add(_make_basic_conv(**{name: value for name, value in
                                    zip(_SETTING_NAMES, setting)
                                    if value is not None}))
    return out


def _branch(*args):
    """A branch to make later, inside its Concurrent's name scope."""
    return lambda: _make_branch(*args)


def _concurrent(prefix, *branches):
    """The branches (each made by a call) side by side, made inside the
    Concurrent's name scope, so their names take its ``prefix`` as the
    reference's."""
    out = Concurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(*[make() for make in branches])
    return out


def _make_A(pool_features, prefix):
    return _concurrent(
        prefix, _branch(None, (64, 1, None, None)),
        _branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _branch(None, (64, 1, None, None), (96, 3, None, 1),
                (96, 3, None, 1)),
        _branch("avg", (pool_features, 1, None, None)))


def _make_B(prefix):
    return _concurrent(
        prefix, _branch(None, (384, 3, 2, None)),
        _branch(None, (64, 1, None, None), (96, 3, None, 1),
                (96, 3, 2, None)),
        _branch("max"))


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    return _concurrent(
        prefix, _branch(None, (192, 1, None, None)),
        _branch(None, (c, 1, None, None), (c, (1, 7), None, (0, 3)),
                (192, (7, 1), None, (3, 0))),
        _branch(None, (c, 1, None, None), (c, (7, 1), None, (3, 0)),
                (c, (1, 7), None, (0, 3)), (c, (7, 1), None, (3, 0)),
                (192, (1, 7), None, (0, 3))),
        _branch("avg", (192, 1, None, None)))


def _make_D(prefix):
    return _concurrent(
        prefix, _branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _branch("max"))


def _split_3x3(*first):
    """A branch of E: ``first`` convs, then a 1x3 and a 3x1 conv of 384
    side by side."""
    def make():
        out = HybridSequential(prefix="")
        out.add(_make_branch(None, *first))
        split = Concurrent(axis=1, prefix="")
        split.add(_make_branch(None, (384, (1, 3), None, (0, 1))),
                  _make_branch(None, (384, (3, 1), None, (1, 0))))
        out.add(split)
        return out
    return make


def _make_E(prefix):
    return _concurrent(
        prefix, _branch(None, (320, 1, None, None)),
        _split_3x3((384, 1, None, None)),
        _split_3x3((448, 1, None, None), (384, 3, None, 1)),
        _branch("avg", (192, 1, None, None)))


class Inception3(HybridBlock):
    """Inception v3; input (N, 3, 299, 299)."""

    def __init__(self, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(
                _make_basic_conv(32, kernel_size=3, strides=2),
                _make_basic_conv(32, kernel_size=3),
                _make_basic_conv(64, kernel_size=3, padding=1),
                MaxPool2D(pool_size=3, strides=2),
                _make_basic_conv(80, kernel_size=1),
                _make_basic_conv(192, kernel_size=3),
                MaxPool2D(pool_size=3, strides=2),
                _make_A(32, "A1_"), _make_A(64, "A2_"), _make_A(64, "A3_"),
                _make_B("B_"), _make_C(128, "C1_"), _make_C(160, "C2_"),
                _make_C(160, "C3_"), _make_C(192, "C4_"), _make_D("D_"),
                _make_E("E1_"), _make_E("E2_"),
                AvgPool2D(pool_size=8), Dropout(0.5))
            self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    """Inception v3 (reference ``vision.inception_v3``)."""
    return build(Inception3, **kwargs)
