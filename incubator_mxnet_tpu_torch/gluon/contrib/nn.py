"""gluon.contrib.nn: ``HybridConcurrent`` and ``SyncBatchNorm``.

Counterpart of the JAX package's ``gluon/contrib/nn.py``.
``HybridConcurrent`` (alias ``Concurrent``) feeds one input to each child
and concatenates their outputs, the glue of Inception's blocks; its
children are named ``0``, ``1``, ... as a ``Sequential``'s, so parameter
names read ``features.7.1.0.0.weight`` as in the JAX package.
``SyncBatchNorm`` is ``BatchNorm`` over axis 1 that records
``num_devices``. The mixture-of-experts FFN (``MoEFFN``) comes with the
expert-parallel path.
"""

from __future__ import annotations

from ...ops.tensor import concat
from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "SyncBatchNorm"]


class HybridConcurrent(Sequential, HybridBlock):
    """Parallel branches: the same input to every child, their outputs
    concatenated on ``axis`` (reference ``gluon.contrib.nn.
    HybridConcurrent``). Children are added and indexed as a
    ``Sequential``'s."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return concat(*[child(x) for child in self], dim=self.axis)


Concurrent = HybridConcurrent


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference ``gluon.contrib.nn.
    SyncBatchNorm``): ``BatchNorm`` over axis 1 that records
    ``num_devices``. On one card the batch's statistics are the
    statistics of all of it, which is the reference's semantics. Across
    cards each card normalizes with its own slice's moments: the
    all-reduce of the moments comes with the multi-card data-parallel
    path (``ROADMAP.md``, queue 1, item 10)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones",
                 prefix=None, params=None):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, prefix=prefix, params=params)
        self._num_devices = num_devices
