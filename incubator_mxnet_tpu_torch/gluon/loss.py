"""Gluon losses of the ported training path.

Counterpart of the JAX package's ``gluon/loss.py`` (``Loss``, ``L2Loss``,
``L1Loss``, ``SoftmaxCrossEntropyLoss``): each returns one value per sample
along ``batch_axis``, the mean over the other axes, with the same
``weight``/``sample_weight`` semantics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.tensor import wrap_index
from .block import Block

__all__ = ["L1Loss", "L2Loss", "Loss", "SoftmaxCELoss",
           "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


class Loss(Block):
    """Base loss: one scalar per sample along ``batch_axis`` (mean over
    the other axes)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_per_sample(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``(pred - label)**2 / 2`` per element."""

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(pred - label.reshape(pred.shape)) / 2
        return self._mean_per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class L1Loss(Loss):
    """``|pred - label|`` per element."""

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(pred - label.reshape(pred.shape))
        return self._mean_per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy. Labels are class indices, integer or
    float-coded (``sparse_label=True``), or distributions. The log-softmax
    runs in fp32 whatever the logits' type, and the per-sample loss is cast
    back to the logits' type (a bf16 net gets a bf16 loss)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis
        logp = pred.float() if self._from_logits \
            else F.log_softmax(pred.float(), dim=axis)
        if self._sparse:
            # a label in [-n, -1] counts from the end, one outside [-n, n)
            # gives a NaN loss, as jnp.take_along_axis reads it
            idx, outside = wrap_index(label.unsqueeze(axis),
                                      logp.shape[axis])
            loss = -torch.gather(logp, axis, idx).masked_fill(
                outside, float("nan")).squeeze(axis)
        else:
            loss = -(logp * label.float()).sum(dim=axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss).to(pred.dtype)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
