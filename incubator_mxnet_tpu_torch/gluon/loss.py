"""Gluon losses of the ported training path.

Counterpart of the JAX package's ``gluon/loss.py``: ``Loss``, ``L2Loss``,
``L1Loss``, ``SoftmaxCrossEntropyLoss``, ``SigmoidBinaryCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss``, ``CosineEmbeddingLoss``,
``PoissonNLLLoss``, ``CTCLoss`` and ``SDMLLoss``. Each returns one value a
sample with the reference's ``weight``/``sample_weight`` semantics; most
take the mean over the axes other than ``batch_axis``, and the few that do
not (the triplet, cosine, Poisson, CTC and SDML losses) reduce as the
JAX package's do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.more import ctc_loss
from ..ops.tensor import wrap_index
from .block import HybridBlock

__all__ = ["CTCLoss", "CosineEmbeddingLoss", "HingeLoss", "HuberLoss",
           "KLDivLoss", "L1Loss", "L2Loss", "LogisticLoss", "Loss",
           "PoissonNLLLoss", "SDMLLoss", "SigmoidBCELoss",
           "SigmoidBinaryCrossEntropyLoss", "SoftmaxCELoss",
           "SoftmaxCrossEntropyLoss", "SquaredHingeLoss", "TripletLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss: one scalar per sample along ``batch_axis`` (mean over
    the other axes)."""

    def __init__(self, weight=1.0, batch_axis=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
                 weight=1.0, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
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


def _logistic(p, label):
    """``log(1 + exp(p)) - p * label`` in its stable form."""
    return torch.relu(p) - p * label + F.softplus(-p.abs())


class _PointwiseLoss(Loss):
    """A loss of ``(pred, label)`` element by element, ``label`` reshaped
    to ``pred``'s shape, then weighted and averaged a sample."""

    def _pointwise(self, pred, label):
        raise NotImplementedError

    def forward(self, pred, label, sample_weight=None):
        loss = self._pointwise(pred, label.reshape(pred.shape))
        return self._mean_per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (``pred`` itself where
    ``from_sigmoid``) against labels in [0, 1], in the stable form
    ``relu(x) - x * y + log(1 + exp(-|x|))``. ``pos_weight`` scales the
    positive term, as MXNet's (the JAX package takes the argument and
    leaves it out)."""

    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if self._from_sigmoid:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        elif pos_weight is None:
            loss = _logistic(pred, label)
        else:
            log_weight = 1 + (pos_weight - 1) * label
            loss = pred - pred * label + log_weight * (
                F.softplus(-pred.abs()) + torch.relu(-pred))
        return self._mean_per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - log_pred)``; ``pred`` is a log-probability
    when ``from_logits``, else logits (log-softmaxed over ``axis``)."""

    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._mean_per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class HuberLoss(_PointwiseLoss):
    """Quadratic ``0.5 / rho * d**2`` inside ``|d| <= rho``, linear
    ``|d| - 0.5 * rho`` outside, ``d = pred - label``."""

    def __init__(self, rho=1.0, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._rho = rho

    def _pointwise(self, pred, label):
        d = (pred - label).abs()
        return torch.where(d > self._rho, d - 0.5 * self._rho,
                           0.5 / self._rho * d * d)


class HingeLoss(_PointwiseLoss):
    """``relu(margin - pred * label)``, labels -1 or 1."""

    def __init__(self, margin=1.0, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def _pointwise(self, pred, label):
        return torch.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    """``relu(margin - pred * label) ** 2``."""

    def _pointwise(self, pred, label):
        return torch.square(super()._pointwise(pred, label))


class LogisticLoss(_PointwiseLoss):
    """``log(1 + exp(-pred * label))`` for ``label_format="signed"``
    labels (-1 or 1), the binary cross entropy of logits for ``"binary"``
    labels (0 or 1)."""

    def __init__(self, label_format="signed", weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"label_format {label_format!r}: 'signed' or "
                             "'binary'")
        self._fmt = label_format

    def _pointwise(self, pred, label):
        if self._fmt == "signed":
            label = (label + 1.0) / 2.0
        return _logistic(pred, label)


class TripletLoss(Loss):
    """``relu(sum((a - p)**2 - (a - n)**2) + margin)`` a sample, the sum
    over every axis but the first."""

    def __init__(self, margin=1.0, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        axes = tuple(range(1, pred.dim()))
        loss = torch.relu((torch.square(pred - positive)
                           - torch.square(pred - negative)).sum(dim=axes)
                          + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(x1, x2)`` for a positive label, ``relu(cos - margin)``
    otherwise, each sample flattened."""

    def __init__(self, weight=1.0, batch_axis=0, margin=0.0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        x1 = input1.reshape(input1.shape[0], -1)
        x2 = input2.reshape(input2.shape[0], -1)
        cos = (x1 * x2).sum(dim=-1) / (
            torch.linalg.vector_norm(x1, dim=-1)
            * torch.linalg.vector_norm(x2, dim=-1) + 1e-12)
        loss = torch.where(label.reshape(cos.shape) > 0, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood of ``target``: ``exp(pred) - target
    * pred`` for log-rates (``from_logits``), ``pred - target * log(pred
    + epsilon)`` for rates; ``compute_full`` adds Stirling's term. The
    mean over every axis but the first."""

    def __init__(self, from_logits=True, compute_full=False, weight=1.0,
                 batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._from_logits = from_logits
        self._full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._full:
            loss = loss + (target * torch.log(target + 1e-12) - target
                           + 0.5 * torch.log(2 * math.pi
                                             * (target + 1e-12)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean(dim=tuple(range(1, loss.dim())))


class CTCLoss(Loss):
    """Connectionist temporal classification loss a sample, over the
    registered ``CTCLoss`` op (optax's lattice, blank 0). ``layout`` is
    the activations' ("NTC" or "TNC"), ``label_layout`` the labels' ("NT"
    or "TN"; the JAX package reads "NT" whatever it is given); labels are
    padded with -1 unless ``label_lengths`` cut them, and
    ``pred_lengths`` cut the sequences."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=None, params=None):
        super().__init__(weight or 1.0, 0, prefix=prefix, params=params)
        if layout not in ("NTC", "TNC") or label_layout not in ("NT", "TN"):
            raise ValueError(f"CTCLoss layouts {layout!r}, {label_layout!r}:"
                             " 'NTC'/'TNC' and 'NT'/'TN'")
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None):
        data = pred.transpose(0, 1) if self._layout == "NTC" else pred
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = ctc_loss(data, label, pred_lengths, label_lengths,
                        use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None)
        return loss * self._weight if self._weight != 1.0 else loss


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: a smoothed cross entropy over
    the negated squared l2 distances between the rows of ``x1`` and of
    ``x2`` (2-D), the pairs on the diagonal the positives
    (``1 - smoothing_parameter``, the rest sharing the remainder)."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._smooth = smoothing_parameter

    def forward(self, x1, x2):
        n = x1.shape[0]
        d = torch.square(x1.unsqueeze(1) - x2.unsqueeze(0)).sum(dim=2)
        eye = torch.eye(n, dtype=d.dtype, device=d.device)
        target = eye * (1.0 - self._smooth) + (1.0 - eye) * (
            self._smooth / max(n - 1, 1))
        logprob = F.log_softmax(-d, dim=1)
        return -(target * logprob).sum(dim=1) * self._weight
