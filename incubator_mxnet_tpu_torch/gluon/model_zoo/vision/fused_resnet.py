"""ResNet v1 with fused conv + BatchNorm bottlenecks.

Counterpart of the JAX package's ``gluon/model_zoo/vision/fused_resnet.py``
(He et al. 1512.03385, the reference's ``resnet.py`` architecture): every
conv of a bottleneck runs through ``ops.fused_conv.fused_conv_bn``, which
applies the previous BatchNorm + ReLU as a prologue of the conv and emits
the conv's own batch statistics from its epilogue, so no normalized
activation inside a bottleneck is written to device memory. On a CUDA
tensor these are the hand-written kernels (K1 forward, K2/K3 backward,
``csrc/fused_conv.cu`` and ``csrc/conv_bwd.cu``); on the CPU their plain
versions.

Layouts as in the JAX package: weights HWIO, activations NHWC (torch
tensors (N, H, W, C), contiguous), the input NCHW. Parameter names are the
JAX package's structural names (``conv0_weight``,
``stages.0.0.bn1_running_mean``, ``output.weight``), so
``load_jax_params`` carries weights across by name with no transpose.

The residual-epilogue chain is always on (the JAX default,
``MXTPU_CONV_EPILOGUE``): each bottleneck hands its successor a *pending
join* ``(y3, a3, b3, r, ar, br)``, the raw conv3 output with its folded
BatchNorm and the shortcut with its affine (identity: ar=1, br=0;
downsample: the projection's folded BatchNorm), and the successor's conv1
performs ``relu(a3*y3 + b3 + ar*r + br)`` in its prologue, emitting the
joined activation once for its own shortcut. The network head joins the
last pending junction in plain PyTorch. A forward of
``fused_resnet50_v1`` makes 52 fused convs (16 bottlenecks x 3, plus 4
downsample projections), and its backward 52 of each backward kernel.

The 7x7 stem (conv, BatchNorm, ReLU, 3x3/2 max pool) is plain PyTorch, as
the JAX package leaves it to XLA outside Pallas.

BatchNorm in training takes the batch statistics from the fused convs'
sums (``bn_scale_shift``: mean and the *biased* variance) and updates the
running statistics ``rm <- rm*m + mean*(1-m)`` in place under
``no_grad``, so the update lands in whatever tensors the module holds,
including the ones ``torch.func.functional_call`` swapped in
(``parallel.SPMDTrainer``). ``F.batch_norm`` is not used: its running
variance is the unbiased one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .... import autograd
from ....ops.fused_conv import bn_scale_shift, fused_conv_bn
from ....ops.nn import pooling
from ....ops.registry import recorded
from ...block import HybridBlock
from ...nn import Dense, HybridSequential

__all__ = ["FusedBottleneckV1", "FusedResNetV1", "fused_resnet101_v1",
           "fused_resnet152_v1", "fused_resnet50_v1", "materialize"]


class _PendingJoin(NamedTuple):
    """A bottleneck junction deferred into the next conv's prologue:
    ``consumer_input = relu(a*y + b + ar*r + br)``."""

    y: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    r: torch.Tensor
    ar: torch.Tensor
    br: torch.Tensor


def _coeffs(y, s, ss, g, be, rm, rv, training, eps):
    """The folded BatchNorm ``(a, b)`` of a conv output and the statistics
    its running averages take: the batch's in training, else the running
    ones."""
    if training:
        cnt = y.shape[0] * y.shape[1] * y.shape[2]
        return bn_scale_shift(s, ss, cnt, g, be, eps)
    inv = torch.rsqrt(rv.float() + eps)
    a = g.float() * inv
    b = be.float() - rm.float() * a
    return a, b, rm, rv


def _bneck_core(x_in, join, w1, bn1, w2, bn2, w3, bn3, ds, stride, training,
                eps):
    """The bottleneck body. Exactly one of ``x_in`` (a materialized
    activation) and ``join`` (a pending junction) is given; conv1 either
    consumes the activation or performs the junction in its prologue,
    emitting the joined activation for the shortcut. Returns the pending
    junction of this bottleneck and the batch statistics
    ``(m1, v1, m2, v2, m3, v3[, md, vd])``."""
    if join is not None:
        y_in, a_in, b_in, r_in, ar_in, br_in = join
        y1, s1, ss1, act = fused_conv_bn(
            y_in, w1, a_in, b_in, stride=1, pad=0, relu=True, resid=r_in,
            resid_scale=ar_in, resid_shift=br_in, emit_act=True)
    else:
        act = x_in
        y1, s1, ss1 = fused_conv_bn(act, w1, stride=1, pad=0, relu=False)
    a1, b1, m1, v1 = _coeffs(y1, s1, ss1, *bn1, training, eps)
    y2, s2, ss2 = fused_conv_bn(y1, w2, a1, b1, stride=stride, pad=1,
                                relu=True)
    a2, b2, m2, v2 = _coeffs(y2, s2, ss2, *bn2, training, eps)
    y3, s3, ss3 = fused_conv_bn(y2, w3, a2, b2, stride=1, pad=0, relu=True)
    a3, b3, m3, v3 = _coeffs(y3, s3, ss3, *bn3, training, eps)
    stats = (m1, v1, m2, v2, m3, v3)
    if ds is not None:
        wd, bnd = ds
        yd, sd, ssd = fused_conv_bn(act, wd, stride=stride, pad=0,
                                    relu=False)
        ad, bd, md, vd = _coeffs(yd, sd, ssd, *bnd, training, eps)
        r_out, ar_out, br_out = yd, ad, bd
        stats += (md, vd)
    else:
        co = y3.shape[-1]
        r_out = act
        ar_out = torch.ones(co, dtype=torch.float32, device=y3.device)
        br_out = torch.zeros(co, dtype=torch.float32, device=y3.device)
    return (y3, a3, b3, r_out, ar_out, br_out), stats


def _join_parts(y, a, b, r, ar, br):
    """Materialize a pending junction: ``relu(a*y + b + ar*r + br)`` in
    fp32, in y's type."""
    out = y.float() * a + b + r.float() * ar + br
    return torch.relu(out).to(y.dtype)


@recorded("fused_stem")
def _fused_stem(x, w, g, be, rm, rv, training=True, eps=1e-5):
    """NCHW input -> NHWC: 7x7/2 conv + BatchNorm + ReLU + 3x3/2 max pool,
    plain PyTorch. Returns ``(out, mean, var)``."""
    x = x.to(w.dtype)
    # bf16 convolves natively (its output rounded to bf16), fp32 in fp32
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=2, padding=3)
    y = y.permute(0, 2, 3, 1).float()
    if training:
        mu = y.mean(dim=(0, 1, 2))
        var = torch.clamp((y * y).mean(dim=(0, 1, 2)) - mu * mu, min=0.0)
    else:
        mu, var = rm.float(), rv.float()
    out = torch.relu((y - mu) * torch.rsqrt(var + eps) * g.float()
                     + be.float()).to(x.dtype)
    out = pooling(out, (3, 3), stride=(2, 2), pad=(1, 1), layout="NHWC")
    return out.contiguous(), mu, var


def _global_pool(x):
    return x.float().mean(dim=(1, 2)).to(x.dtype)


class _BNParams:
    """One BatchNorm site of a block: declares ``{name}_gamma``,
    ``_beta`` and the running statistics (``grad_req="null"``) on it."""

    def __init__(self, block, name, c):
        self.name = name
        block._declare(f"{name}_gamma", (c,))
        block._declare(f"{name}_beta", (c,))
        block._declare(f"{name}_running_mean", (c,), grad_req="null")
        block._declare(f"{name}_running_var", (c,), grad_req="null")

    def resolved(self, block):
        """(gamma, beta, running_mean, running_var) as the block holds
        them now (``functional_call`` may have swapped them)."""
        return [getattr(block, f"{self.name}_{k}") for k in
                ("gamma", "beta", "running_mean", "running_var")]

    @torch.no_grad()
    def update_running(self, block, mean, var, momentum):
        """``rm <- rm*m + mean*(1-m)`` (and the variance), in place."""
        for k, v in (("running_mean", mean), ("running_var", var)):
            t = getattr(block, f"{self.name}_{k}")
            t.copy_(t * momentum + v.detach() * (1 - momentum))


class FusedBottleneckV1(HybridBlock):
    """Bottleneck v1 (stride on the 3x3, as the zoo ``BottleneckV1``) over
    the fused conv + BatchNorm kernels; weights HWIO, activations NHWC.

    Takes a plain activation or a :class:`_PendingJoin` and returns a
    :class:`_PendingJoin`; :func:`materialize` joins it when the block is
    used on its own."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 epsilon=1e-5, momentum=0.9, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        c4 = channels // 4
        self._stride = stride
        self._eps = epsilon
        self._momentum = momentum
        self._declare("conv1_weight", (1, 1, in_channels, c4),
                      init="xavier")
        self.bn1 = _BNParams(self, "bn1", c4)
        self._declare("conv2_weight", (3, 3, c4, c4),
                      init="xavier")
        self.bn2 = _BNParams(self, "bn2", c4)
        self._declare("conv3_weight", (1, 1, c4, channels),
                      init="xavier")
        self.bn3 = _BNParams(self, "bn3", channels)
        self.bnd = None
        if downsample:
            self._declare("convd_weight", (1, 1, in_channels, channels),
                          init="xavier")
            self.bnd = _BNParams(self, "bnd", channels)

    def forward(self, x):
        training = autograd.is_training()
        pending = isinstance(x, _PendingJoin)
        ds = None if self.bnd is None else (self.convd_weight,
                                            self.bnd.resolved(self))
        pend, stats = _bneck_core(
            None if pending else x, x if pending else None,
            self.conv1_weight, self.bn1.resolved(self), self.conv2_weight,
            self.bn2.resolved(self), self.conv3_weight,
            self.bn3.resolved(self), ds, self._stride, training, self._eps)
        if training:
            bns = [self.bn1, self.bn2, self.bn3] + (
                [self.bnd] if self.bnd is not None else [])
            for bn, mean, var in zip(bns, stats[0::2], stats[1::2]):
                bn.update_running(self, mean, var, self._momentum)
        return _PendingJoin(*pend)


def materialize(x):
    """Join a :class:`_PendingJoin` into its activation (a plain tensor
    passes through): the chain's head."""
    if isinstance(x, _PendingJoin):
        return _join_parts(*x)
    return x


class FusedResNetV1(HybridBlock):
    """ResNet v1 assembled from fused bottlenecks (50/101/152 depths).
    Input (N, 3, H, W) NCHW; output (N, classes) logits."""

    def __init__(self, layers, channels, classes=1000, epsilon=1e-5,
                 momentum=0.9, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = epsilon
        self._momentum = momentum
        self._declare("conv0_weight", (7, 7, 3, channels[0]),
                      init="xavier")
        self.bn0 = _BNParams(self, "bn0", channels[0])
        with self.name_scope():
            self.stages = HybridSequential(prefix="")
            with self.stages.name_scope():
                for i, num_layer in enumerate(layers):
                    stride = 1 if i == 0 else 2
                    stage = HybridSequential(prefix=f"stage{i + 1}_")
                    with stage.name_scope():
                        stage.add(FusedBottleneckV1(
                            channels[i + 1], stride,
                            downsample=channels[i + 1] != channels[i],
                            in_channels=channels[i], epsilon=epsilon,
                            momentum=momentum, prefix="unit1_"))
                        for j in range(num_layer - 1):
                            stage.add(FusedBottleneckV1(
                                channels[i + 1], 1, downsample=False,
                                in_channels=channels[i + 1],
                                epsilon=epsilon, momentum=momentum,
                                prefix=f"unit{j + 2}_"))
                    self.stages.add(stage)
            self.output = Dense(classes, in_units=channels[-1])

    def forward(self, x):
        training = autograd.is_training()
        stem, mu, var = _fused_stem(x, self.conv0_weight,
                                    *self.bn0.resolved(self),
                                    training=training, eps=self._eps)
        if training:
            self.bn0.update_running(self, mu, var, self._momentum)
        feat = materialize(self.stages(stem))
        return self.output(_global_pool(feat))


def fused_resnet50_v1(classes=1000, **kwargs):
    """ResNet-50 v1 with fused conv + BatchNorm bottlenecks."""
    return FusedResNetV1([3, 4, 6, 3], [64, 256, 512, 1024, 2048],
                         classes=classes, **kwargs)


def fused_resnet101_v1(classes=1000, **kwargs):
    return FusedResNetV1([3, 4, 23, 3], [64, 256, 512, 1024, 2048],
                         classes=classes, **kwargs)


def fused_resnet152_v1(classes=1000, **kwargs):
    return FusedResNetV1([3, 8, 36, 3], [64, 256, 512, 1024, 2048],
                         classes=classes, **kwargs)
