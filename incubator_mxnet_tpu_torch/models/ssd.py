"""SSD-300, the single-shot detector (BASELINE.json config 5).

Counterpart of the JAX package's ``models/ssd.py`` (GluonCV's SSD, the
reference's example/ssd): the VGG16-atrous backbone, six feature maps,
a class and a box convolution head on each, anchors from
``multibox_prior``, training targets from ``multibox_target`` and the
inference decode of ``multibox_detection`` (``ops/detection.py``).
Parameter names are the JAX package's structural names
(``features.stage1.0.weight``, ``features.norm4.scale``,
``extra0.2.weight``, ``cls_head3.bias``), so
``gluon.model_zoo.load_jax_params`` carries weights across. The forward
calls registered ops only (``Convolution`` through ``Conv2D``,
``Pooling``, ``L2Normalization``, ``transpose``, ``reshape``,
``concat``, ``MultiBoxPrior``), so the net runs on NDArrays and on
tensors, hybridizes, and exports as the zoo does; under ``amp.init`` the
convolutions take the target type and the normalization fp32, as in the
JAX package.

A train step (``SSDMultiBoxLoss`` over ``multibox_target``'s targets)
reads nothing on the host, so ``parallel.SPMDTrainer`` captures it in a
CUDA graph, as the JAX step is one XLA program. The convolutions are
``Conv2D`` (cuDNN): none of the repository's TPU kernels is on this path.
"""

from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon.loss import Loss
from ..gluon.nn import Activation, Conv2D, HybridSequential
from ..ops.detection import multibox_prior, smooth_l1
from ..ops.nn import l2_normalization, pooling
from ..ops.registry import recorded
from ..ops.tensor import _mul_scalar, concat, mul, reshape, transpose

__all__ = ["Normalize", "SSD", "SSDMultiBoxLoss", "VGGAtrousBase", "get_ssd",
           "ssd_300_vgg16_atrous_voc"]

# anchor sizes and ratios of each feature map (SSD-300 on VOC, the
# reference example/ssd defaults)
_SSD300_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                 (0.54, 0.619), (0.71, 0.79), (0.88, 0.961)]
_SSD300_RATIOS = [(1.0, 2.0, 0.5)] + \
                 [(1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)] * 3 + \
                 [(1.0, 2.0, 0.5)] * 2


class Normalize(HybridBlock):
    """Channel-wise L2 normalization with a learned scale (the conv4_3
    rescale of the SSD paper): ``l2_normalization(x, "channel") * scale *
    initial``."""

    def __init__(self, n_channel, initial=20.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._declare("scale", (1, n_channel, 1, 1), init="ones")
        self._initial = initial

    def forward(self, x):
        out = l2_normalization(x, mode="channel")
        return mul(out, _mul_scalar(self.scale, scalar=self._initial))


def _conv_block(out, k, s, p, dilate=1):
    blk = HybridSequential()
    blk.add(Conv2D(out, k, strides=s, padding=p, dilation=dilate))
    blk.add(Activation("relu"))
    return blk


class VGGAtrousBase(HybridBlock):
    """VGG16 through conv5_3 with SSD's changes: pool5 3x3 stride 1, fc6
    an atrous 3x3 conv of 1024 (dilation 6), fc7 a 1x1 conv of 1024.
    Returns (conv4_3 normalized, fc7)."""

    layers = [2, 2, 3, 3, 3]
    filters = [64, 128, 256, 512, 512]

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.stages = []
            for i, (n, f) in enumerate(zip(self.layers, self.filters)):
                stage = HybridSequential(prefix=f"stage{i + 1}_")
                for _ in range(n):
                    stage.add(Conv2D(f, 3, padding=1))
                    stage.add(Activation("relu"))
                self.stages.append(stage)
                setattr(self, f"stage{i + 1}", stage)
            self.norm4 = Normalize(512, 20.0)
            self.fc6 = _conv_block(1024, 3, 1, 6, dilate=6)
            self.fc7 = _conv_block(1024, 1, 1, 0)

    def forward(self, x):
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i == 3:
                conv4_3 = self.norm4(x)
            if i < 3:
                x = pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                            pooling_convention="full")
            elif i == 3:
                x = pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        # pool5: 3x3 stride 1 keeps the resolution for the atrous fc6
        x = pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="max")
        return conv4_3, self.fc7(self.fc6(x))


class SSD(HybridBlock):
    """The SSD detector. ``forward(x)`` returns (cls_pred (B, N, C+1),
    loc_pred (B, 4N), anchors (1, N, 4)): feed ``multibox_target`` and
    :class:`SSDMultiBoxLoss` to train, ``multibox_detection`` to
    detect."""

    def __init__(self, num_classes=20, image_size=300, sizes=None,
                 ratios=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.num_classes = num_classes
        self._sizes = sizes or _SSD300_SIZES
        self._ratios = ratios or _SSD300_RATIOS
        if len(self._sizes) != len(self._ratios):
            raise ValueError("one (sizes, ratios) pair a feature map")
        with self.name_scope():
            self.features = VGGAtrousBase()
            # the extra feature layers conv8-conv11
            self.extras = []
            for i, (f1, f2, s, p) in enumerate(
                    [(256, 512, 2, 1), (128, 256, 2, 1),
                     (128, 256, 1, 0), (128, 256, 1, 0)]):
                blk = HybridSequential(prefix=f"extra{i}_")
                blk.add(Conv2D(f1, 1))
                blk.add(Activation("relu"))
                blk.add(Conv2D(f2, 3, strides=s, padding=p))
                blk.add(Activation("relu"))
                self.extras.append(blk)
                setattr(self, f"extra{i}", blk)
            self.cls_heads, self.loc_heads = [], []
            for i, (sz, rt) in enumerate(zip(self._sizes, self._ratios)):
                a = len(sz) + len(rt) - 1
                cls = Conv2D(a * (num_classes + 1), 3, padding=1,
                             prefix=f"cls{i}_")
                loc = Conv2D(a * 4, 3, padding=1, prefix=f"loc{i}_")
                self.cls_heads.append(cls)
                self.loc_heads.append(loc)
                setattr(self, f"cls_head{i}", cls)
                setattr(self, f"loc_head{i}", loc)

    def forward(self, x):
        conv4_3, fc7 = self.features(x)
        feats = [conv4_3, fc7]
        y = fc7
        for blk in self.extras:
            y = blk(y)
            feats.append(y)
        b = x.shape[0]
        cls_preds, loc_preds, anchors = [], [], []
        for feat, cls_head, loc_head, sz, rt in zip(
                feats, self.cls_heads, self.loc_heads, self._sizes,
                self._ratios):
            # (B, A*(C+1), H, W) -> (B, H*W*A, C+1): each anchor's class
            # vector contiguous, the reference's head layout
            c = transpose(cls_head(feat), axes=(0, 2, 3, 1))
            cls_preds.append(reshape(c, shape=(b, -1, self.num_classes + 1)))
            loc = transpose(loc_head(feat), axes=(0, 2, 3, 1))
            loc_preds.append(reshape(loc, shape=(b, -1)))
            anchors.append(multibox_prior(feat, sizes=sz, ratios=rt,
                                          clip=False))
        return (concat(*cls_preds, dim=1), concat(*loc_preds, dim=1),
                concat(*anchors, dim=1))


@recorded("ssd_multibox_loss")
def _multibox_loss(cp, bp, ct, bt, bm, ignore, lambd):
    """Per-sample loss: softmax cross-entropy over the class targets
    (``ignore`` rows, the negatives mined away, add nothing) plus
    ``lambd`` times smooth-L1 over the masked box offsets, each divided by
    the batch's count of positive anchors (at least 1)."""
    num_pos = (ct > 0).sum().clamp_min(1).to(cp.dtype)
    lp = torch.log_softmax(cp, dim=-1)
    labels = ct.clamp_min(0).long()
    nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
    nll = torch.where(ct != ignore, nll, torch.zeros_like(nll))
    cls_loss = nll.sum(dim=-1) / num_pos
    sl1 = smooth_l1((bp - bt) * bm, scalar=1.0)
    loc_loss = sl1.reshape(sl1.shape[0], -1).sum(dim=-1) / num_pos
    return cls_loss + lambd * loc_loss


class SSDMultiBoxLoss(Loss):
    """Joint classification and localisation loss (GluonCV's
    ``SSDMultiBoxLoss``): ``forward(cls_pred, box_pred, cls_target,
    box_target, box_mask)`` -> (B,) per-sample loss."""

    def __init__(self, negative_mining_ratio=-1, lambd=1.0,
                 ignore_label=-1, **kwargs):
        super().__init__(1.0, 0, **kwargs)
        self._lambd = lambd
        self._ignore = ignore_label

    def forward(self, cls_pred, box_pred, cls_target, box_target, box_mask,
                sample_weight=None):
        return _multibox_loss(cls_pred, box_pred, cls_target, box_target,
                              box_mask, float(self._ignore), self._lambd)


def get_ssd(num_classes=20, image_size=300, **kwargs):
    """SSD-300 (VOC: 20 classes)."""
    return SSD(num_classes=num_classes, image_size=image_size, **kwargs)


def ssd_300_vgg16_atrous_voc(**kwargs):
    return get_ssd(num_classes=20, image_size=300, **kwargs)
