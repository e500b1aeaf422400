"""Port parity: DenseNet and Inception v3.

``DenseNet(16, 8, [2, 2, 2, 2], dropout=0.1)`` at B=2, 64x64 (its last
block at 2x2) and ``Inception3`` at B=1, 299x299 (the size its closing
8x8 average pool needs) against the JAX package on the CPU: eval logits,
training logits with every Dropout rate at 0, the running statistics
after the training forward and every gradient of the mean softmax cross
entropy (``torch_vision_reference``: ``RTOL`` 1e-4 and the rules past it).
Inception's ``HybridConcurrent`` blocks, ``_make_E``'s nesting among them,
carry the JAX package's parameter names.

Inception is 47 convs deep: the fp32 forwards of the two packages drift
apart by 1e-5 relative at the top, and activations that close to a ReLU's
kink take different sides in them. Every gradient upstream of such an
activation then differs by percents between any two fp32 evaluations, the
JAX package's against fp64 too. Each side's gradient is held to the exact
backward of its own forward (the port's fp64 model fed that side's leaf
outputs), and each held gradient lies upstream of such a flip.
"""

import pytest

from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

from incubator_mxnet_tpu_torch.gluon.contrib.nn import HybridConcurrent
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model, vision

import torch_vision_reference as ref
from torch_vision_reference import one_torch_thread  # noqa: F401


def _densenet(pkg):
    return pkg.gluon.model_zoo.vision.DenseNet(16, 8, [2, 2, 2, 2],
                                               dropout=0.1,
                                               classes=ref.CLASSES)


def _inception(pkg):
    return pkg.gluon.model_zoo.vision.Inception3(classes=ref.CLASSES)


def test_densenet_matches_jax():
    """Every ``_DenseLayer`` carries its ``Dropout``; the stem BatchNorm's
    gamma gradient (``features.1.gamma``), a sum that cancels, is the one
    gradient past ``RTOL``, as ``ResNetV2``'s in
    ``tests/test_torch_resnet_zoo.py``: held on its beta's scale."""
    p = ref.pair(_densenet, 64, 2)
    assert p["dropouts"] == 8
    held = ref.check(p)
    assert held == dict(replay=[], sibling=["features.1.gamma"]), held


def test_inception_v3_matches_jax():
    p = ref.pair(_inception, 299, 1)
    assert p["dropouts"] == 1
    held = ref.check(p)
    assert all(n.endswith((".beta", ".gamma")) for n in held["sibling"])
    # the head compares directly
    assert not {"output.weight", "output.bias"} & set(sum(held.values(), []))


def test_inception_structure_and_densenet_121_widths():
    """``_make_E`` nests a ``Concurrent`` in a ``HybridSequential`` in a
    ``Concurrent``: its names, in the reference's order, are the JAX
    package's; the first A block's first conv is ``features.7.0.0.0``.
    ``densenet121``'s transitions halve 256, 512 and 1024 channels."""
    net = get_model("inceptionv3")
    names = list(dict(net.named_parameters()))
    assert names == list(
        jvision.inception_v3()._collect_params_with_prefix())
    assert names[names.index("features.7.0.0.0.weight") - 1].startswith(
        "features.5.")
    assert [n for n in names if n.startswith("features.17.1.1.1.")] == [
        "features.17.1.1.1.0.0.weight"] + [
        f"features.17.1.1.1.0.1.{k}" for k in
        ("gamma", "beta", "running_mean", "running_var")]
    assert isinstance(net.features[17], HybridConcurrent)
    assert isinstance(net.features[17][1][1], HybridConcurrent)
    dn = vision.densenet121()
    widths = [dn.features[i][2]._channels for i in (5, 7, 9)]
    assert widths == [128, 256, 512]
    assert [len(dn.features[i]) for i in (4, 6, 8, 10)] == [6, 12, 24, 16]
    with pytest.raises(ValueError, match="mode must be"):
        vision.MobileNetV3("medium")
