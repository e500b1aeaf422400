"""Port parity: MobileNet v1 and v2 (v3: ``test_torch_vision_mobile_v3.py``).

``MobileNet(0.25)`` and ``MobileNetV2(0.25)`` at B=2, 64x64 (their last
maps at 2x2) against the JAX package on the CPU: eval logits, training
logits, the running statistics after the training forward and every
gradient of the mean softmax cross entropy
(``torch_vision_reference.check_mobilenet``: ``RTOL`` 1e-4 and the rules
past it). Their depthwise convs (``groups`` = channels) keep the
reference's ``(C, 1, k, k)`` weights through ``load_jax_params``.

The betas of v2's projecting BatchNorms have a gradient of 0 in exact
arithmetic (they feed only linear paths into the next BatchNorm, which
takes a constant out): they are held on their gammas' scale. v1 and v2
are 28 and 53 convs deep, where an activation within rounding of a ReLU's
or a clip's kink sends the gradients upstream of it apart between any two
fp32 evaluations: each side is held to the exact backward of its own
forward.
"""

import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

import torch_vision_reference as ref
from torch_vision_reference import one_torch_thread  # noqa: F401

MODELS = {
    "mobilenet0.25": lambda pkg: pkg.gluon.model_zoo.vision.MobileNet(
        0.25, classes=ref.CLASSES),
    "mobilenetv2_0.25": lambda pkg: pkg.gluon.model_zoo.vision.MobileNetV2(
        0.25, classes=ref.CLASSES),
}


@pytest.mark.parametrize("key", list(MODELS))
def test_mobilenet_matches_jax(key):
    ref.check_mobilenet(MODELS[key])


@pytest.mark.parametrize("name,depthwise", [
    ("mobilenet1.0", 13), ("mobilenetv2_1.0", 17),
    ("mobilenetv3_large", 15), ("mobilenetv3_small", 11)])
def test_depthwise_convs_are_grouped_per_channel(name, depthwise):
    """Every depthwise conv has ``groups`` equal to its channels and a
    ``(C, 1, k, k)`` weight; v3's SE blocks and 5x5 kernels where the
    reference puts them."""
    net = get_model(name).initialize(ctx=mx.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 3, 64, 64))
    convs = [m for m in net.modules() if hasattr(m, "_groups")
             and m._groups > 1]
    assert len(convs) == depthwise
    for m in convs:
        assert m._groups == m._channels
        assert tuple(m.weight.shape) == (m._channels, 1) + m._kernel
