"""Port parity: AlexNet, VGG and SqueezeNet, and the zoo's names.

Miniature configurations of the reference's classes at B=2, 64x64
(``AlexNet`` itself; ``VGG([1, 1, 1, 1, 1], [8, 16, 16, 32, 32])`` with
and without BatchNorm; ``SqueezeNet("1.0")`` and ``"1.1"``) against the
JAX package on the CPU: eval logits, training logits with every Dropout
rate at 0, the running statistics after the training forward and every
gradient of the mean softmax cross entropy (``torch_vision_reference``:
``RTOL`` 1e-4 and the rules past it). Then every one of the reference's 36
vision names: the port's structural parameter names equal the JAX
package's, which the reference knows before any forward; and
``get_model``'s unknown-name error in the reference's words.
"""

import pytest
import torch

from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model, vision

import torch_vision_reference as ref
from torch_vision_reference import one_torch_thread  # noqa: F401

MODELS = {
    "alexnet": (lambda pkg: pkg.gluon.model_zoo.vision.AlexNet(
        classes=ref.CLASSES), 2),
    "vgg_mini": (lambda pkg: pkg.gluon.model_zoo.vision.VGG(
        [1, 1, 1, 1, 1], [8, 16, 16, 32, 32], classes=ref.CLASSES), 2),
    "vgg_mini_bn": (lambda pkg: pkg.gluon.model_zoo.vision.VGG(
        [1, 1, 1, 1, 1], [8, 16, 16, 32, 32], classes=ref.CLASSES,
        batch_norm=True), 2),
    "squeezenet1.0": (lambda pkg: pkg.gluon.model_zoo.vision.SqueezeNet(
        "1.0", classes=ref.CLASSES), 1),
    "squeezenet1.1": (lambda pkg: pkg.gluon.model_zoo.vision.SqueezeNet(
        "1.1", classes=ref.CLASSES), 1),
}


@pytest.mark.parametrize("key", list(MODELS))
def test_vision_plain_matches_jax(key):
    """Eval logits, training logits, running statistics and every
    gradient within ``RTOL`` of the JAX package's (or held by the rule of
    ``torch_vision_reference.check``): the gradients of the conv biases
    that feed a BatchNorm are 0 in exact arithmetic and are held on their
    weights' scale; AlexNet may hold two on their own scale, the others
    none."""
    make, dropouts = MODELS[key]
    p = ref.pair(make, 64, 2)
    assert p["dropouts"] == dropouts
    held = ref.check(p)
    assert len(held["replay"]) <= (2 if key == "alexnet" else 0), held
    assert held["sibling"] == ([f"features.{i}.bias" for i in
                                (0, 12, 16, 4, 8)]
                               if key == "vgg_mini_bn" else []), held
    head = [n for n in p["grads"] if n.endswith("weight")][-1]
    assert head not in held["replay"], held


def test_vision_names_equal_jax_for_every_model():
    """Every name of the reference's ``get_model`` builds in the port,
    with the JAX package's structural parameter names in its order (the
    three fused ResNets beside them); an unknown name raises in the
    reference's words; ``pretrained`` raises; ``prefix`` and ``params``
    pass through to the block, as the reference's."""
    assert len(jvision._models) == 36
    assert set(vision._models) == set(jvision._models) | {
        f"fused_resnet{d}_v1" for d in (50, 101, 152)}
    for name in sorted(jvision._models):
        want = list(jvision.get_model(name,
                                      classes=7)._collect_params_with_prefix())
        net = get_model(name.upper() if name == "alexnet" else name,
                        classes=7)
        names = dict(net.named_parameters())
        assert list(names) == want, name
        assert names[want[-1]].shape[0] == 7, name
    with pytest.raises(ValueError) as err:
        get_model("vgg17")
    jerr = pytest.raises(ValueError, jvision.get_model, "vgg17")
    assert str(err.value).startswith(str(jerr.value)[:30])
    assert "not found; available:" in str(err.value)
    with pytest.raises(RuntimeError, match="pretrained"):
        get_model("squeezenet1.0", pretrained=True)
    net, jnet = get_model("vgg11", prefix="vgg_"), \
        jvision.get_model("vgg11", prefix="vgg_")
    assert net.prefix == jnet.prefix == "vgg_"
    assert list(net.collect_params()) == list(jnet.collect_params())
    assert vision.inception_v3(params=None).params.prefix.startswith(
        "inception3")


#: the inventory the JAX package gives at classes=1000 once its first
#: forward at the image size filled the deferred shapes (values with the
#: running statistics, trainable tensors, running statistics, convs);
#: ``chip_smoke.VISION_MODELS`` holds the card's models to it
PINNED = {
    "alexnet": (224, (61_100_840, 16, 0, 5)),
    "vgg16_bn": (224, (138_374_440, 58, 26, 13)),
    "squeezenet1.1": (224, (1_235_496, 52, 0, 26)),
    "densenet121": (224, (8_062_504, 364, 242, 120)),
    "inceptionv3": (299, (23_869_000, 284, 188, 94)),
    "mobilenet1.0": (224, (4_253_864, 83, 54, 27)),
    "mobilenetv2_1.0": (224, (3_539_136, 160, 106, 54)),
    "mobilenetv3_large": (224, (5_505_598, 174, 92, 62)),
}


def test_imagenet_width_inventories_equal_the_jax_package():
    """The vision phase's eight models at classes=1000: the port's
    inventory after one forward at the image size equals the JAX
    package's (``PINNED``, computed once with the JAX package on the
    CPU), and ``chip_smoke.VISION_MODELS`` pins the same."""
    assert ref.cs.VISION_MODELS == PINNED
    for name, (hw, want) in PINNED.items():
        net = ref.cs.vision_net(name, mx.cpu(), hw, 1000, init="zeros")
        assert ref.cs.inventory(net) == want, name


def test_alexnet_dense_width_follows_the_image():
    """The first ``Dense`` of AlexNet (and VGG) takes its width from the
    first forward: 9216 at 224x224 (VGG's 25088 in ``PINNED``), so the
    parameter count depends on the image size; ``ctx`` and ``root`` are
    ignored; the Dropout layers keep the reference's rate."""
    for name, hw, width in (("alexnet", 224, 9216), ("alexnet", 64, 256)):
        net = get_model(name, classes=5, ctx=mx.gpu(0), root="/nowhere")
        assert tuple(net.features[-4].weight.shape) == (4096, 0)
        net.initialize("zeros", ctx=mx.cpu())
        with torch.no_grad():
            out = net(torch.zeros(1, 3, hw, hw))
        assert tuple(out.shape) == (1, 5)
        assert tuple(net.features[-4].weight.shape) == (4096, width), name
        assert [m._rate for m in net.modules()
                if isinstance(m, nn.Dropout)] == [0.5, 0.5]
