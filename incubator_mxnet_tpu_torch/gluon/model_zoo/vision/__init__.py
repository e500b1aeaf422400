"""Vision models of the port: the JAX package's vision zoo and the fused
ResNet v1s.

``get_model`` knows the reference's 36 names, each built of the gluon
layer set (NCHW, OIHW weights, cuDNN and cuBLAS on the card: the JAX
package leaves these convs to XLA): the ResNets v1/v2
(``resnet{18,34,50,101,152}_v{1,2}``), VGG 11/13/16/19 with and without
BatchNorm, AlexNet, DenseNet 121/161/169/201, SqueezeNet 1.0/1.1,
Inception v3 (299x299 input), MobileNet v1 (``mobilenet{1.0,0.75,0.5,
0.25}``), v2 (``mobilenetv2_*``) and v3 (``mobilenetv3_large``/
``_small``); and the port's three fused ResNets
(``fused_resnet{50,101,152}_v1``, the hand-written conv + BatchNorm
kernels, NHWC). Parameter names are the JAX package's structural names,
so ``load_jax_params`` carries weights across by name.
"""

from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .fused_resnet import (FusedBottleneckV1, FusedResNetV1,
                           fused_resnet101_v1, fused_resnet152_v1,
                           fused_resnet50_v1, materialize)
from .inception import Inception3, inception_v3
from .mobilenet import (LinearBottleneck, MobileNet, MobileNetV2,
                        MobileNetV3, mobilenet0_25, mobilenet0_5,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_25,
                        mobilenet_v2_0_5, mobilenet_v2_0_75,
                        mobilenet_v2_1_0, mobilenet_v3_large,
                        mobilenet_v3_small)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "mobilenetv3_large": mobilenet_v3_large,
    "mobilenetv3_small": mobilenet_v3_small,
    "fused_resnet50_v1": fused_resnet50_v1,
    "fused_resnet101_v1": fused_resnet101_v1,
    "fused_resnet152_v1": fused_resnet152_v1,
}

__all__ = ["AlexNet", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
           "BottleneckV2", "DenseNet", "FusedBottleneckV1", "FusedResNetV1",
           "Inception3", "LinearBottleneck", "MobileNet", "MobileNetV2",
           "MobileNetV3", "ResNetV1", "ResNetV2", "SqueezeNet", "VGG",
           "get_model", "get_resnet", "get_vgg", "materialize"] + sorted(
    fn.__name__ for fn in _models.values())


def get_model(name, **kwargs):
    """Look up a vision model by name (reference ``model_zoo.get_model``);
    ``kwargs`` go to its constructor."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"model {name!r} not found; available: {sorted(_models)}")
    return _models[name](**kwargs)
