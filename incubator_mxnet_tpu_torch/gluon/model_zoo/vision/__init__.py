"""Vision models of the port: the zoo ResNets and the fused ResNet v1s.

``get_model`` knows the ten zoo ResNets (``resnet{18,34,50,101,152}_v1``
and ``_v2``, the gluon layer set, NCHW) and the three fused ones
(``fused_resnet{50,101,152}_v1``, the hand-written conv + BatchNorm
kernels, NHWC). The JAX package's other vision models (VGG, AlexNet,
DenseNet, ...) are not ported yet: asking for one raises ``ValueError``
(``ROADMAP.md`` lists what comes next).
"""

from . import resnet
from .fused_resnet import (FusedBottleneckV1, FusedResNetV1,
                           fused_resnet101_v1, fused_resnet152_v1,
                           fused_resnet50_v1, materialize)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "FusedBottleneckV1", "FusedResNetV1", "ResNetV1", "ResNetV2",
           "fused_resnet101_v1", "fused_resnet152_v1", "fused_resnet50_v1",
           "get_model", "get_resnet", "materialize"]

_models = {
    "fused_resnet50_v1": fused_resnet50_v1,
    "fused_resnet101_v1": fused_resnet101_v1,
    "fused_resnet152_v1": fused_resnet152_v1,
}
for _depth in (18, 34, 50, 101, 152):
    for _version in (1, 2):
        _name = f"resnet{_depth}_v{_version}"
        _models[_name] = getattr(resnet, _name)
        globals()[_name] = _models[_name]
        __all__.append(_name)


def get_model(name, **kwargs):
    """Look up a vision model by name (reference ``model_zoo.get_model``)."""
    key = name.lower()
    if key not in _models:
        raise ValueError(
            f"model {name!r} is not ported yet; the port has "
            f"{sorted(_models)} (ROADMAP.md lists what comes next)")
    return _models[key](**kwargs)
