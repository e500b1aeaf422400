"""Vision models of the port: the fused ResNet v1 family.

``get_model`` knows the three fused names. The JAX package's other
vision models (the unfused zoo ``resnet*``, VGG, ...) are not ported yet:
asking for one raises ``ValueError`` (``ROADMAP.md`` queues the unfused
``resnet50_v1`` next).
"""

from .fused_resnet import (FusedBottleneckV1, FusedResNetV1,
                           fused_resnet101_v1, fused_resnet152_v1,
                           fused_resnet50_v1, materialize)

__all__ = ["FusedBottleneckV1", "FusedResNetV1", "fused_resnet101_v1",
           "fused_resnet152_v1", "fused_resnet50_v1", "get_model",
           "materialize"]

_models = {
    "fused_resnet50_v1": fused_resnet50_v1,
    "fused_resnet101_v1": fused_resnet101_v1,
    "fused_resnet152_v1": fused_resnet152_v1,
}


def get_model(name, **kwargs):
    """Look up a vision model by name (reference ``model_zoo.get_model``)."""
    key = name.lower()
    if key not in _models:
        raise ValueError(
            f"model {name!r} is not ported yet; the port has "
            f"{sorted(_models)} (ROADMAP.md lists what comes next)")
    return _models[key](**kwargs)
