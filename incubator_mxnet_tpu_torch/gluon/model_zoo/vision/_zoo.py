"""What every constructor of the vision zoo shares."""

from __future__ import annotations


def build(cls, *args, pretrained=False, ctx=None, root=None, **kwargs):
    """``cls(*args, **kwargs)`` for a zoo constructor (reference
    ``model_zoo.vision``'s ``pretrained``/``ctx``/``root`` arguments:
    ``ctx`` and ``root`` are ignored, and there are no pretrained weights
    to fetch). ``prefix`` and ``params`` go to the block, as in the
    reference; a keyword the class does not take raises ``TypeError``."""
    if pretrained:
        raise RuntimeError("pretrained weights are not available; load a "
                           "checkpoint or JAX parameters instead")
    return cls(*args, **kwargs)
