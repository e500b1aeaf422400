"""Port parity: MobileNet v3, "large" and "small".

``MobileNetV3("large", 0.25)`` and ``("small", 0.25)`` at B=2, 64x64 (their
last maps at 2x2) against the JAX package on the CPU: eval logits,
training logits, the running statistics after the training forward and
every gradient of the mean softmax cross entropy
(``torch_vision_reference.check_mobilenet``: ``RTOL`` 1e-4 and the rules
past it), through the squeeze-and-excite blocks, hard-swish and the 5x5
depthwise convs. The betas of the projecting BatchNorms have a gradient
of 0 in exact arithmetic (they feed only linear paths into the next
BatchNorm, which takes a constant out): they are held on their gammas'
scale. Kept apart from v1 and v2 so that
``--dist loadfile`` runs the two files side by side.
"""

import pytest

import torch_vision_reference as ref
from torch_vision_reference import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["large", "small"])
def test_mobilenet_v3_matches_jax(mode):
    held = ref.check_mobilenet(
        lambda pkg: pkg.gluon.model_zoo.vision.MobileNetV3(
            mode, 0.25, classes=ref.CLASSES))
    # the betas of the 15 (11) projecting BatchNorms, 0 in exact arithmetic
    betas = [n for n in held["sibling"] if n.endswith(".beta")]
    assert len(betas) == {"large": 15, "small": 11}[mode], held
