#!/usr/bin/env python3
"""Where the ResNet-50 bf16 gradient gate's distance comes from: the state
of the net it runs at.

    python3 tools/torch_resnet_bf16_gate_states.py [variant ...]

``chip_smoke.resnet_bf16_gate`` holds the 161 gradients of one bf16 step
through the tensor-core K2/K3 to those through their plain versions
(relative L2, ``chip_smoke.BF16_GRAD_RTOL``), at the net that the fp32
path of ``chip_smoke.resnet_phase`` has trained. This script reports the
gate's worst tensor and its distance (the tolerance lifted, so every run
reports one) and the fp32 learning check's losses, once per variant, each
in a process of its own:

- ``drawn``: the gate at the net as drawn (cast to bf16), on four batches;
- ``rule``: ``chip_smoke.resnet_main`` as it runs;
- ``k1:simt``, ``k2:simt``, ``k3:simt``: the same with that fp32 kernel
  sent to its SIMT route (the rule and the launch checks follow);
- ``exact``: the same with every fp32 K1's per-channel sums recomputed
  from y in fp64 (the batch statistics of exact sums).

Default: every variant once. Needs a card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ("drawn", "rule", "k1:simt", "k2:simt", "k3:simt", "exact")
KERNELS = {"k1": "fused_conv", "k2": "conv_bwd_dx", "k3": "conv_bwd_dw"}


def run(variant: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    cs.BF16_GRAD_RTOL = float("inf")  # report the distance, hold nothing
    if variant == "drawn":
        import incubator_mxnet_tpu_torch as mx
        from incubator_mxnet_tpu_torch import gluon
        from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

        ctx = mx.gpu(0)
        dev = ctx.torch_device()
        mx.random.seed(0)
        net = get_model("fused_resnet50_v1", classes=1000).initialize(
            "xavier", ctx=ctx)
        net.cast("bfloat16")
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        worst = []
        for k in range(4):
            gen = torch.Generator(device=dev)
            gen.manual_seed(41 + 100 * k)
            x = torch.rand((8, 3, 224, 224), generator=gen, device=dev)
            y = torch.randint(0, 1000, (8,), generator=gen, device=dev)
            out = cs.resnet_bf16_gate(net, ce, x.to(torch.bfloat16),
                                      y.float())
            worst.append(f"{out['worst']:.5f} ({out['worst_name']})")
        print(f"gate {variant}: {', '.join(worst)}", flush=True)
        return
    if ":" in variant:
        kernel = KERNELS[variant.split(":")[0]]
        rule = fc.conv_route

        def forced(dtype, ci, co, kern="fused_conv", operands=()):
            route = rule(dtype, ci, co, kern, operands)
            return "simt" if dtype == torch.float32 and kern == kernel \
                else route

        fc.conv_route = forced
    if variant == "exact":
        launch = fc.fused_conv

        def exact(*args, **kwargs):
            out = launch(*args, **kwargs)
            y = out[0]
            if y.dtype != torch.float32:
                return out
            yd = y.double()
            return (y, yd.sum(dim=(0, 1, 2)).float(),
                    (yd * yd).sum(dim=(0, 1, 2)).float()) + tuple(out[3:])

        fc.fused_conv = exact
    out = cs.resnet_main(0, cs.card_line())
    gate = out["bf16_gate"]
    print(f"gate {variant}: {gate['worst']:.5f} ({gate['worst_name']}); "
          f"fp32 learning check {[round(v, 4) for v in out['learning_losses']]}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        run(argv[1])
        return 0
    for variant in argv or VARIANTS:
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}; known {VARIANTS}")
        proc = subprocess.run([sys.executable, __file__, "--one", variant],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("gate ")]
        print(lines[-1] if lines and proc.returncode == 0 else
              f"gate {variant}: failed (exit {proc.returncode})\n"
              f"{proc.stderr[-2000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
