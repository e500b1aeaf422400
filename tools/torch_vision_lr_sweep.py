#!/usr/bin/env python3
"""The vision phase's learning check at several learning rates.

    python3 tools/torch_vision_lr_sweep.py [--seed 0] [--models ...]
        [--lrs 0.01 0.03 0.1 0.3 1 3] [--steps 6]

For each model of ``chip_smoke.VISION_MODELS`` (or ``--models``) at
classes=1000, drawn from ``--seed`` with ``"xavier"`` on the card as the
vision phase draws it, and for each learning rate: ``--steps`` steps of
``chip_smoke.vision_step`` (fp32 ``gluon.Trainer`` sgd, momentum 0.9,
``split_and_load``, ``clip_global_norm`` at ``VISION_CLIP``) on the phase's
B=32 batch, repeated, printing the loss before each step, the gradient
norms and the fall over the steps; the card's name and power limit first.
The vision phase of ``chip_smoke.py`` takes a model's rate
(``VISION_LR``) from this sweep: the smallest rate that lowers the loss by
10% over 6 steps (twice the phase's gate), or, where none does without
diverging, the one that lowers it most.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models", nargs="+")
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[0.01, 0.03, 0.1, 0.3, 1.0, 3.0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_vision_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mx

    print(cs.card_line(), flush=True)
    ctx = mx.gpu(0)
    for name in args.models or list(cs.VISION_MODELS):
        hw = cs.VISION_MODELS[name][0]
        _, (x, y) = cs.vision_batches(args.seed, hw, 1000,
                                      ctx.torch_device())
        x, y = x.cpu().numpy(), y.cpu().numpy()
        for lr in args.lrs:
            mx.random.seed(args.seed)
            net = cs.vision_net(name, ctx, hw, 1000)
            step, norms = cs.vision_step(net, x, y, ctx, lr)
            losses = [float(step().asscalar()) for _ in range(args.steps)]
            fall = 1 - losses[-1] / losses[0]
            print(f"{name} lr {lr:g}: losses "
                  f"{[round(v, 4) for v in losses]}, gradient norms "
                  f"{[round(v, 3) for v in norms]}, fall {100 * fall:.1f}%",
                  flush=True)
            del step, net
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
