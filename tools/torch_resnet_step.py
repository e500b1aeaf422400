#!/usr/bin/env python3
"""Time the bf16 ResNet-50 training step of this checkout, host and device.

    python3 tools/torch_resnet_step.py [--batch 128] [--steps 5] [--seed 0]

``bench.py``'s ``resnet50`` row at one card, as ``chip_smoke.py`` runs
it: ``fused_resnet50_v1`` (1000 classes, weights from ``--seed``) cast to
bf16, ``parallel.SPMDTrainer`` SGD lr 0.1 momentum 0.9, one batch of
224x224 images. Prints, as one JSON line: the mean step time over
``--steps`` steps after 2 warmup (host clock, ending in a synchronize);
for one more step, when the host returned from it and when the device
finished it (the host is the limit when the two are close); and the
device time of one profiled step (``chip_smoke._profile_step``, kernels
only) with the device's idle share of the unprofiled step. Runs against
the package beside it, so a copy in another checkout times that one.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resnet_step: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    mx.random.seed(args.seed)
    net = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=mx.gpu(0)).cast("bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 31)
    x = torch.rand((args.batch, 3, 224, 224), generator=gen,
                   device=dev).to(torch.bfloat16)
    y = torch.randint(0, 1000, (args.batch,), generator=gen,
                      device=dev).float()
    st = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    for _ in range(2):
        st.step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [st.step(x, y) for _ in range(args.steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if not all(torch.isfinite(v) for v in losses):
        raise AssertionError("bf16 SPMDTrainer loss not finite")
    t0 = time.perf_counter()
    st.step(x, y)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1e3
    rows = cs._profile_step(st.step, x, y, card, step_ms, tags=cs.CONV_TAGS,
                            top=0)
    device_ms = sum(r[0] for r in rows)
    print(json.dumps({
        "checkout": str(ROOT), "card": card, "batch": args.batch,
        "step_ms": step_ms, "images_s": args.batch / step_ms * 1e3,
        "host_returns_ms": host_ms, "device_done_ms": done_ms,
        "device_ms": device_ms,
        "idle_share": max(0.0, 1 - device_ms / step_ms),
        "launches": sum(r[1] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
