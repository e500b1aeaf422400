#!/usr/bin/env python3
"""BERT-base's first SGD steps on one batch at several learning rates.

    python3 tools/torch_sparse_lr_sweep.py [--seed 0] [--lrs 1e-4 3e-5 1e-5 3e-6]

``bert_12_768_12`` (dropout 0, ``attention_impl="pallas"``, fp32, drawn
from ``--seed`` with ``"xavier"`` and, for comparison, ``Normal(0.02)``)
at B=8, T=128 with ``chip_smoke.bert_batch`` and ``bert_lengths``: three
``gluon.Trainer`` SGD steps (momentum 0.9, wd 1e-4) on the same batch
for each learning rate, printing the batch's loss before each step and
after the last, and the squared norm of the first gradient, the card's
name and power limit first. The sparse phase of ``chip_smoke.py`` takes
its learning rate (``SPARSE_LR``) from this sweep: the largest at which
each step lowers the loss of its batch.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[1e-4, 3e-5, 1e-5, 3e-6])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sparse_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, initializer
    from incubator_mxnet_tpu_torch.models import get_bert

    print(cs.card_line(), flush=True)
    ctx = mx.gpu(0)
    loss_fn = cs.bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())
    data, labels = cs.bert_batch(np.random.RandomState(args.seed + 131), 8,
                                 128, 30522, ctx.torch_device(),
                                 cs.bert_lengths(args.seed, 8, 128))
    net = get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                   dropout=0.0, attention_impl="pallas")
    for init in ("xavier", "normal(0.02)"):
        for lr in args.lrs:
            mx.random.seed(args.seed)
            net.initialize("xavier" if init == "xavier"
                           else initializer.Normal(0.02), ctx=ctx,
                           force_reinit=True)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": 0.9,
                                "wd": 1e-4})
            losses = []
            for step in range(3):
                with mx.autograd.record():
                    loss = loss_fn(*net(*data), *labels)
                mx.autograd.backward(loss)
                losses.append(float(loss.detach()))
                if step == 0:
                    grad_sq = sum(float(p.grad.double().square().sum())
                                  for p in net.parameters()
                                  if p.grad is not None)
                tr.step(1)
            with torch.no_grad():
                losses.append(float(loss_fn(*net(*data), *labels)))
            print(f"{init} lr {lr:g}: first gradient's squared norm "
                  f"{grad_sq:.3f}, the batch's loss "
                  f"{[round(v, 5) for v in losses]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
