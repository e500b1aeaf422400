#!/usr/bin/env python3
"""BERT-base's fp32 gradients against an fp64 pass, three ways.

    python3 tools/torch_bert_fp64_gap.py [--seed 0] [--batches 97 99]

``bert_12_768_12`` (dropout 0, weights drawn from ``--seed`` as
``chip_smoke.bert_main`` draws them) at B=8, T=128 with
``chip_smoke.bert_batch`` (one batch per ``--batches`` offset of the
seed; 97 is the BERT phase's) and ``bert_lengths``: the gradients of the
pretraining loss of every parameter tensor through (a) the gluon net with
``attention_impl="pallas"`` (K4-K6 on the f32 route), (b) the same net
with its attention swapped for the autograd of the plain version (the
dense fp32 chain) and (c) ``chip_smoke.nd_bert_step`` (the GluonNLP-1.x
ops: interleaved matmuls, ``masked_softmax``), each against the same
pass in fp64 through the plain attention (``chip_smoke.fp64_referee``).
Prints, per batch, the worst relative L2 errors (``_worst_grad``'s
measure: the key bias, whose exact gradient is 0, against its layer's key
weight gradient) and the eight worst tensors of (a) against (b), the
card's name and power limit first.
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
    ap.add_argument("--batches", type=int, nargs="+", default=[97, 99])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.models import get_bert, transformer
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import _build

    print(cs.card_line(), flush=True)
    _build.build_all()
    ctx = mx.gpu(0)
    mx.random.seed(args.seed)
    net = get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                   dropout=0.0, attention_impl="pallas").initialize(
                       "xavier", ctx=ctx)
    named = [(n, p) for n, p in mx.parallel.collect_params(net).items()
             if p.requires_grad]
    names = [n for n, _ in named]
    loss_fn = cs.bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())
    lens = cs.bert_lengths(args.seed, 8, 128)
    for offset in args.batches:
        data, labels = cs.bert_batch(np.random.RandomState(args.seed
                                                           + offset),
                                     8, 128, 30522, ctx.torch_device(), lens)
        with mx.autograd.record():
            loss = loss_fn(*net(*data), *labels)
        flash = torch.autograd.grad(loss, [p for _, p in named])
        with cs.swap_attention(transformer), mx.autograd.record():
            loss = loss_fn(*net(*data), *labels)
        dense = torch.autograd.grad(loss, [p for _, p in named])
        params = {n: NDArray(p) for n, p in named}
        cs.nd_bert_step(mx, params, [NDArray(x) for x in data],
                        [NDArray(y) for y in labels], 12, 12)
        nd1x = [p.grad.clone() for _, p in named]
        worst = cs.fp64_referee(net, loss_fn, data, labels, transformer,
                                {"K4-K6": flash, "dense fp32": dense,
                                 "1.x": nd1x})
        print(f"batch seed + {offset} (valid_length {lens.tolist()}): worst "
              "relative L2 error against fp64: "
              + "; ".join(f"{k} {v[0]:.3e} ({v[1]})"
                          for k, v in worst.items()), flush=True)
        # the key bias's exact gradient is 0: left out of this list
        rows = sorted(((float((f.double() - d.double()).norm()
                               / d.double().norm()), n)
                       for n, f, d in zip(names, flash, dense)
                       if not n.endswith(cs.KEY_BIAS)), reverse=True)
        print("  K4-K6 against the dense fp32 chain, the eight worst "
              "tensors: " + ", ".join(f"{n} {e:.3e}" for e, n in rows[:8]),
              flush=True)
        for p in net.parameters():
            p.grad = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
