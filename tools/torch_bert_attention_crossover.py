#!/usr/bin/env python3
"""BERT's attention core on the card: the flash kernels against the dense
chain, over the sequence length.

    python3 tools/torch_bert_attention_crossover.py [--dtype bf16|fp32]

At BERT-base's width (12 heads of 64), for T from 64 to 4096 with a batch
of 3,072 tokens (B = 3072 / T, at least 1), one layer's attention core,
forward and backward, the two ways ``models.MultiHeadAttention`` computes
it: ``attention_impl="pallas"`` (``ops.flash_attention`` with the
per-sample lengths: K4, then delta and K5/K6) and ``"xla"`` (the key mask
of ``transformer._length_mask`` and ``ops.nn.scaled_dot_product_attention``
under autograd). Lengths: every key (``valid_length`` = T, bench.py's
row) and lengths drawn from a seed in [1, T]. Device ms of CUDA-graph
replays (``chip_smoke.device_ms``), the card's name and power limit
first. The JAX package switches from its dense path to its flash kernels
at ``MXTPU_FLASH_MIN_SEQ`` = 2048 on a TPU; this measures where the port's
kernels overtake the dense chain on this card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOKENS = 3072
HEADS, HEAD_DIM = 12, 64
LENGTHS = (64, 128, 256, 512, 1024, 2048, 4096)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.models import transformer
    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import nn as pnn

    print(cs.card_line(), flush=True)
    _build.build_all()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    print(f"T, B, lengths, flash ms, dense ms, dense / flash "
          f"({args.dtype}, forward + backward of one layer)", flush=True)
    for t in LENGTHS:
        b = max(1, TOKENS // t)
        q, k, v, g = (torch.randn(b, HEADS, t, HEAD_DIM, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        mixed = torch.from_numpy(cs.bert_lengths(args.seed, b, t)).to(dev)
        for label, lens in (("full", torch.full((b,), t, device=dev,
                                                dtype=torch.int32)),
                            ("mixed", mixed)):
            def flash(lens=lens):
                out = fa.flash_attention(q, k, v, lens)
                return torch.autograd.grad(out, (q, k, v), g)

            def dense(lens=lens):
                mask = transformer._length_mask(lens, t)
                out = pnn.scaled_dot_product_attention(q, k, v, mask=mask)
                return torch.autograd.grad(out, (q, k, v), g)

            ms_f, ms_d = cs.device_ms(flash), cs.device_ms(dense)
            print(f"T={t} B={b} {label}: flash {ms_f:.5f} ms, dense "
                  f"{ms_d:.5f} ms, dense / flash {ms_d / ms_f:.3f}",
                  flush=True)
        del q, k, v, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
