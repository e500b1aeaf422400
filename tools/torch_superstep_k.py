#!/usr/bin/env python3
"""Host ms a training step against the window K of the CUDA-graph path.

    python3 tools/torch_superstep_k.py [--rows gpt,mlp] [--seed 0]

Two of ``chip_smoke.py``'s graph rows at full width: ``gpt`` (bf16
``gpt_decoder_117m`` with dropout 0.1, B=8, T=256, SGD lr 1e-4 momentum
0.9) and ``mlp`` (bench.py's mlp row: bf16, B=8192, 784-512-512-10, SGD lr
0.1 momentum 0.9), each through ``parallel.SPMDTrainer``. For each row:
the eager ``step()``; ``run_superstep`` with windows of K distinct batches
for each K (one replay a window; the first window captures, the next two
are timed); and ``run_steps(n)`` (one captured step replayed n times on
one batch). Prints one line per measurement and a JSON line of them all:
host ms a step (ending in a synchronize), the first call's seconds
(warm-up and capture), the peak memory above the row's baseline, and the
card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KS = {"gpt": (1, 2, 5, 10), "mlp": (1, 2, 5, 10, 20)}


def _row(name, seed, dev):
    """(make trainer, draw one batch) of a row."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    mx.random.seed(seed)
    if name == "gpt":
        net = get_gpt("gpt_decoder_117m", vocab_size=50257,
                      max_length=256).initialize("xavier", ctx=mx.gpu(0))
        net.cast("bfloat16")

        def batch():
            return (torch.randint(0, 50257, (8, 256), generator=gen,
                                  device=dev, dtype=torch.int32),
                    torch.randint(0, 50257, (8, 256), generator=gen,
                                  device=dev).float())

        return (lambda: parallel.SPMDTrainer(
            net, lambda lg, lb: ce(lg, lb).mean(), "sgd",
            {"learning_rate": 1e-4, "momentum": 0.9})), batch
    net = nn.HybridSequential()
    net.add(nn.Dense(512, activation="relu"),
            nn.Dense(512, activation="relu"), nn.Dense(10))
    net.initialize("xavier", ctx=mx.gpu(0))
    net.cast("bfloat16")
    net(torch.zeros(2, 784, dtype=torch.bfloat16, device=dev))

    def batch():
        return (torch.rand((8192, 784), generator=gen, device=dev).to(
            torch.bfloat16), torch.randint(0, 10, (8192,), generator=gen,
                                           device=dev).float())

    return (lambda: parallel.SPMDTrainer(
        net, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9})), batch


def _timed(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="gpt,mlp")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_superstep_k: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    out = {"card": card}
    for name in args.rows.split(","):
        make, batch = _row(name, args.seed, dev)
        res = out[name] = {}
        st = make()
        x, y = batch()
        for _ in range(3):
            st.step(x, y)
        n = max(KS[name])
        res["eager_ms"] = _timed(lambda: [st.step(x, y) for _ in range(n)],
                                 n)
        print(f"{name} eager step(): {res['eager_ms']:.4f} ms a step",
              flush=True)
        del st
        for k in KS[name]:
            st = make()
            wins = []
            for _ in range(3):
                xs, ys = zip(*[batch() for _ in range(k)])
                wins.append((torch.stack(xs), torch.stack(ys)))
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st.run_superstep(*wins[0])
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ms = _timed(lambda: [st.run_superstep(*w) for w in wins[1:]],
                        2 * k)
            peak = torch.cuda.max_memory_allocated() - base
            res[f"superstep_k{k}"] = dict(ms=ms, first_s=first_s,
                                          peak_bytes=peak)
            print(f"{name} run_superstep K={k}: {ms:.4f} ms a step (first "
                  f"call {first_s:.2f} s; peak {peak / 2**20:.1f} MiB above "
                  f"the row's baseline)", flush=True)
            del st, wins
        st = make()
        x, y = batch()
        st.run_steps(1, x, y)
        ms = _timed(lambda: st.run_steps(n, x, y), n)
        res[f"run_steps_n{n}"] = dict(ms=ms)
        print(f"{name} run_steps({n}) (one captured step, {n} replays): "
              f"{ms:.4f} ms a step", flush=True)
        del st, make, batch
        gc.collect()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
