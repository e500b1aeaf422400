#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one card.

    python3 tools/torch_decode_profile.py [--seed 0] [--steps 20]

Builds ``gpt_decoder_117m`` (random weights from ``--seed``) on ``cuda:0``
with an 8-slot, 512-token KV cache whose slots sit at seeded fill levels,
then runs ``GPTDecoder.decode_step`` directly (no scheduler) and prints:

* the eager step's wall time (host clock, each step synchronized);
* the device time of the same step captured in one CUDA graph and replayed
  (no host work between kernels): what the step costs the card;
* a ``torch.profiler`` table of device time by kernel over a few eager
  steps, with the device's busy share of the wall time.

Each step writes its new K/V at the same positions again, so every step
reads the same cache. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.serving import KVCache

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    mx.random.seed(args.seed)
    net = get_gpt("gpt_decoder_117m", dropout=0.0).initialize(
        "xavier", ctx=mx.gpu(0))
    slots, max_len = 8, 512
    kv = KVCache(net.num_layers, slots, net.num_heads, max_len, net.head_dim,
                 torch.float32, dev)
    rs = np.random.RandomState(args.seed)
    cache_len = torch.from_numpy(rs.randint(1, max_len - 1, slots).astype(
        np.int32)).to(dev)
    tokens = torch.from_numpy(rs.randint(0, net.vocab_size, slots).astype(
        np.int32)).to(dev)
    print(f"slots {slots}, cache fill {cache_len.tolist()} of {max_len}")

    def step():
        return net.decode_step(tokens, kv.k, kv.v, cache_len)[0]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    print(f"eager step: median {wall_ms:.3f} ms over {args.steps} steps "
          f"(min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f})")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / args.steps
    print(f"graph-replayed step (device time): {graph_ms:.3f} ms = "
          f"{graph_ms / wall_ms:.3f} of the eager step")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # kernel events only: an aten op's row repeats its kernels' time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("profiler: no device time recorded (not measured)")
        return 0
    print(f"profiler: {n_prof} eager steps, wall {prof_wall * 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e3 / (prof_wall * 1e3):.3f} of wall")
    print(f"{'device us/step':>15} {'share':>6} {'calls/step':>10}  kernel")
    for dt, count, key in sorted(rows, reverse=True)[:15]:
        print(f"{dt / n_prof:15.1f} {dt / busy_us:6.3f} "
              f"{count / n_prof:10.1f}  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
