"""How many kernels ``torch.profiler`` reports for work whose launches are
known: one CUDA graph replay of five marked steps, and the same steps run
eagerly, each profiled with the window tight around the work (as
``chip_smoke._kernel_rows`` once did) and with idle margins
before and after it.

Each step runs ``--layers`` rounds of a 1024x1024 fp32 matmul and a
``tanh``, then one marker kernel of its own (add, mul, maximum, minimum,
atan2), so a lost step shows as a marker short. Per variant it prints
how many profiles lost kernels, which markers went, and the skew of the
first kernel's start against the start of the host call that launched it
(negative: the device's clock runs behind the host's in the trace).

    python3 tools/torch_profiler_window.py [--reps 40] [--layers 200]

Needs a card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

MARKERS = ("add", "mul", "maximum", "minimum", "atan2")


def card_name():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def make_steps(layers):
    a = torch.randn(1024, 1024, device="cuda")
    ops = [getattr(torch, m) for m in MARKERS]

    def run():
        x = a
        for op in ops:
            for _ in range(layers):
                x = torch.tanh(x @ a)
            x = op(x, a)
        return x

    return run


def profiled(fn, margin_s):
    """(kernels by name, skew in us, wall ms) of ``fn`` under the
    profiler, with ``margin_s`` of idle host time on each side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if margin_s:
            time.sleep(margin_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if margin_s:
            time.sleep(margin_s)
    counts, first_kernel, first_launch = {}, None, None
    for e in prof.events():
        start = e.time_range.start
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
            first_kernel = start if first_kernel is None \
                else min(first_kernel, start)
        elif e.name in ("cudaGraphLaunch", "cudaLaunchKernel",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            first_launch = start if first_launch is None \
                else min(first_launch, start)
    skew = None if first_kernel is None or first_launch is None \
        else first_kernel - first_launch
    return counts, skew, wall_ms


def marker_counts(counts):
    out = {}
    for m in MARKERS:
        out[m] = sum(v for k, v in counts.items()
                     if f"{m}" in k.lower() and "gemm" not in k.lower())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--layers", type=int, default=200)
    ap.add_argument("--margin-ms", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    print(card_name(), flush=True)
    run = make_steps(args.layers)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    torch.cuda.synchronize()

    # the full count, from an eager run with wide margins
    full, _, _ = profiled(run, 0.2)
    total = sum(full.values())
    want = marker_counts(full)
    print(f"kernels a run: {total}, markers {want}", flush=True)

    variants = {"graph tight": (graph.replay, 0.0),
                "graph margins": (graph.replay, args.margin_ms / 1e3),
                "eager tight": (run, 0.0),
                "eager margins": (run, args.margin_ms / 1e3)}
    res = {v: {"short": 0, "lost": [], "skews": [], "wall": []}
           for v in variants}
    for _ in range(args.reps):
        for name, (fn, margin) in variants.items():
            counts, skew, wall = profiled(fn, margin)
            got = sum(counts.values())
            r = res[name]
            r["skews"].append(skew)
            r["wall"].append(wall)
            if got != total:
                r["short"] += 1
                m = marker_counts(counts)
                r["lost"].append({"kernels": total - got,
                                  "markers": {k: want[k] - m[k] for k in m
                                              if m[k] != want[k]}})
    for name, r in res.items():
        sk = [s for s in r["skews"] if s is not None] or [float("nan")]
        print(f"{name}: {r['short']} of {args.reps} profiles lost kernels "
              f"{r['lost'][:6]}; first kernel minus first launch call "
              f"min {min(sk):.1f} us, max {max(sk):.1f} us; wall median "
              f"{sorted(r['wall'])[len(r['wall']) // 2]:.2f} ms",
              flush=True)
    print(json.dumps({n: {"short": r["short"], "reps": args.reps}
                      for n, r in res.items()}))


if __name__ == "__main__":
    main()
