#!/usr/bin/env python3
"""Where a live weight publish's latency goes under load.

    python3 tools/torch_swap_stalls.py [--seed 0] [--rate 400] [--seconds 2]
        [--variants side,serving,nogc,predigest]

Serves ``fused_resnet50_v1`` in fp32 (1000 classes, 224x224, buckets 1-32,
weights from ``--seed``) through ``serving.ModelServer`` and drives
``chip_smoke.open_loop`` (Poisson) at ``--rate`` requests/s for
``--seconds``: once with no publish, then once a variant with version 1
(``--seed + 1``) published at 40% of the run. The variants of the staging:

* ``side``: as the port does it (the staging's copies on a stream of
  their own, the live version digested in the publish);
* ``serving``: the staging's copies on the serving stream;
* ``nogc``: as ``side``, Python's cyclic collector off during the publish;
* ``predigest``: as ``side``, the live version's digests already taken (a
  second publish's case).

Each variant starts from version 0 again (published back with no
traffic). For each run: p50/p99 ms of the requests submitted in the
publish window (its start to 0.25 s after it returned) and of the rest,
the longest batch (the cache call's wall ms) and the longest gap between
two batches while requests waited, the publish's seconds, its staging
seconds and the commit's ms; the card's name and power limit. Prints one
line a run and a JSON line of them all. Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _run(srv, images, rate, seconds, seed, publish=None):
    """One open-loop run through ``srv``; ``publish()`` (if given) runs on
    another thread at 40% of it and returns its window ``(t0, t1)``."""
    cache, calls, reqs, win = srv._cache, [], [], {}

    def logged(batch):
        t0 = time.perf_counter()
        out = cache(batch)
        calls.append((t0, time.perf_counter()))
        return out

    def fire(i):
        t = time.perf_counter()
        fut = srv.submit(images[i % len(images)])
        req = [t, None]
        reqs.append(req)
        fut.add_done_callback(
            lambda f, r=req: r.__setitem__(1, time.perf_counter()))
        return fut

    def publisher():
        time.sleep(0.4 * seconds)
        win["t"] = publish()

    srv._batcher._runner = logged
    try:
        t = threading.Thread(target=publisher) if publish else None
        if t is not None:
            t.start()
        res = cs.open_loop(fire, rate, seconds, seed=seed)
        if t is not None:
            t.join(60)
    finally:
        srv._batcher._runner = cache
    if res["errors"] or res["rejected"]:
        raise AssertionError(f"run failed: {res}")
    t0, t1 = win.get("t", (float("inf"), float("inf")))
    inside = [d - s for s, d in reqs if t0 <= s <= t1 + 0.25]
    outside = [d - s for s, d in reqs if not t0 <= s <= t1 + 0.25]
    longest = max((e - s for s, e in calls), default=0.0)
    # a gap counts while a request waited: one was submitted before the
    # next batch began and was not yet answered when the last one ended
    gaps = [b[0] - a[1] for a, b in zip(calls, calls[1:])
            if any(s < b[0] and d > a[1] for s, d in reqs)]
    return dict(requests=len(reqs), window_requests=len(inside),
                window_p50_ms=cs._pctl_ms(inside, 50),
                window_p99_ms=cs._pctl_ms(inside, 99),
                rest_p50_ms=cs._pctl_ms(outside, 50),
                rest_p99_ms=cs._pctl_ms(outside, 99),
                longest_batch_ms=longest * 1e3,
                longest_gap_ms=max(gaps, default=0.0) * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=400.0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", default="side,serving,nogc,predigest")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_swap_stalls: needs a CUDA card", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving import executor_cache as ec

    card = cs.card_line()
    print(card, flush=True)
    ctx = mx.gpu(0)
    make = cs._fused_resnet_maker(ctx)
    net = make(args.seed)
    v0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    v1 = {n: p.detach() for n, p in make(args.seed + 1).named_parameters()}
    images = np.random.RandomState(args.seed + 61).rand(
        64, 3, 224, 224).astype(np.float32)
    srv = serving.ModelServer(net, max_wait_ms=2.0, max_queue=128, ctx=ctx,
                              artifact_dir="", name="swap_stalls")
    srv.warmup((3, 224, 224), "float32")
    cache = srv._cache
    side = ec._staging_stream
    out = {"card": card,
           "base": _run(srv, images, args.rate, args.seconds, args.seed)}
    print(f"no publish: {out['base']}", flush=True)
    for name in args.variants.split(","):
        srv.publish_weights(v0)                        # back to version 0
        if name != "predigest":
            cache._digests = None
        stage = {}

        def publish():
            t0 = time.perf_counter()
            if name == "nogc":
                gc.disable()
            if name == "serving":
                ec._staging_stream = torch.cuda.current_stream
            real = cache.stage_params

            def timed(*a, **k):
                s0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    stage["s"] = time.perf_counter() - s0

            cache.stage_params = timed
            try:
                stats = srv.publish_weights(v1)
            finally:
                del cache.stage_params
                ec._staging_stream = side
                gc.enable()
            stage.update(stats)
            return t0, time.perf_counter()

        row = _run(srv, images, args.rate, args.seconds, args.seed, publish)
        row.update(publish_s=stage["seconds"], stage_s=stage["s"],
                   commit_ms=cache.last_commit_ms, updated=stage["updated"])
        out[name] = row
        print(f"{name} ({card}): {row}", flush=True)
    srv.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
