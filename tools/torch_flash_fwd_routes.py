#!/usr/bin/env python3
"""Where the flash forward's routes cross over, measured on the card.

    python3 tools/torch_flash_fwd_routes.py

Times each forward route that takes the call (``flash_attention``'s
``route=``: ``simt``, in bf16 ``tc``, in fp32 from two query rows
``f32``, and at Tq = 1 ``split``) as CUDA-graph replays
(``chip_smoke.device_ms``), twice in turns (the routes, then the routes
reversed; the line shows both and picks the better of each route's
best), at H = 12, D = 64, in fp32 and bf16: the decode step (8 slots, Tq
= 1 against a 512-key cache with ``cache_offset``, the fills drawn from
the seed as ``chip_smoke.kernel_phase`` draws them) and a causal prompt
(B = 1, Tk = Tq) of 1 to 256 tokens, the serving buckets among them;
then, in fp32, causal calls of 2 to 64 query rows at B = 1 to 64 (12 to
768 heads: the grid of 64-row tiles from a tenth of the SMs to several
waves), which says whether the crossover moves with the grid.
``flash_attention.flash_fwd_route`` follows these tables
(``FWD_F32_MIN_TQ``; PERF.md). Needs a card.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402

TQS = (1, 2, 4, 8, 16, 24, 32, 40, 48, 64, 128, 256)
#: the fp32 batch sweep: batches, and query rows around the crossover
GRID_BS = (1, 2, 4, 8, 16, 32, 64)
GRID_TQS = (2, 8, 16, 24, 32, 40, 64)


def _time(q, k, v, lens, kw):
    """{route: [device ms, device ms]} over the routes whose kernels take
    the call, timed in turns."""
    routes = fa._fwd_routes(q, k, v, None)[::-1]
    out = {r: [] for r in routes}
    for route in routes + routes[::-1]:
        out[route].append(cs.device_ms(lambda: fa.flash_attention(
            q, k, v, lens, route=route, **kw)))
    return out


def _row(label, times, rule):
    best = min(times, key=lambda r: min(times[r]))
    print(f"{label}: " + " ".join(
        f"{r}=" + "/".join(f"{ms:.5f}" for ms in t)
        for r, t in sorted(times.items())) + f" -> {best} (the rule: "
        f"{rule})", flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("torch_flash_fwd_routes: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    rs = np.random.RandomState(0)
    lens = torch.tensor(np.sort(rs.randint(1, 513, size=8)).astype(np.int32),
                        device=dev)
    h, d = 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        name = cs.DTYPE_NAMES[dtype]
        q = torch.randn(8, h, 1, d, device=dev, dtype=dtype)
        k, v = (torch.randn(8, h, 512, d, device=dev, dtype=dtype)
                for _ in range(2))
        _row(f"decode {name} S8 Tk512 Tq=1",
             _time(q, k, v, lens, dict(cache_offset=True)),
             fa.flash_fwd_route(q, k, v))
        for tq in TQS:
            q, k, v = (torch.randn(1, h, tq, d, device=dev, dtype=dtype)
                       for _ in range(3))
            _row(f"prefill {name} B1 Tq=Tk={tq}",
                 _time(q, k, v, None, dict(causal=True)),
                 fa.flash_fwd_route(q, k, v))
    for b in GRID_BS:
        for tq in GRID_TQS:
            q, k, v = (torch.randn(b, h, tq, d, device=dev)
                       for _ in range(3))
            _row(f"batch fp32 B{b} Tq=Tk={tq} ({b * h} heads)",
                 _time(q, k, v, None, dict(causal=True)),
                 fa.flash_fwd_route(q, k, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
