#!/usr/bin/env python3
"""Where the flash forward's routes cross over, measured on the card.

    python3 tools/torch_flash_fwd_routes.py

Times each forward route that takes the call (``flash_attention``'s
``route=``: ``simt``, in bf16 ``tc``, and at Tq = 1 ``split``) as a
CUDA-graph replay (``chip_smoke.device_ms``) at H = 12, D = 64, in fp32
and bf16: the decode step (8 slots, Tq = 1 against a 512-key cache with
``cache_offset``, the fills drawn from the seed as
``chip_smoke.kernel_phase`` draws them) and a causal prompt (B = 1,
Tk = Tq) of 1 to 256 tokens, the serving buckets among them.
``flash_attention.flash_fwd_route`` follows these tables (PERF.md).
Needs a card.
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

TQS = (1, 2, 4, 8, 16, 24, 32, 64, 128, 256)


def _time(q, k, v, lens, kw):
    """{route: device ms} over the routes whose kernels take the call."""
    out = {}
    for route in fa._fwd_routes(q, k, v, None)[::-1]:
        out[route] = cs.device_ms(lambda: fa.flash_attention(
            q, k, v, lens, route=route, **kw))
    return out


def _row(label, times):
    best = min(times, key=times.get)
    print(f"{label}: " + " ".join(f"{r}={ms:.5f}" for r, ms in
                                  sorted(times.items())) + f" -> {best}",
          flush=True)


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
             _time(q, k, v, lens, dict(cache_offset=True)))
        for tq in TQS:
            q, k, v = (torch.randn(1, h, tq, d, device=dev, dtype=dtype)
                       for _ in range(3))
            _row(f"prefill {name} B1 Tq=Tk={tq}",
                 _time(q, k, v, None, dict(causal=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
