#!/usr/bin/env python3
"""Time K7's ``softmax_ce_fwd`` and ``scale`` of this checkout on the card.

    python3 tools/torch_rtc_times.py [--seed 0] [--reps 3]

Calls the wrappers of ``ops/rtc_kernels.py`` (``scale(x, factor)``,
``softmax_ce_fwd(x, y, req)``) at the imperative path's shapes and
beside them: ``softmax_ce_fwd`` at (2048, 50257) with req "write" and
"add" and at (256, 100003); ``scale`` over 163,037,184 floats. Each is
timed ``--reps`` times in turns with its library call (``torch.softmax``,
``torch.mul``) as ``chip_smoke.device_ms`` times it (CUDA-graph replay,
inputs warm in L2), and each time is printed with its byte bound (each
input read once, each output written once, at 3.35 TB/s). Prints one
JSON line. Runs against the package beside it, so a copy in another
checkout (a ``git archive`` of the parent under ``build/``) times that
one in the same call. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOFTMAX = (((2048, 50257), "write"), ((2048, 50257), "add"),
           ((256, 100003), "write"))
SCALE_N = 163_037_184


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rtc_times: no CUDA device", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"tree": str(ROOT), "card": cs.card_line(), "cases": {}}

    def record(case, nbytes, kernel, library):
        ks, ls = [], []
        for _ in range(args.reps):
            ks.append(cs.device_ms(kernel))
            if library is not None:
                ls.append(cs.device_ms(library))
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        out["cases"][case] = dict(ms=ks, library_ms=ls or None,
                                  bound_ms=bound)
        lib = (" library " + " ".join(f"{v:.5f}" for v in ls)) if ls else ""
        print(f"{case}: kernel {' '.join(f'{v:.5f}' for v in ks)}{lib} "
              f"bound {bound:.5f} ms", flush=True)

    for shape, req in SOFTMAX:
        x = NDArray(4 * torch.randn(shape, generator=gen, device=dev))
        y = NDArray(torch.zeros(shape, device=dev))
        n = x.size
        record(f"softmax_ce_fwd_{req}_{shape[0]}x{shape[1]}",
               (2 if req == "write" else 3) * n * 4,
               lambda: rk.softmax_ce_fwd(x, y, req),
               (lambda: torch.softmax(x.as_torch(), -1))
               if req == "write" else None)
        del x, y
    x = NDArray(torch.randn(SCALE_N, generator=gen, device=dev))
    record(f"scale_{SCALE_N}", 2 * SCALE_N * 4, lambda: rk.scale(x, 0.5),
           lambda: torch.mul(x.as_torch(), 0.5))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
