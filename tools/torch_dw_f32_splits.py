#!/usr/bin/env python3
"""The fp32 weight-gradient kernel (the f32 K3) under each count of pixel
ranges, and with one tap or a row of three taps a block.

    python3 tools/torch_dw_f32_splits.py [--batch 32]

``ops/fused_conv.py`` cuts the output pixels of an f32 K3 launch into
``dw_splits(..., "f32", taps)`` ranges of whole boxes, one grid plane
each, and adds the ranges' fp32 planes in order; at stride 1 a 3x3
kernel's block takes its row of 3 taps (``dw_tc_taps``). This script
times the f32 K3 (CUDA-graph replay, ``chip_smoke.device_ms``) at each
distinct conv shape of ResNet-50 (``tools/torch_resnet_conv_times.py``'s
list) under a few counts around the rule's, with ``dw_splits`` replaced
for the call, and where the rule takes a row of taps also with one tap a
block (``dw_tc_taps`` replaced), beside the SIMT K3 on the same inputs,
and checks each plan's dW against ``conv_bwd_dw_reference`` (relative L2
within 1e-4). The rule's own plan is marked ``*``. Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torch_resnet_conv_times import resnet50_convs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dw_f32_splits: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda", 0)
    rule, rule_taps = fc.dw_splits, fc.dw_tc_taps
    print(cs.card_line(), flush=True)
    for h, ci, co, k, s, p, kind in dict.fromkeys(resnet50_convs()):
        name = f"{k}x{k}{'/2' if s == 2 else ''} {ci}->{co} {h}^2 {kind}"
        case = (name, args.batch, h, h, ci, co, k, s, p, kind)
        ho = wo = (h + 2 * p - k) // s + 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t = cs._conv_inputs(case, torch.float32, dev, gen)
        rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
        fargs = (t["x"], t["w"], t.get("a"), t.get("b"), s, p, True)
        y = fc.fused_conv_reference(*fargs, **rkw)[0]
        bargs = fargs[:4] + (y, t["dy"], t["ds"], t["dss"], s, p, True)
        ref = fc.conv_bwd_dw_reference(*bargs, **rkw)
        taps_rule = rule_taps(k, s, wo, kind == "res")
        for taps in sorted({taps_rule, 1}, reverse=True):
            box = fc.dw_tc_box(args.batch, ho, wo, k, taps)
            boxes = fc._boxes(args.batch, ho, wo, box)
            tiles = k * (k // taps) * -(-ci // 64) * -(-co // 64)
            want = rule(args.batch, ho, wo, ci, co, k, k, "f32", taps)
            counts = sorted({c for c in (1, 2, 3, 4, want // 2, want,
                                         2 * want) if 1 <= c <= boxes})
            cells = []
            for count in counts:
                fc.dw_splits = lambda *a, count=count: count
                fc.dw_tc_taps = lambda *a, taps=taps: taps
                try:
                    got = fc.conv_bwd_dw(*bargs, **rkw)
                    l2 = ((got - ref).norm() / ref.norm()).item()
                    if not l2 <= 1e-4:
                        raise AssertionError(f"{name} taps {taps} splits "
                                             f"{count}: relative L2 {l2}")
                    ms = cs.device_ms(lambda: fc.conv_bwd_dw(*bargs, **rkw))
                finally:
                    fc.dw_splits, fc.dw_tc_taps = rule, rule_taps
                mark = "*" if count == want and taps == taps_rule else ""
                cells.append(f"{count}{mark} ({tiles * count} blocks) "
                             f"{ms:.5f}")
            print(f"  {name:28s} {taps} tap(s) a block, {tiles} tiles, "
                  f"{boxes} boxes: f32 K3 ms by ranges: {'  '.join(cells)}",
                  flush=True)
        simt = cs.device_ms(lambda: fc.conv_bwd_dw(*bargs, route="simt",
                                                   **rkw))
        print(f"  {name:28s} SIMT K3 {simt:.5f} ms", flush=True)
        del t, y, ref
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
