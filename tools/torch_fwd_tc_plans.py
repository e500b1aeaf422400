#!/usr/bin/env python3
"""The tensor-core forward (K1) under each plan of columns and K splits.

    python3 tools/torch_fwd_tc_plans.py

``ops/fused_conv.py`` plans a tensor-core K1 launch with two plain
functions of the shape: ``fwd_tc_cols`` (64 or 128 output channels a
block) and ``fwd_tc_splits`` (how many ranges of whole steps K is cut
into). This script times K1 (CUDA-graph replay, ``chip_smoke.device_ms``)
at ResNet-50 shapes where the choice is open, once per plan, with the two
functions replaced for the call, and checks each plan's outputs against
``fused_conv_reference`` (max abs error over max(1, max|plain|) within
2e-2, bf16). The rule's own plan is marked ``*``. Needs a card.
"""

from __future__ import annotations

import gc
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (name, n, h, w, ci, co, k, stride, pad, kind), [(cols, splits), ...]
CASES = [
    (("1x1_64to256_56_pro", 32, 56, 56, 64, 256, 1, 1, 0, "pro"),
     [(64, 1), (128, 1)]),
    (("1x1_256to128_56_join", 32, 56, 56, 256, 128, 1, 1, 0, "res"),
     [(64, 1), (128, 1)]),
    (("3x3_s2_128_56to28_pro", 32, 56, 56, 128, 128, 3, 2, 1, "pro"),
     [(64, 1), (128, 1)]),
    (("1x1_s2_512to1024_28to14_plain", 32, 28, 28, 512, 1024, 1, 2, 0,
      "plain"), [(64, 1), (128, 1)]),
    (("3x3_s2_512_14to7_pro", 32, 14, 14, 512, 512, 3, 2, 1, "pro"),
     [(64, 1), (128, 1)]),
    (("3x3_s2_512_14to7_pro_B128", 128, 14, 14, 512, 512, 3, 2, 1, "pro"),
     [(64, 1), (128, 1)]),
    (("1x1_512to2048_7_pro", 32, 7, 7, 512, 2048, 1, 1, 0, "pro"),
     [(64, 1), (128, 1)]),
    (("1x1_2048to512_7_join", 32, 7, 7, 2048, 512, 1, 1, 0, "res"),
     [(64, 1), (128, 1), (64, 2), (128, 2)]),
    (("3x3_512_7_pro", 32, 7, 7, 512, 512, 3, 1, 1, "pro"),
     [(64, 1), (64, 2)]),
    (("3x3_512_7_pro_B8", 8, 7, 7, 512, 512, 3, 1, 1, "pro"),
     [(64, 1), (64, 4)]),
    (("1x1_2048to512_7_join_B8", 8, 7, 7, 2048, 512, 1, 1, 0, "res"),
     [(128, 1), (128, 8), (64, 4)]),
    (("1x1_1024to256_14_join_B8", 8, 14, 14, 1024, 256, 1, 1, 0, "res"),
     [(128, 1), (128, 4)]),
    (("3x3_256_14_pro_B8", 8, 14, 14, 256, 256, 3, 1, 1, "pro"),
     [(64, 1), (64, 2)]),
    (("5x5_s2_24to40_15_res_emit", 32, 15, 15, 24, 40, 5, 2, 2, "res"),
     [(64, 1), (64, 5)]),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fwd_tc_plans: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    rule_cols, rule_splits = fc.fwd_tc_cols, fc.fwd_tc_splits
    for case, plans in CASES:
        n, h, w, ci, co, k, s, p, kind, ho, wo = cs._conv_dims(case)
        taps = fc.dw_tc_taps(k, s, wo, kind == "res")
        cols = rule_cols(co, taps)
        rule = (cols, rule_splits(n, ho, wo, ci, co, k, k, taps, cols))
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        t = cs._conv_inputs(case, torch.bfloat16, dev, gen)
        res = kind == "res"
        rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
        fargs = (t["x"], t["w"], t.get("a"), t.get("b"), s, p, True)
        want = fc.fused_conv_reference(*fargs, emit=res, **rkw)
        out = []
        for plan in plans if rule in plans else [rule] + plans:
            fc.fwd_tc_cols = lambda *a, c=plan[0], **kw: c
            fc.fwd_tc_splits = lambda *a, z=plan[1], **kw: z
            try:
                got = fc.fused_conv(*fargs, emit=res, **rkw)
                torch.cuda.synchronize()
                _, rel = cs._conv_errs(("y", "sum", "sumsq", "emitted"),
                                       got, want, torch.bfloat16)
                ms = cs.device_ms(lambda: fc.fused_conv(*fargs, emit=res,
                                                        **rkw))
            finally:
                fc.fwd_tc_cols, fc.fwd_tc_splits = rule_cols, rule_splits
            out.append(f"{'*' if plan == rule else ''}cols {plan[0]} "
                       f"splits {plan[1]}: {ms:.5f} ms ({rel:.1e})")
        print(f"{case[0]} (B={n}, {k * (k // taps) * -(-ci // 64)} steps): "
              + "; ".join(out), flush=True)
        del t, want
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
