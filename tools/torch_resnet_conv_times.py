#!/usr/bin/env python3
"""Device time of the fused conv kernels by conv shape of ResNet-50.

    python3 tools/torch_resnet_conv_times.py [--batch 128] [--dtype bf16]

Reads the 52 fused convs of ``fused_resnet50_v1`` at 224x224 off the
model's own bottlenecks (shape, stride, and what its prologue holds: none,
the BatchNorm, or the residual join with its emitted activation), and for
each distinct one times K1 (``fused_conv``), K2 (``conv_bwd_dx``) and K3
(``conv_bwd_dw``) on the routes the rule takes (CUDA-graph replay,
``chip_smoke.device_ms``), each of them on the SIMT kernel by name where
the rule takes another (``K1 simt``, ``K2 simt``, ``K3 simt``), and
cuDNN's forward (``F.conv2d`` on channels-last tensors), input gradient
and weight gradient (``aten.convolution_backward`` with the input's or
the weight's mask), timed only, on random inputs made as ``chip_smoke.py``
makes its conv cases. Prints one row per shape with its count in the net
and each kernel's time, and the sums over the 52 convs: a forward's and a
backward's kernel time split by shape. Needs a card.
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

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def resnet50_convs():
    """[(h, ci, co, k, stride, pad, kind)] of the 52 fused convs in the
    order a forward runs them; kind "plain", "pro" or "res" (join+emit)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedBottleneckV1, fused_resnet50_v1)

    net = fused_resnet50_v1()
    convs, h, first = [], 56, True
    for blk in net.modules():
        if not isinstance(blk, FusedBottleneckV1):
            continue
        s = blk._stride
        w1, w2, w3 = (tuple(getattr(blk, f"conv{i}_weight").shape)
                      for i in (1, 2, 3))
        convs += [(h, w1[2], w1[3], 1, 1, 0, "plain" if first else "res"),
                  (h, w2[2], w2[3], 3, s, 1, "pro"),
                  (h // s, w3[2], w3[3], 1, 1, 0, "pro")]
        if blk.bnd is not None:
            wd = tuple(blk.convd_weight.shape)
            convs.append((h, wd[2], wd[3], 1, s, 0, "plain"))
        h //= s
        first = False
    return convs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resnet_conv_times: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    dtype, dev = DTYPES[args.dtype], torch.device("cuda", 0)
    convs = resnet50_convs()
    assert len(convs) == 52
    counts = {}
    for c in convs:
        counts[c] = counts.get(c, 0) + 1
    print(cs.card_line(), flush=True)
    print(f"fused convs of fused_resnet50_v1, B={args.batch}, "
          f"{args.dtype}: ms per call (device, CUDA graph) and x count",
          flush=True)
    totals = dict(fwd=0.0, dx=0.0, dw=0.0, fwd_simt=0.0, dx_simt=0.0,
                  dw_simt=0.0, cudnn=0.0, cudnn_dx=0.0, cudnn_dw=0.0)
    for (h, ci, co, k, s, p, kind), count in counts.items():
        name = f"{k}x{k}{'/2' if s == 2 else ''} {ci}->{co} {h}^2 {kind}"
        case = (name, args.batch, h, h, ci, co, k, s, p, kind)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t = cs._conv_inputs(case, dtype, dev, gen)
        res = kind == "res"
        rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
        fargs = (t["x"], t["w"], t.get("a"), t.get("b"), s, p, True)
        y = fc.fused_conv(*fargs, emit=res, **rkw)[0]
        bargs = fargs[:4] + (y, t["dy"], t["ds"], t["dss"], s, p, True)
        x_cl = t["x"].permute(0, 3, 1, 2)
        dy_cl = t["dy"].permute(0, 3, 1, 2)
        w_cl = t["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        kernels = {
            "fwd": ("fused_conv", lambda route=None: fc.fused_conv(
                *fargs, emit=res, route=route, **rkw)),
            "dx": ("conv_bwd_dx", lambda route=None: fc.conv_bwd_dx(
                *bargs, g=t.get("g"), route=route, **rkw)),
            "dw": ("conv_bwd_dw", lambda route=None: fc.conv_bwd_dw(
                *bargs, route=route, **rkw))}
        routes = {key: fc.conv_route(dtype, ci, co, kern)
                  for key, (kern, _) in kernels.items()}
        conv_args = ([s] * 2, [p] * 2, [1, 1], False, [0, 0], 1)
        ms = dict(
            cudnn=cs.device_ms(lambda: F.conv2d(x_cl, w_cl, stride=s,
                                                padding=p)),
            cudnn_dx=cs.device_ms(
                lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [True, False, False])),
            cudnn_dw=cs.device_ms(
                lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [False, True, False])))
        for key, (_, call) in kernels.items():
            ms[key] = cs.device_ms(call)
            ms[key + "_simt"] = ms[key] if routes[key] == "simt" else \
                cs.device_ms(lambda: call("simt"))
        for key in totals:
            totals[key] += count * ms[key]
        print(f"  {name:28s} x{count:<2d} routes K1/K2/K3 "
              f"{'/'.join(routes.values())}: K1 {ms['fwd']:.5f}  K2 "
              f"{ms['dx']:.5f}  K3 {ms['dw']:.5f}  K1 simt "
              f"{ms['fwd_simt']:.5f}  K2 simt {ms['dx_simt']:.5f}  K3 simt "
              f"{ms['dw_simt']:.5f}  cuDNN fwd {ms['cudnn']:.5f}  cuDNN dx "
              f"{ms['cudnn_dx']:.5f}  cuDNN dw {ms['cudnn_dw']:.5f}",
              flush=True)
        del t, y
        gc.collect()
    print(f"sum over the 52 convs (ms per pass): K1 {totals['fwd']:.3f}, "
          f"K2 {totals['dx']:.3f}, K3 {totals['dw']:.3f}, K1 simt "
          f"{totals['fwd_simt']:.3f}, K2 simt {totals['dx_simt']:.3f}, K3 "
          f"simt {totals['dw_simt']:.3f}, cuDNN forward "
          f"{totals['cudnn']:.3f}, cuDNN dx {totals['cudnn_dx']:.3f}, cuDNN "
          f"dw {totals['cudnn_dw']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
