#!/usr/bin/env python3
"""Prove the PyTorch port builds, is right, serves and trains on one card.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together), print ``tools/torch_ptxas_report.py
   fused_conv_tc conv_bwd_tc flash_fwd_tc flash_bwd_tc flash_bwd_f32
   flash_fwd_f32 conv_bwd_f32`` (registers, spills, and the HGMMA and
   UTMALDG instructions in the SASS of the bf16 tensor-core K1/K2/K3 and
   K4/K5/K6: both must be there; the fp32 K5/K6 of ``flash_bwd_f32``, K4
   of ``flash_fwd_f32`` and K2 of ``conv_bwd_f32`` run on the FP32 pipes
   and load by TMA: UTMALDG and no HGMMA; no kernel spills), and compile
   the rtc kernels of ``csrc/rtc/`` with NVRTC;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it, in fp32 and bf16
   (TF32 off), with its device time (CUDA-graph replay, inputs warm in L2),
   its time as an eager call (host work included), the plain version's and
   one PyTorch library call's device time (timed here only, never used by
   the port) and the least time the card could take for the same work.
   The forward kernel (K4) first, on its own cases, one on the GPT's own
   operands (views of one fused QKV projection) and ``BWD_CASES``; each
   row names its route (``flash_attention.flash_fwd_route``): a decode
   step (Tq = 1) must take the split kernels
   (``csrc/flash_fwd_split.cu``), the other bf16 rows the tensor-core
   kernel (``csrc/flash_fwd_tc.cu``), the other fp32 rows from
   ``FWD_F32_MIN_TQ`` query rows the register micro-tile kernel
   (``csrc/flash_fwd_f32.cu``, its output and lse bit-equal to a second
   launch's), the rest the SIMT kernel (``csrc/flash_fwd.cu``); a row not
   on the SIMT route also runs the SIMT kernel on the same inputs, holds
   it against the plain version as well and times it (``simt_ms``, and a
   SIMT row of its own), and causal square rows time SDPA with
   ``is_causal`` beside its boolean mask. Then the two
   backward kernels (K5 dq, K6 dk/dv) on ``BWD_CASES``; each backward row
   names its route (``flash_attention.flash_bwd_route``): every bf16 row
   must take the tensor-core kernels (``csrc/flash_bwd_tc.cu``), every
   fp32 row the register micro-tile kernels (``csrc/flash_bwd_f32.cu``,
   each output bit-equal to a second launch's); each row also runs the
   SIMT kernels (``csrc/flash_bwd.cu``) on the same inputs, holds them to
   the same tolerance and times them (``simt_ms``);
4. serving phase: greedy KV-cache decode of ``gpt_decoder_117m`` (12
   layers, 768 units, 12 heads, vocab 50257; weights drawn from ``--seed``)
   through ``serving.DecodeSession`` with 8 slots and a 512-token cache, 12
   prompts of 5 to 250 tokens, 32 new tokens each. Three streams are held
   token for token against the full-forward greedy oracle (``net(tokens)``
   re-run per token), and K4's launch count shows the path went through it:
   every decode step on the split route, every prefill on the route of its
   bucket's length (``decode_routes``: f32 from ``FWD_F32_MIN_TQ`` rows,
   SIMT below). The decode step is one captured CUDA graph (its capture
   records 12 split-route launches, which each replay counts);
   ``decode_step_times`` then holds the graph's next tokens against the
   same step run eagerly, times both (host ms and device time a step),
   and checks the split kernels' launches a step as the graph steps
   counted them and as the profiler saw them;
5. training phase: ``gpt_decoder_117m`` with ``max_length`` 256 and
   dropout 0 at B=8, T=256: the fp32 gradient of every parameter through
   the kernels against the same model with its attention swapped for the
   autograd of the plain versions (the swap is made here, for this oracle
   only); a learning check (fp32 ``SPMDTrainer``, the loss on one repeated
   batch falls over 10 steps); train -> decode (the trained weights served
   through ``DecodeSession`` and held against the full-forward oracle); two
   eager ``gluon.Trainer`` steps; the bf16 gradient gate (the net cast to
   bf16: one step's gradients through the tensor-core K5/K6 against the
   same step with ``flash_attention_bwd`` swapped for its plain version,
   ``gpt_bf16_gate``); the bench row (``SPMDTrainer`` SGD lr 1e-4
   momentum 0.9), timed; and a ``torch.profiler`` breakdown of one bf16
   step. K4, K5 and K6 each launch exactly 12 times per training pass
   (counted over the training steps alone; train -> decode and the bf16
   gate are counted on their own), K4, K5 and K6 of every fp32 pass on
   the f32 route, of every bf16 pass on the tensor-core route;
6. conv kernel phase: the fused conv + BatchNorm kernels (K1 forward, K2
   input gradient, K3 weight gradient) against their plain versions in
   fp32 and bf16 at ResNet-50's shapes at B=32 and one shape off the
   model's path, with the same timings; the library call is cuDNN
   (``F.conv2d`` on channels-last tensors, and
   ``aten.convolution_backward`` for the input and the weight gradient).
   Each row names its route (``fused_conv.conv_route``): every bf16 row
   must take the tensor-core kernels (``csrc/fused_conv_tc.cu``,
   ``csrc/conv_bwd_tc.cu``), every fp32 row (widths multiples of 4) the
   register micro-tile kernels (``csrc/fused_conv_f32.cu``,
   ``csrc/conv_bwd_f32.cu``, their outputs bit-equal to a second
   launch's, and K1's to the SIMT K1's); a row not on the SIMT route also
   times the SIMT kernel
   (``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``) on the same inputs
   (``simt_ms``; in fp32 also held to the plain version, a SIMT row of its
   own). At the head case the
   tensor-core K1's per-channel sums and sums of squares lie within
   ``K1_SUMS_RTOL`` (relative L2) of an fp64 evaluation on the same bf16
   inputs (``k1_sums_fp64``);
7. ResNet phase: ``fused_resnet50_v1`` (1000 classes, 224x224 inputs,
   weights drawn from ``--seed``): the fp32 oracle of one training step at
   B=8 (loss and the 106 running statistics against the model with
   ``fused_conv_bn`` swapped for the autograd of its plain versions; the
   gradients of all 161 trainable tensors against the plain backward run
   on K1's forward values, see ``resnet_oracle``); the bf16 forward gate
   at the net as drawn (cast to bf16 for it and restored after: one
   training-mode forward at B=8 through the tensor-core K1 and through the
   SIMT K1, each against an fp32 forward (the f32 K1) on the same
   bf16-rounded weights and input, the tensor-core one no farther,
   ``resnet_bf16_forward_gate``); a learning check (fp32
   ``SPMDTrainer``, SGD, one repeated batch); two eager ``gluon.Trainer``
   steps; eval logits at B=32, with the running statistics set to that
   batch's, against the plain swap and the training-mode forward; then,
   the net cast to bf16, the bf16 gradient gate (one step at B=8, the 161
   gradients through the tensor-core K2/K3 against their plain versions
   on K1's forward, ``resnet_bf16_gate``), a bf16 learning check, and the
   bench row
   (B=128, ``SPMDTrainer`` SGD lr 0.1 momentum 0.9), timed, with a
   ``torch.profiler`` breakdown of one step. K1 launches exactly 52 times
   per forward, K2 and K3 52 times per backward: in every fp32 pass (the
   oracle, the forward gate's fp32 forward, the learning check, the eager
   steps, eval) on the f32 route, every bf16 one on the tensor-core
   route;
8. unfused ResNet phase: ``get_model("resnet50_v1", classes=1000)``, the
   gluon layer set (NCHW, cuDNN and cuBLAS; no hand-written kernel:
   the JAX package leaves these convs to XLA), ``initialize("xavier")``
   and one forward that fills its deferred shapes; its inventory
   (25,610,152 values with the running statistics: 161 trainable tensors,
   106 running statistics, 53 convs); one fp32 training step at B=8
   against ``fused_resnet50_v1`` with the same weights (OIHW -> HWIO,
   ``zoo_to_fused``): the loss and the 106 running statistics within
   ``UNFUSED_TOL``, the 161 gradients within ``UNFUSED_GRAD_RTOL``
   relative L2, then the eval logits; an fp32 learning check through
   ``gluon.Trainer(..., kvstore="device")``; then bench.py's resnet50 row
   (bf16, B=128, ``SPMDTrainer`` SGD lr 0.1 momentum 0.9, 5 steps after
   2 warmup, a ``torch.profiler`` breakdown and the idle share), in NCHW
   and with the activations and conv weights in ``torch.channels_last``
   memory format. K1, K2 and K3 launch 0 times over every unfused pass;
9. MLP phase: bench.py's mlp row (``Dense(512, activation="relu")``
   twice and ``Dense(10)``, no ``in_units``; xavier, bf16, B=8192,
   ``SPMDTrainer`` SGD lr 0.1 momentum 0.9): the loss falls by 5% over
   20 steps on one batch, then the step is timed;
10. graph phase (``parallel/superstep.py``): the MLP row (K=20), the GPT
   bf16 row (``gpt_decoder_117m``, B=8, T=256, dropout 0.1 as built,
   K=10), the fused and the unfused (channels-last) ResNet-50 bf16 rows
   (B=128, K=5), each through ``SPMDTrainer.run_superstep`` over windows
   of K distinct batches drawn from ``--seed``: one window's [K] losses
   and every parameter and running statistic bit-equal to K eager
   ``step()`` calls from the same state and seed; the launch counters of
   the eager steps (GPT: 12 K4, K5 and K6 a step on the tensor cores;
   fused ResNet: 52 K1, K2 and K3 a pass; the others none), of the
   capture's recording (K steps) and of every graph call, measured around
   it (K steps a window, K + 1 for the first: its warm-up step ran), and
   the profiler's own count of each kernel's CUDA function in K eager
   steps and in a graph window (K a step: the kernels ran on the card);
   then host ms a step of the eager step beside the graph path (the
   median of alternating turns), device time and idle share
   (``torch.profiler``), peak memory, and the SM clock and power draw of
   each kind of turn (``nvidia-smi`` sampling, ``ClockSampler``)
   (``graph_row``); the gluon ``SuperStep`` on the MLP (sgd, momentum)
   against its eager path bit for bit; K3 and K1 captured on a thread
   that never ran an encode, bit-equal to the eager calls
   (``fresh_thread_capture``);
11. imperative phase (``mx.nd``, ``mx.operator``, ``mx.rtc``): the rtc
   kernels (K7, ``csrc/rtc/*.cu``, compiled by NVRTC in the build step)
   run an ``mx.rtc`` program (``scale`` and ``saxpy`` over 163,037,184
   floats, ``first_row`` of a (50257, 768) embedding) held bit for bit
   against their plain versions; then ``gpt_decoder_117m`` at
   ``max_length`` 256, B=8, fp32 trains imperatively: ``autograd.record``
   -> ``net(mx.nd.array(tokens))`` -> ``mx.nd.Custom(logits, labels,
   op_type="softmax_ce_rtc")`` (softmax forward and cross-entropy
   gradient backward, two runtime-compiled kernels) -> ``backward`` ->
   ``gluon.Trainer.step``: its 149 gradients against the plain loss's
   (``SoftmaxCrossEntropyLoss``, summed; relative L2 <= 1e-4), a learning
   check, the step's time and peak memory. softmax_ce_fwd/bwd launch once
   per step and K4-K6 12 times per pass, all three on the f32 route
   (counted over this main path alone). Then each rtc kernel
   against its plain version at the path's shapes (softmax_ce_fwd within
   1e-5 of each probability, relative; the
   rest bit for bit), timed (CUDA-graph replay) beside its plain version,
   a library call and its byte bound, ``first_row`` beside the graph
   replay of an empty kernel (the launch floor); K7's cases beside the
   path
   (``rtc_cases``: softmax_ce_fwd over rows longer than the resident limit,
   (256, 100003), and over (5, 7) and (3, 4099), each with its plan,
   resident or streamed, printed, and with req="add" at the path's shape;
   scale over 163,037,181 floats on views at offsets of 1 and 3 floats,
   into a new array and into a view at x's offset; saxpy over the same
   views, a at the offset with b and out aligned, and all three at the
   offset), held and timed the same way; and ``mx.nd.flash_attention`` and
   ``invoke_op("fused_conv_bn")`` with gradients, equal to the direct
   calls bit for bit.

The third line from the end (``rows: {...}``) gives the bench rows: the
fused and unfused ResNet-50 and the MLP, bf16, step ms and images/s, and
the graph phase's rows and the decode step, eager beside graph. The
line before the last is the kernels' JSON record (K1 to K7; K1 to K6
once per route, ``flash_fwd``/``fused_conv``/``conv_bwd_dx``/
``conv_bwd_dw``/``flash_bwd_dq``/``flash_bwd_dkv`` the SIMT kernels at the
fp32 head case, ``flash_fwd_f32``/``fused_conv_f32``/``conv_bwd_dx_f32``/
``conv_bwd_dw_f32``/``flash_bwd_dq_f32``/``flash_bwd_dkv_f32`` the fp32
micro-tile kernels there (a conv record also names its CUDA function,
``kernel``), ``flash_fwd_tc``/``fused_conv_tc``/
``conv_bwd_dx_tc``/``conv_bwd_dw_tc``/``flash_bwd_dq_tc``/
``flash_bwd_dkv_tc`` the tensor-core kernels at the bf16 head case,
``flash_fwd_split`` the split kernels at the fp32 decode case); the last
line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or run alone without
the repository beside it (the port does not import), the script exits 2
before printing any result.
"""

from __future__ import annotations

import argparse
import functools
import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the
# FLOP/s of the type the kernel's inputs come in.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fp32 training gradients, kernels vs plain versions: relative L2 error per
# parameter tensor (both fp32, TF32 off; only the order of sums differs)
GRAD_RTOL = 1e-3
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
# the routes of each conv kernel K1-K3: "tc" the bf16 tensor-core
# kernels, "f32" the fp32 register micro-tiles, "simt" the others (K4 has
# four, ``FWD_ROUTES``; K5/K6 three, ``BWD_ROUTES``)
CONV_ROUTES = {"fused_conv": ("tc", "f32", "simt"),
               "conv_bwd_dx": ("tc", "f32", "simt"),
               "conv_bwd_dw": ("tc", "f32", "simt")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters=50, warmup=5) -> float:
    """Mean time per call of ``fn`` called back to back, host overhead
    included (CUDA events on the current stream)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_side_stream = None


def device_ms(fn, per_graph=20, replays=10) -> float:
    """Mean device time per call of ``fn``: ``per_graph`` calls captured
    in one CUDA graph and replayed, so no host work sits between them.
    Inputs stay the same across calls, so they are warm in L2. One side
    stream serves every capture: PyTorch keeps a cuBLAS workspace per
    stream for the life of the process."""
    global _side_stream
    if _side_stream is None:
        _side_stream = torch.cuda.Stream()
    side = _side_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def _valid_mask(b, tq, tk, lengths, causal, cache_offset, device):
    """(B, 1, Tq, Tk) bool: which (query, key) pairs the call attends."""
    rows = torch.arange(tq, device=device).view(1, 1, tq, 1)
    cols = torch.arange(tk, device=device).view(1, 1, 1, tk)
    lens = torch.full((b,), tk, device=device) if lengths is None \
        else lengths.to(device).long()
    lens = lens.view(b, 1, 1, 1)
    valid = cols < lens
    if causal:
        off = (lens - tq) if cache_offset else (tk - tq)
        valid = valid & (cols <= rows + off)
    return valid


def attention_bound(b, h, tq, tk, d, dtype, valid, return_lse):
    """Least time (ms) for the call and what bounds it: each input byte
    read once and each output written once, with K/V counted only for the
    keys this data reaches; 4*D FLOPs per attended (query, key) pair."""
    esize = torch.tensor([], dtype=dtype).element_size()
    keys = valid.any(dim=2).sum().item()               # per batch, per key
    nbytes = (b * h * tq * d * 2 + keys * h * d * 2) * esize
    if return_lse:
        nbytes += b * h * tq * 4
    flops = 4.0 * d * h * valid.sum().item()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bwd_bound(kernel, b, h, tq, tk, d, dtype, valid):
    """Least time (ms) of one backward kernel and what bounds it. Inputs
    are read once where the data reaches them (query rows that attend a
    key: q, g and the fp32 lse and delta; keys some query attends: k, v),
    outputs written once in full (``dq``: dq; ``dkv``: dk and dv). FLOPs
    per attended (query, key) pair: 6*D for dq (s, dP, dS.K), 8*D for dk/dv
    (s, dP, P^T.dO, dS^T.Q)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    valid = valid.expand(b, 1, tq, tk)
    pairs = valid.sum().item() * h
    rows = valid.any(dim=3).sum().item() * h
    keys = valid.any(dim=2).sum().item() * h
    nbytes = (rows + keys) * d * 2 * esize + rows * 2 * 4
    if kernel == "dq":
        nbytes += b * h * tq * d * esize
        flops = 6.0 * d * pairs
    else:
        nbytes += 2 * b * h * tk * d * esize
        flops = 8.0 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# (name, b, tq, tk, d, causal, cache_offset, lengths, want_lse) of the
# forward's own cases, H = 12; lengths "decode" are drawn from the seed
FWD_CASES = [
    # prefill at the largest and the smallest bucket: B=1, causal
    ("prefill_causal_B1_T256", 1, 256, 256, 64, True, False, None, False),
    ("prefill_causal_B1_T16", 1, 16, 16, 64, True, False, None, False),
    # a decode step: 8 slots against the 512-token cache, ragged fill
    ("decode_cache_offset_S8_Tk512", 8, 1, 512, 64, True, True, "decode",
     False),
    # non-causal key lengths (one empty row set) with the lse output
    ("lengths_lse_B4_T128x384", 4, 128, 384, 64, False, False,
     (384, 200, 17, 0), True),
    # the training forward: B=8, T=256, causal, with the lse the backward
    # needs
    ("train_causal_lse_B8_T256", 8, 256, 256, 64, True, False, None, True),
]
# the training forward on the GPT's own operands: q, k, v views of one
# fused (B, T, 3, H, D) projection, o into a (B, T, H, D) buffer
GPT_VIEWS = "gpt_qkv_views_B8_T256"
FWD_HEAD = "train_causal_lse_B8_T256"
FWD_DECODE = "decode_cache_offset_S8_Tk512"
# the lse against the plain version's, absolute (-inf rows identical)
LSE_TOL = 1e-3
FWD_ROUTES = ("tc", "f32", "split", "simt")


def fwd_cases():
    """The forward's cases, the GPT-views case, then each of ``BWD_CASES``
    whose shape is not among them (with the lse): D=128, Tq=16 with cache
    offset, Tq > Tk."""
    cases = list(FWD_CASES)
    cases.append((GPT_VIEWS, *next(c for c in FWD_CASES
                                   if c[0] == FWD_HEAD)[1:]))
    seen = {c[1:8] for c in cases}
    cases += [(*c, True) for c in BWD_CASES if c[1:] not in seen]
    return cases


def fwd_route_expected(tq, d, dtype):
    """The route ``flash_fwd_route`` gives a call with aligned operands:
    one query row the split kernels; D 64 or 128 in bf16 the tensor-core
    kernel, in fp32 from ``FWD_F32_MIN_TQ`` query rows the f32 kernel;
    the rest SIMT."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    if tq == 1:
        return "split"
    if d in (64, 128) and dtype == torch.bfloat16:
        return "tc"
    if d in (64, 128) and tq >= fa.FWD_F32_MIN_TQ:
        return "f32"
    return "simt"


def _fwd_route_counts(fa):
    return {r: getattr(fa, f"flash_fwd_{r}_launches") for r in FWD_ROUTES}


def _check_fwd_route(label, before, now, expect):
    """One forward call since ``before``, on ``expect``."""
    taken = [r for r in FWD_ROUTES if now[r] - before[r] == 1]
    if taken != [expect] or sum(now.values()) - sum(before.values()) != 1:
        raise AssertionError(f"flash_fwd {label} took {taken}, not "
                             f"{expect}")


def _check_fwd_out(label, got, want, dtype):
    """(o's max abs err, the lse's) of a forward ``(o, lse)`` against the
    plain version's: o within ``TOLS``, the lse within ``LSE_TOL`` (fp32:
    ``TOLS``) with its -inf rows identical, and no NaN in either."""
    if torch.isnan(got[0]).any() or torch.isnan(got[1]).any():
        raise AssertionError(f"flash_fwd {label}: NaN")
    err = (got[0].float() - want[0].float()).abs().max().item()
    g_inf, w_inf = torch.isinf(got[1]), torch.isinf(want[1])
    if not torch.equal(g_inf, w_inf):
        raise AssertionError(f"flash_fwd {label}: lse -inf rows differ")
    fin = ~w_inf
    lse_err = (got[1][fin] - want[1][fin]).abs().max().item() \
        if fin.any() else 0.0
    tol = TOLS[dtype]
    lse_tol = min(tol, LSE_TOL)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"flash_fwd {label}: max abs err {err} > {tol}")
    if not math.isfinite(lse_err) or lse_err > lse_tol:
        raise AssertionError(f"flash_fwd {label}: lse max abs err "
                             f"{lse_err} > {lse_tol}")
    return err, lse_err


def kernel_phase(seed, dev=None, cases=None, h=12):
    """K4 against its plain version on ``fwd_cases()`` in fp32 and bf16.
    Each row names its route (``flash_attention.flash_fwd_route``) and must
    take the one the rule gives its shape; a row not on the SIMT route
    also runs the SIMT kernel on the same inputs, held to the same
    tolerances, and times it (``simt_ms``; the SIMT numbers also make a
    row of their own, route "simt"); an f32 row's output and lse equal a
    second launch's bit for bit. The
    library call is SDPA under the same boolean mask and, for causal rows
    with Tq == Tk and no lengths (where its top-left causal mask is the
    same one), with ``is_causal=True`` (``library_causal_ms``). o is held
    to ``TOLS``, the lse to ``LSE_TOL`` (fp32: ``TOLS``) with its -inf rows
    identical, and neither holds a NaN."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0) if dev is None else dev
    rs = np.random.RandomState(seed)
    decode_lens = np.sort(rs.randint(1, 513, size=8))
    results = []
    for name, b, tq, tk, d, causal, cache_offset, lengths, want_lse in \
            (fwd_cases() if cases is None else cases):
        if isinstance(lengths, str):
            lengths = decode_lens
        for dtype in (torch.float32, torch.bfloat16):
            if name == GPT_VIEWS:
                qkv = torch.from_numpy(rs.randn(b, tq, 3, h, d).astype(
                    np.float32)).to(dev, dtype)
                q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            else:
                q, k, v = (torch.from_numpy(rs.randn(b, h, t, d).astype(
                    np.float32)).to(dev, dtype) for t in (tq, tk, tk))
            lens = None if lengths is None else \
                torch.tensor(np.asarray(lengths, np.int32), device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset,
                      return_lse=True)
            expect = fwd_route_expected(tq, d, dtype)
            before = _fwd_route_counts(fa)
            got = fa.flash_attention(q, k, v, lens, **kw)
            label = f"{name} {DTYPE_NAMES[dtype]}"
            _check_fwd_route(label, before, _fwd_route_counts(fa), expect)
            want = fa.flash_attention_reference(q, k, v, lens, **kw)
            err, lse_err = _check_fwd_out(label, got, want, dtype)
            simt_err = simt_lse_err = None
            if expect != "simt":
                simt_err, simt_lse_err = _check_fwd_out(
                    f"{label} simt", fa.flash_attention(q, k, v, lens,
                                                        route="simt", **kw),
                    want, dtype)
            if expect == "f32":
                again = fa.flash_attention(q, k, v, lens, **kw)
                if not (torch.equal(again[0], got[0])
                        and torch.equal(again[1], got[1])):
                    raise AssertionError(f"flash_fwd {label}: a second "
                                         "launch differs")
                del again
            tol = TOLS[dtype]
            lse_tol = min(tol, LSE_TOL)
            valid = _valid_mask(b, tq, tk, lens, causal, cache_offset, dev)
            kw["return_lse"] = want_lse

            def kernel(route=None):
                return fa.flash_attention(q, k, v, lens, route=route, **kw)

            ms = device_ms(kernel)
            wrapper_ms = call_ms(kernel)
            plain_ms = device_ms(
                lambda: fa.flash_attention_reference(q, k, v, lens, **kw))
            simt_ms = device_ms(lambda: kernel("simt")) \
                if expect != "simt" else None
            library_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid))
            library_causal_ms = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)) \
                if causal and lens is None and tq == tk else None
            bound_ms, bound_by = attention_bound(b, h, tq, tk, d, dtype,
                                                 valid, want_lse)
            r = dict(kernel="flash_fwd", case=name, dtype=DTYPE_NAMES[dtype],
                     route=expect, max_abs_err=err, lse_err=lse_err,
                     simt_max_abs_err=simt_err, tol=tol,
                     lse_tol=lse_tol, ms=ms, wrapper_ms=wrapper_ms,
                     plain_ms=plain_ms, simt_ms=simt_ms,
                     library_ms=library_ms,
                     library_causal_ms=library_causal_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
            results.append(r)
            if simt_ms is not None:
                results.append(dict(
                    r, route="simt", max_abs_err=simt_err,
                    lse_err=simt_lse_err, simt_max_abs_err=None,
                    ms=simt_ms, wrapper_ms=call_ms(lambda: kernel("simt")),
                    simt_ms=None))
            also = "" if simt_ms is None else \
                (f" simt_ms={simt_ms:.5f} (SIMT kernel, max_abs_err="
                 f"{simt_err:.3e})")
            if library_causal_ms is not None:
                also += (f" library_causal_ms={library_causal_ms:.5f} (SDPA,"
                         " is_causal)")
            print(f"kernel flash_fwd {label} route {expect}: max_abs_err="
                  f"{err:.3e} (tol {tol:g}) lse_err={lse_err:.3e} (tol "
                  f"{lse_tol:g}) ms={ms:.5f} (device, CUDA graph) "
                  f"wrapper_ms={wrapper_ms:.5f} (eager call, host included)"
                  f" plain_ms={plain_ms:.5f}{also} library_ms="
                  f"{library_ms:.5f} (SDPA, boolean mask) bound_ms="
                  f"{bound_ms:.5f} ({bound_by})", flush=True)
    slower = [f"{r['case']} {r['dtype']} ({r['route']} {r['ms']:.5f} >= "
              f"simt {r['simt_ms']:.5f})" for r in results
              if r["simt_ms"] is not None and r["ms"] >= r["simt_ms"]]
    print("flash_fwd: the tc, f32 and split routes against the SIMT kernel "
          "on the same inputs: " + ("faster in every row" if not slower else
                                    "not faster in " + "; ".join(slower)),
          flush=True)
    return results


def _sdpa_bwd_ms(q, k, v, g, valid, causal=False):
    """Device ms of ``scaled_dot_product_attention``'s backward under the
    same boolean mask (``causal``: with ``is_causal=True`` and no mask,
    which lets it take its flash backend): a CUDA graph of forward +
    ``autograd.grad`` less a graph of the forward alone (grad enabled in
    both, so the forward saves what its backward needs). A yardstick only;
    fully masked rows give NaN there and are not compared."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    kw = dict(is_causal=True) if causal else dict(attn_mask=valid)

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, **kw)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qg, kg, vg), g)

    return device_ms(fwd_bwd) - device_ms(fwd)


def _zero_where_unreached(name, dq, dk, dv, valid):
    """Rows that see no key get dq == 0, keys no row sees get dk == dv ==
    0, exactly (no NaN anywhere)."""
    dead_rows = ~valid.any(dim=3)                      # (B, 1, Tq)
    dead_keys = ~valid.any(dim=2)                      # (B, 1, Tk)
    for label, x, dead in (("dq", dq, dead_rows), ("dk", dk, dead_keys),
                           ("dv", dv, dead_keys)):
        if torch.isnan(x).any():
            raise AssertionError(f"{name}: NaN in {label}")
        mask = dead.unsqueeze(-1).expand_as(x)
        if mask.any() and x[mask].abs().max().item() != 0:
            raise AssertionError(f"{name}: {label} not 0 where no pair "
                                 "reaches it")


# (name, b, tq, tk, d, causal, cache_offset, lengths) of the backward
# kernel phase, H = 12
BWD_CASES = [
    # the training shape: B=8, H=12, T=256, causal
    ("train_causal_B8_T256", 8, 256, 256, 64, True, False, None),
    # non-causal key lengths with a length-0 entry
    ("lengths_lse_B4_T128x384", 4, 128, 384, 64, False, False,
     (384, 200, 17, 0)),
    # cache offset: the diagonal aligned to each entry's fill
    ("cache_offset_B4_T16x512", 4, 16, 512, 64, True, True,
     (512, 300, 64, 16)),
    # Tq > Tk causal: the first 192 rows of each head see no key
    ("tq_gt_tk_causal_B2_T256x64", 2, 256, 64, 64, True, False, None),
    # D=128: two 64-column boxes a row on the tensor-core route
    ("causal_D128_B2_T512", 2, 512, 512, 128, True, False, None),
]
BWD_HEAD = "train_causal_B8_T256"


# the backward's routes (``flash_attention.flash_bwd_route``): "tc" the
# bf16 tensor-core kernels, "f32" the fp32 register micro-tile kernels,
# "simt" the others
BWD_ROUTES = ("tc", "f32", "simt")
# the flash kernels' launches by route: the backward's, then the
# forward's (``FWD_ROUTES``)
ROUTE_COUNTERS = tuple(f"{k}_{r}" for k in ("flash_bwd_dq", "flash_bwd_dkv")
                       for r in BWD_ROUTES) + tuple(f"flash_fwd_{r}"
                                                    for r in FWD_ROUTES)


def _read_routes(fa):
    return {name: getattr(fa, name + "_launches") for name in ROUTE_COUNTERS}


def bwd_route_expected(d, dtype):
    """The route ``flash_bwd_route`` gives a call with aligned operands."""
    if d not in (64, 128):
        return "simt"
    return "tc" if dtype == torch.bfloat16 else "f32"


def _check_bwd_route(label, before, now, expect):
    """One launch of each backward kernel since ``before``, on ``expect``."""
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        taken = [r for r in BWD_ROUTES if now[f"{kernel}_{r}"]
                 - before[f"{kernel}_{r}"] == 1]
        if taken != [expect] or sum(
                now[f"{kernel}_{r}"] - before[f"{kernel}_{r}"]
                for r in BWD_ROUTES) != 1:
            raise AssertionError(f"{kernel} {label} took {taken}, not "
                                 f"{expect}")


def _bwd_errs(label, got, want, valid, tol):
    """{dq, dk, dv: (max abs err, err / max|plain|)} of a backward against
    the plain version's, each within ``tol`` of max|plain|, with no NaN and
    exact zeros where no pair reaches."""
    _zero_where_unreached(label, *got, valid)
    errs = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = (x.float() - y.float()).abs().max().item()
        # relative to max|plain|: the bf16 kernels round p and dS to bf16
        # before their products (as the TPU kernels do), the plain version
        # keeps them in fp32; in fp32 only the order of sums differs
        ref = max(1.0, y.float().abs().max().item())
        if not math.isfinite(err) or err > tol * ref:
            raise AssertionError(f"flash_bwd {label} {name}: max abs err "
                                 f"{err} > {tol} x {ref}")
        errs[name] = (err, err / ref)
    return errs


def backward_kernel_phase(seed, dev=None, cases=None, h=12):
    """K5 and K6 against their plain versions on ``BWD_CASES`` (or
    ``cases``) in fp32 and bf16. Each row names its route
    (``flash_attention.flash_bwd_route``) and must take the one the rule
    gives it (``_check_bwd_route``): with D 64 or 128, bf16 the
    tensor-core kernels (``csrc/flash_bwd_tc.cu``) and fp32 the register
    micro-tile kernels (``csrc/flash_bwd_f32.cu``); D = 32 the SIMT kernels
    (``csrc/flash_bwd.cu``). A row not on the SIMT route also runs the
    SIMT kernels on the same inputs, held to the same tolerance and timed
    (``simt_ms``; the SIMT numbers also make a row of their own, route
    "simt"); every f32 output equals a second launch's bit for bit. The
    library call is SDPA's whole backward under the same boolean mask and,
    for causal rows with Tq == Tk and no lengths (where its top-left
    causal mask is the same one), with ``is_causal=True``
    (``library_causal_ms``). ``delta_ms`` is the row statistic ``delta =
    sum(g * o)`` as ``FlashAttentionFunction`` computes it before the two
    kernels (ATen), so that dq + dk/dv + delta is the port's whole
    backward beside SDPA's."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0) if dev is None else dev
    rs = np.random.RandomState(seed + 7)
    results = []
    for name, b, tq, tk, d, causal, cache_offset, lengths in \
            (BWD_CASES if cases is None else cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.from_numpy(rs.randn(b, h, t, d).astype(
                np.float32)).to(dev, dtype) for t in (tq, tk, tk, tq))
            lens = None if lengths is None else \
                torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset)
            out, lse = fa.flash_attention(q, k, v, lens, return_lse=True,
                                          **kw)
            delta = (g.float() * out.float()).sum(-1)
            args = (q, k, v, lens, lse, delta, g)
            label = f"{name} {DTYPE_NAMES[dtype]}"
            expect = bwd_route_expected(d, dtype)
            before = _read_routes(fa)
            got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args,
                                                                   **kw))
            want = (fa.flash_bwd_dq_reference(*args, **kw),
                    *fa.flash_bwd_dkv_reference(*args, **kw))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _check_bwd_route(label, before, _read_routes(fa), expect)
            valid = _valid_mask(b, tq, tk, lens, causal, cache_offset, dev)
            tol = TOLS[dtype]
            errs = _bwd_errs(label, got, want, valid, tol)
            simt_errs = None
            if expect != "simt":
                simt_errs = _bwd_errs(f"{label} simt", fa.flash_attention_bwd(
                    *args, route="simt", **kw), want, valid, tol)
            if expect == "f32":
                again = fa.flash_attention_bwd(*args, **kw)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"flash_bwd {label}: a second "
                                         "launch differs")
                del again
            library_ms = _sdpa_bwd_ms(q, k, v, g, valid)
            library_causal_ms = _sdpa_bwd_ms(q, k, v, g, valid, causal=True) \
                if causal and lens is None and tq == tk else None
            delta_ms = device_ms(lambda: (g.float() * out.float()).sum(-1))
            for kernel, labels, launch, plain in (
                    ("dq", ("dq",), fa.flash_bwd_dq,
                     fa.flash_bwd_dq_reference),
                    ("dkv", ("dk", "dv"), fa.flash_bwd_dkv,
                     fa.flash_bwd_dkv_reference)):
                plain_ms = device_ms(lambda: plain(*args, **kw))
                bound_ms, bound_by = attention_bwd_bound(
                    kernel, b, h, tq, tk, d, dtype, valid)
                common = dict(kernel=f"flash_bwd_{kernel}", case=name,
                              dtype=DTYPE_NAMES[dtype], tol=tol,
                              plain_ms=plain_ms, library_ms=library_ms,
                              library_causal_ms=library_causal_ms,
                              delta_ms=delta_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
                rows = [(expect, errs)]
                if simt_errs is not None:
                    rows.append(("simt", simt_errs))
                simt_ms = None
                for route, e in reversed(rows):   # the SIMT row first
                    ms = device_ms(lambda: launch(*args, route=route, **kw))
                    wrapper_ms = call_ms(lambda: launch(*args, route=route,
                                                        **kw))
                    err = max(e[x][0] for x in labels)
                    rel = max(e[x][1] for x in labels)
                    r = dict(common, route=route, max_abs_err=err,
                             err_over_max_ref=rel, ms=ms,
                             wrapper_ms=wrapper_ms,
                             simt_ms=simt_ms if route == expect else None)
                    results.append(r)
                    also = "" if r["simt_ms"] is None else \
                        f" simt_ms={simt_ms:.5f} (SIMT kernel)"
                    if library_causal_ms is not None:
                        also += (f" library_causal_ms={library_causal_ms:.5f}"
                                 " (SDPA whole backward, is_causal)")
                    also += f" delta_ms={delta_ms:.5f} (ATen)"
                    print(f"kernel flash_bwd_{kernel} {label} route {route}:"
                          f" max_abs_err={err:.3e} ({rel:.2e} of max|plain|,"
                          f" tol {tol:g}) ms={ms:.5f} (device, CUDA graph) "
                          f"wrapper_ms={wrapper_ms:.5f} (eager call) "
                          f"plain_ms={plain_ms:.5f} library_ms="
                          f"{library_ms:.5f} (SDPA whole backward, boolean "
                          f"mask){also} bound_ms={bound_ms:.5f} ({bound_by})",
                          flush=True)
                    if route == "simt":
                        simt_ms = ms
            del q, k, v, g, out, lse, delta, args, got, want
            gc.collect()
    slower = [f"{r['kernel']} {r['case']} {r['dtype']} ({r['route']} "
              f"{r['ms']:.5f} >= simt {r['simt_ms']:.5f})" for r in results
              if r["simt_ms"] is not None and r["ms"] >= r["simt_ms"]]
    print("flash_bwd: the tc and f32 routes against the SIMT kernels on the "
          "same inputs: " + ("faster in every row" if not slower else
                             "not faster in " + "; ".join(slower)),
          flush=True)
    return results


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------
def oracle_check(net, prompt, stream, dev):
    """Hold ``stream`` against the full-forward greedy oracle; returns the
    number of tokens checked. A mismatch fails unless the oracle's two
    best logits there differ by less than 1e-4 (a near tie that summation
    order may flip); then the position is printed and the check of this
    stream ends there (the two continuations differ from then on)."""
    seq = [int(t) for t in prompt]
    with torch.no_grad():
        for i, tok in enumerate(stream):
            logits = net(torch.tensor([seq], device=dev))[0, -1]
            if not torch.isfinite(logits).all():
                raise AssertionError("oracle logits not finite")
            top = torch.topk(logits, 2)
            want = int(top.indices[0])
            if want != tok:
                gap = float(top.values[0] - top.values[1])
                if gap >= 1e-4:
                    raise AssertionError(
                        f"decode stream diverged from the oracle at token "
                        f"{i}: got {tok}, oracle {want} (top-2 gap {gap})")
                print(f"near tie at token {i} (top-2 gap {gap:.2e}): "
                      f"stream {tok}, oracle {want}; check ends here")
                return i
            seq.append(tok)
    return len(stream)


def decode_routes(buckets, prompt_lens, steps):
    """The forward launches by route of fp32 decode serving: 12 a decode
    step (Tq = 1: split) and 12 a prefill, whose Tq is its prompt's
    bucket (fp32: simt)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    want = dict.fromkeys(FWD_ROUTES, 0)
    want["split"] += 12 * steps
    for n in prompt_lens:
        bucket = min(bk for bk in buckets if bk >= n)
        want[fwd_route_expected(bucket, 64, torch.float32)] += 12
    return want


def slice_phase(seed, card=None):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", dropout=0.0).initialize("xavier",
                                                              ctx=ctx)
    nparams = sum(p.numel() for p in net.parameters())
    print(f"model gpt_decoder_117m: {nparams} parameters "
          f"({nparams * 4 / 1e6:.1f} MB fp32), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    sess = serving.DecodeSession(net, ctx=ctx, max_slots=8, max_len=512,
                                 name="gpt117m")
    try:
        t0 = time.perf_counter()
        sess.warmup()
        print(f"warmup: {time.perf_counter() - t0:.2f} s, buckets "
              f"{sess.prefill_buckets}", flush=True)
        rs = np.random.RandomState(seed + 1)
        lengths = [5, 250, 17, 96, 33, 180, 8, 64, 128, 240, 12, 45]
        prompts = [rs.randint(0, net.vocab_size, (n,)).astype(np.int32)
                   for n in lengths]
        new_tokens = 32
        # free what earlier phases left (CUDA-graph pools sit in
        # reference cycles) so the peak belongs to the serving run
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(fa)
        t0 = time.perf_counter()
        handles = [sess.submit(p, max_new_tokens=new_tokens)
                   for p in prompts]
        streams = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        launches = fa.flash_fwd_launches
        routes = _fwd_route_counts(fa)
        stats = sess.stats()
        peak = torch.cuda.max_memory_allocated(dev)
        step_times = decode_step_times(sess, card or card_line(),
                                        net.vocab_size)
        if not sess.drain(60):
            raise AssertionError("decode session did not drain")
    finally:
        sess.close()

    for s in streams:
        if len(s) != new_tokens or min(s) < 0 or max(s) >= net.vocab_size:
            raise AssertionError(f"bad stream {s}")
    steps, prefills = stats["steps"], stats["prefills"]
    tokens = sum(len(s) for s in streams)
    decode_tok_s = (tokens - prefills) / stats["decode_seconds"]
    print(f"serve: {len(prompts)} requests, {tokens} tokens in {wall:.3f} s "
          f"= {tokens / wall:.1f} tokens/s end to end; decode steps "
          f"{steps}, mean step {stats['decode_seconds'] / steps * 1e3:.3f} "
          f"ms, {decode_tok_s:.1f} decode tokens/s; mean occupancy "
          f"{stats['mean_step_occupancy']:.2f} of 8; TTFT p50 "
          f"{stats['ttft_ms']['p50']:.2f} ms p90 "
          f"{stats['ttft_ms']['p90']:.2f} ms; prefill share "
          f"{stats['prefill_frac']:.3f}; peak memory {peak / 2**20:.1f} MiB "
          f"(allocated before serving, weights and KV cache: "
          f"{base / 2**20:.1f} MiB)", flush=True)
    print(f"flash_fwd launches on the main path: {launches} "
          f"(>= 12 x {steps} decode steps = {12 * steps}; 12 x ({steps} "
          f"steps + {prefills} prefills) = {12 * (steps + prefills)})",
          flush=True)
    if launches < 12 * steps:
        raise AssertionError("the decode path did not go through the "
                             "flash_fwd kernel")
    want_routes = decode_routes(sess.prefill_buckets, lengths, steps)
    print(f"flash_fwd launches by route: {routes} (want {want_routes}: the "
          f"{steps} decode steps on split)", flush=True)
    if routes != want_routes or prefills != len(prompts):
        raise AssertionError(f"serving launched flash_fwd by route {routes}"
                             f", not {want_routes}")

    order = np.argsort(lengths)
    checked = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]
    for i in checked:
        n = oracle_check(net, prompts[i], streams[i], dev)
        print(f"oracle: request {i} (prompt {lengths[i]} tokens) matched "
              f"{n} of {len(streams[i])} tokens", flush=True)
    return dict(launches=launches, routes=routes, steps=steps,
                prefills=prefills, tokens=tokens, wall_s=wall, stats=stats,
                peak_bytes=peak, step_times=step_times)


def decode_step_times(sess, card, vocab, steps=20):
    """The decode step of ``sess`` (all slots free: its sequences are
    done) as the captured graph (one replay) and eagerly (the same body
    launched from the host), on the same inputs (8 slots at cache lengths
    48 to 360): the next tokens equal, host ms a step including the
    next-token copy to the host (two alternating turns each), device time
    (``torch.profiler``), and K4's split-route launches: 12 a step
    recorded by the capture, counted by every graph step (measured over
    the graph turns) and seen by the profiler in a graph step and an
    eager one."""
    from incubator_mxnet_tpu_torch.ops import launches

    rs = np.random.RandomState(5)
    cl = np.linspace(48, 360, sess.max_slots).astype(np.int32)
    tk = rs.randint(0, vocab, (sess.max_slots,)).astype(np.int32)
    dev = sess.device

    def graph_step(c, t):
        return sess._decode(c, t).cpu()

    def eager_step(c, t):
        return sess._decode_step(torch.from_numpy(t).to(dev),
                                 torch.from_numpy(c).to(dev)).cpu()

    out = {}
    measured = {}
    with sess._exec_lock:
        got = {name: fn(cl, tk) for name, fn in (("graph", graph_step),
                                                 ("eager", eager_step))}
        if not torch.equal(got["graph"], got["eager"]):
            raise AssertionError(f"decode graph tokens {got['graph']} != "
                                 f"eager {got['eager']}")
        for name, fn in (("graph", graph_step), ("eager", eager_step),
                         ("graph", graph_step), ("eager", eager_step)):
            torch.cuda.synchronize()
            c0 = launches.snapshot()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(cl, tk)
            out[name] = (time.perf_counter() - t0) * 1e3 / steps
            if name == "graph":
                for n, v in _launch_delta(c0).items():
                    measured[n] = measured.get(n, 0) + v
        prof = {}
        for name, fn in (("graph", graph_step), ("eager", eager_step)):
            rows = _profile_step(fn, cl, tk, card, out[name],
                                 tags=FLASH_TAGS[3:5], top=4,
                                 what=f"decode step ({name})")
            _check_profiled(f"decode step ({name})", rows,
                            {"flash_fwd_split_kernel": 12,
                             "flash_fwd_merge_kernel": 12}, 1)
            prof[name] = sum(r[0] for r in rows)
    (graph,) = sess._graphs.graphs()
    counted = _counts_by_name(graph.counted)
    want = {"flash_fwd": 12, "flash_fwd_split": 12}
    print(f"decode step ({card}; 8 slots at 48-360 of 512): captured "
          f"graph {out['graph']:.4f} ms, eager {out['eager']:.4f} ms a step "
          f"(host clock, {steps} steps each, second turn); device time "
          f"{prof['graph']:.4f} / {prof['eager']:.4f} ms; the capture "
          f"recorded {counted}, {2 * steps} graph steps counted {measured}; "
          f"next tokens equal", flush=True)
    if counted != want or measured != {n: v * 2 * steps
                                       for n, v in want.items()}:
        raise AssertionError(f"the decode capture recorded {counted} and "
                             f"{2 * steps} graph steps counted {measured},"
                             f" not {want} a step")
    return dict(graph_ms=out["graph"], eager_ms=out["eager"],
                graph_device_ms=prof["graph"], eager_device_ms=prof["eager"],
                per_replay=counted, launches=measured)


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------
COUNTERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# bf16 training gradients, tensor-core K5/K6 vs their plain version on the
# same forward: relative L2 error per parameter tensor (the kernels round
# p and dS to bf16 before their products, the plain version does not)
BF16_GRAD_RTOL = 2e-2


def _reset_launches(fa):
    for name in COUNTERS + ROUTE_COUNTERS:
        setattr(fa, name + "_launches", 0)


def _read_launches(fa):
    return {name: getattr(fa, name + "_launches") for name in COUNTERS}


def _grads(net, loss_fn, x, y):
    """fp32 loss and the gradient of every trainable parameter, eager
    (record)."""
    import incubator_mxnet_tpu_torch as mx

    params = [p for p in net.parameters() if p.requires_grad]
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    return loss.detach(), torch.autograd.grad(loss, params)


def gradient_oracle(net, loss_fn, x, y):
    """Gradients through the kernels against the same model with its
    attention swapped for the autograd of the plain forward (dense, fp32):
    relative L2 error per parameter tensor <= GRAD_RTOL."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import gpt as gpt_mod
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    loss, grads = _grads(net, loss_fn, x, y)
    kernel_attention = gpt_mod.flash_attention
    gpt_mod.flash_attention = fa.flash_attention_reference
    try:
        ref_loss, ref_grads = _grads(net, loss_fn, x, y)
    finally:
        gpt_mod.flash_attention = kernel_attention
    if not torch.isfinite(loss) or abs(float(loss - ref_loss)) > \
            1e-5 * abs(float(ref_loss)):
        raise AssertionError(f"oracle loss {float(loss)} != plain "
                             f"{float(ref_loss)}")
    worst = (0.0, "")
    names = [n for n, _ in net.named_parameters()]
    for name, g, r in zip(names, grads, ref_grads):
        den = r.norm().item()
        err = (g - r).norm().item()
        rel = err / den if den > 0 else err
        if not math.isfinite(rel) or rel > GRAD_RTOL:
            raise AssertionError(f"gradient oracle: {name} relative L2 "
                                 f"error {rel} > {GRAD_RTOL}")
        worst = max(worst, (rel, name))
    print(f"gradient oracle (fp32, {len(names)} parameter tensors): loss "
          f"{float(loss):.6f} vs plain {float(ref_loss):.6f}; worst relative "
          f"L2 error {worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL:g}",
          flush=True)
    return worst[0]


def gpt_bf16_gate(net, loss_fn, x, y):
    """One bf16 step's gradients through the tensor-core K5/K6 against the
    same step with ``flash_attention_bwd`` swapped for its plain version
    (made here, for this gate only; the forward is the same K4 in both):
    relative L2 error per parameter tensor <= BF16_GRAD_RTOL."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    loss, grads = _grads(net, loss_fn, x, y)
    kernel_bwd = fa.flash_attention_bwd
    fa.flash_attention_bwd = fa.flash_attention_bwd_reference
    try:
        ref_loss, ref_grads = _grads(net, loss_fn, x, y)
    finally:
        fa.flash_attention_bwd = kernel_bwd
    if not torch.isfinite(loss) or not torch.equal(loss, ref_loss):
        raise AssertionError(f"bf16 gate: loss {float(loss)} != "
                             f"{float(ref_loss)} (the same forward)")
    worst = (0.0, "")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    for name, g, r in zip(names, grads, ref_grads):
        g, r = g.float(), r.float()
        den = r.norm().item()
        rel = (g - r).norm().item() / den if den > 0 else g.norm().item()
        if not math.isfinite(rel) or rel > BF16_GRAD_RTOL:
            raise AssertionError(f"bf16 gradient gate: {name} relative L2 "
                                 f"error {rel} > {BF16_GRAD_RTOL}")
        worst = max(worst, (rel, name))
    print(f"bf16 gradient gate ({len(names)} parameter tensors, tensor-core "
          f"K5/K6 vs their plain version on the same forward): worst "
          f"relative L2 error {worst[0]:.3e} ({worst[1]}), tolerance "
          f"{BF16_GRAD_RTOL:g}", flush=True)
    return worst[0]


FLASH_TAGS = ("flash_fwd_kernel", "flash_fwd_tc_kernel",
              "flash_fwd_f32_kernel",
              "flash_fwd_split_kernel", "flash_fwd_merge_kernel",
              "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")


def _profile_step(step, x, y, card, step_ms, tags=FLASH_TAGS, top=14,
                  what="bf16 training step"):
    """Device time per kernel of one training step (``torch.profiler``;
    kernel events only, so no time is counted twice), printed largest
    first, with the device's idle share of an unprofiled step of
    ``step_ms`` and the share of the kernels named by ``tags``; returns
    the rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: no CPU op and no user range (which would count
        # its kernels a second time)
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile of one {what} ({card}): device time "
          f"{total:.3f} ms in {sum(r[1] for r in rows)} kernel launches "
          f"(step wall {wall_ms:.3f} ms under the profiler); against the "
          f"unprofiled {step_ms:.3f} ms step the device idles "
          f"{100 * max(0.0, 1 - total / step_ms):.1f}% of it", flush=True)
    if total == 0:
        print("profile: the profiler reported no device time (not "
              "measured)", flush=True)
        return rows
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{key[:100]}", flush=True)
    for tag in tags:
        hit = [r for r in rows if tag in r[2]]
        ms = sum(r[0] for r in hit)
        print(f"  {tag}: {ms:.3f} ms ({100 * ms / total:.1f}% of device "
              f"time) in {sum(r[1] for r in hit)} launches", flush=True)
    return rows


def training_routes(fp32_passes, bf16_passes, layers=12, t=256, d=64):
    """The flash launches by route of ``fp32_passes`` and ``bf16_passes``
    training passes of a GPT of ``layers`` layers at sequence length ``t``
    and head dim ``d``: each kernel once a layer a pass, K4 of fp32 passes
    where ``fwd_route_expected`` sends them (f32 at T=256), K5/K6 of fp32
    passes on f32, every bf16 pass on tc."""
    want = dict.fromkeys(ROUTE_COUNTERS, 0)
    want["flash_fwd_" + fwd_route_expected(t, d, torch.float32)] = \
        layers * fp32_passes
    want["flash_fwd_tc"] = layers * bf16_passes
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        want[f"{kernel}_f32"] = layers * fp32_passes
        want[f"{kernel}_tc"] = layers * bf16_passes
    return want


def train_phase(seed, card):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel, serving
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    b, t, vocab = 8, 256, 50257
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", vocab_size=vocab, dropout=0.0,
                  max_length=t).initialize("xavier", ctx=ctx)
    rs = np.random.RandomState(seed + 3)
    x = torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(np.int32))
    y = torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(np.float32))
    x, y = x.to(dev), y.to(dev)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return ce(logits, labels).mean()

    # the training launches are read in two windows, each with the counts
    # set to 0 just before its first step and read just after its last;
    # train -> decode between them is read on its own
    _reset_launches(fa)
    worst = gradient_oracle(net, lm_loss, x, y)

    # learning check: the loss on one repeated batch falls
    st = parallel.SPMDTrainer(net, lm_loss, "adam", {"learning_rate": 3e-4})
    losses = [float(st.step(x, y)) for _ in range(10)]
    launches = _read_launches(fa)
    routes = _read_routes(fa)
    backward_passes = fp32_passes = 1 + 10
    print(f"learning check (fp32 SPMDTrainer, adam lr 3e-4, one batch "
          f"repeated): losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the loss did not fall by 5% over 10 steps")
    st.sync_to_net()
    del st

    # train -> decode: serve the trained weights
    prompt = rs.randint(0, vocab, (24,)).astype(np.int32)
    _reset_launches(fa)
    with serving.DecodeSession(net, ctx=ctx, max_slots=2, max_len=t,
                               name="trained") as sess:
        stream = sess.generate(prompt, max_new_tokens=16)
        stats = sess.stats()
    decode_launches = _read_launches(fa)
    decode_routes_got = _fwd_route_counts(fa)
    n = oracle_check(net, prompt, stream, dev)
    steps, prefills = stats["steps"], stats["prefills"]
    print(f"train -> decode: the trained weights served {len(stream)} "
          f"tokens; {n} matched the full-forward oracle; launches "
          f"{decode_launches} in {steps} decode steps and {prefills} "
          f"prefills (flash_fwd >= 12 x {steps} = {12 * steps})", flush=True)
    if decode_launches["flash_fwd"] < 12 * steps \
            or decode_launches["flash_bwd_dq"] \
            or decode_launches["flash_bwd_dkv"]:
        raise AssertionError("train -> decode: the decode path did not go "
                             "through flash_fwd alone")
    # the session was not warmed up: its first decode step captured the
    # step's graph, whose warm-up ran the step once more on the card
    want_routes = decode_routes(sess.prefill_buckets, [len(prompt)],
                                steps + 1)
    if decode_routes_got != want_routes or prefills != 1:
        raise AssertionError(f"train -> decode launched flash_fwd by route "
                             f"{decode_routes_got}, not {want_routes}")

    _reset_launches(fa)
    # the eager entry point: record -> backward -> step
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-4, "momentum": 0.9})
    eager = []
    for _ in range(2):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(b)
        eager.append(float(per_sample.detach().mean()))
    backward_passes += 2
    fp32_passes += 2
    if not all(math.isfinite(v) for v in eager):
        raise AssertionError(f"gluon.Trainer losses not finite: {eager}")
    print(f"gluon.Trainer (fp32, sgd lr 1e-4 momentum 0.9): 2 steps, "
          f"losses {eager}", flush=True)
    window = _read_launches(fa)
    launches = {name: launches[name] + window[name] for name in COUNTERS}
    window = _read_routes(fa)
    routes = {name: routes[name] + window[name] for name in ROUTE_COUNTERS}

    # the bf16 gradient gate, read on its own: one pass through the
    # tensor-core K5/K6, one through their plain version (K4 in both)
    net.cast("bfloat16")
    _reset_launches(fa)
    bf16_worst = gpt_bf16_gate(net, lm_loss, x, y)
    gate = {**_read_launches(fa), **_read_routes(fa)}
    want_gate = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                 "flash_bwd_dq_tc": 12, "flash_bwd_dkv_tc": 12,
                 "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0,
                 "flash_bwd_dq_simt": 0, "flash_bwd_dkv_simt": 0,
                 "flash_fwd_tc": 24, "flash_fwd_f32": 0,
                 "flash_fwd_split": 0, "flash_fwd_simt": 0}
    if gate != want_gate:
        raise AssertionError(f"bf16 gate launches {gate}, not {want_gate}")

    # the bench row: bf16 net, SPMDTrainer SGD lr 1e-4 momentum 0.9
    _reset_launches(fa)
    st = parallel.SPMDTrainer(net, lm_loss, "sgd",
                              {"learning_rate": 1e-4, "momentum": 0.9})
    for _ in range(3):
        st.step(x, y)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = 10
    t0 = time.perf_counter()
    bf16_losses = [st.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(dev)
    backward_passes += 3 + steps
    if not all(torch.isfinite(v) for v in bf16_losses):
        raise AssertionError("bf16 SPMDTrainer loss not finite")
    tokens_s = b * t / (step_ms / 1e3)
    print(f"bf16 SPMDTrainer step (B={b}, T={t}, sgd lr 1e-4 momentum 0.9; "
          f"{card}): {step_ms:.3f} ms per step (host clock, {steps} steps "
          f"after 3 warmup), {tokens_s:.1f} tokens/s, peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    rows = _profile_step(st.step, x, y, card, step_ms)
    backward_passes += 1
    bf16_passes = backward_passes - fp32_passes
    window = _read_launches(fa)
    launches = {name: launches[name] + window[name] for name in COUNTERS}
    window = _read_routes(fa)
    routes = {name: routes[name] + window[name] for name in ROUTE_COUNTERS}

    # one forward and one backward per pass, each through the 12 layers;
    # every fp32 pass on the f32 K4, K5 and K6, every bf16 pass on the
    # tensor-core ones
    want = 12 * backward_passes
    print(f"launches on the training path: {launches} over "
          f"{backward_passes} backward passes (12 x {backward_passes} = "
          f"{want} each); by route {routes} ({fp32_passes} fp32 passes "
          f"on f32 K4/K5/K6, {bf16_passes} bf16 on tc)",
          flush=True)
    for name in COUNTERS:
        if launches[name] != want:
            raise AssertionError(f"training launched {name} "
                                 f"{launches[name]} times, not {want}")
    want_routes = training_routes(fp32_passes, bf16_passes, t=t)
    if routes != want_routes:
        raise AssertionError(f"training launched by route {routes}, not "
                             f"{want_routes}")
    return dict(launches=launches, routes=routes, gate_launches=gate,
                decode_launches=decode_launches,
                decode_routes=decode_routes_got,
                backward_passes=backward_passes, grad_worst_rel=worst,
                bf16_grad_worst_rel=bf16_worst,
                learning_losses=losses, step_ms=step_ms, tokens_s=tokens_s,
                peak_bytes=peak, profile=rows[:14])

# ---------------------------------------------------------------------------
# conv kernel phase
# ---------------------------------------------------------------------------
# (name, n, h, w, ci, co, k, stride, pad, kind): kind "plain" has no
# prologue, "pro" the BatchNorm prologue + ReLU, "res" also the residual
# join and the emitted activation. The first six are ResNet-50's at B=32;
# the last lies off the model's path (5x5, odd H, widths not multiples of
# 8 or 16).
CONV_CASES = [
    ("1x1_64to64_56_plain", 32, 56, 56, 64, 64, 1, 1, 0, "plain"),
    ("3x3_64to64_56_pro", 32, 56, 56, 64, 64, 3, 1, 1, "pro"),
    ("3x3_s2_128_56to28_pro", 32, 56, 56, 128, 128, 3, 2, 1, "pro"),
    ("1x1_256to64_56_join_emit", 32, 56, 56, 256, 64, 1, 1, 0, "res"),
    ("1x1_s2_512to1024_28to14_plain", 32, 28, 28, 512, 1024, 1, 2, 0,
     "plain"),
    ("3x3_512to512_7_pro", 32, 7, 7, 512, 512, 3, 1, 1, "pro"),
    ("5x5_s2_24to40_15_res_emit", 32, 15, 15, 24, 40, 5, 2, 2, "res"),
]
CONV_HEAD = "3x3_64to64_56_pro"
CONV_KERNELS = ("fused_conv", "conv_bwd_dx", "conv_bwd_dw")
# the conv kernels' routes (ops/fused_conv.conv_route): "tc" the bf16
# tensor-core kernels (csrc/fused_conv_tc.cu, csrc/conv_bwd_tc.cu), "f32"
# the fp32 micro-tile kernels (csrc/fused_conv_f32.cu,
# csrc/conv_bwd_f32.cu), "simt" csrc/fused_conv.cu and csrc/conv_bwd.cu
ROUTED = ("fused_conv", "conv_bwd_dx", "conv_bwd_dw")
# fp32 per-channel sums and dW: relative L2 error, kernels vs plain
CONV_L2_TOL = 1e-4
# the tensor-core K1's per-channel sums and sums of squares at the head
# case: relative L2 error from an fp64 evaluation on the same bf16 inputs
# (the port holds its fp32 running statistics to the JAX package's at
# 1e-5; the tensor cores' fp32 accumulation leans about 5e-7 there)
K1_SUMS_RTOL = 1e-5


def _conv_dims(case):
    _, n, h, w, ci, co, k, stride, pad, kind = case
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return n, h, w, ci, co, k, stride, pad, kind, ho, wo


def conv_bound(kernel, case, dtype):
    """Least time (ms) of one conv kernel call and what bounds it: 2 FLOPs
    per multiply-add (2*N*Ho*Wo*Ci*Co*kh*kw, the same for all three) at
    the peak of the inputs' type; each input read once and each output
    written once (activations and weights in the type, per-channel
    vectors fp32)."""
    n, h, w, ci, co, k, _, _, kind, ho, wo = _conv_dims(case)
    es = torch.tensor([], dtype=dtype).element_size()
    xb, yb, wb = n * h * w * ci * es, n * ho * wo * co * es, k * k * ci * co * es
    pro, res = kind != "plain", kind == "res"
    if kernel == "fused_conv":      # x [r] w a b [ar br] -> y s ss [xp]
        nbytes = xb * (1 + 2 * res) + wb + yb + 8 * co + 8 * ci * (pro + res)
    elif kernel == "conv_bwd_dx":   # dy y x w ds dss a b [r ar br g] -> dx da db [dr dar]
        nbytes = 2 * yb + 2 * xb + wb + 8 * co + 16 * ci * pro \
            + xb * 3 * res + 12 * ci * res
    else:                           # x [r] dy y ds dss a b [ar br] -> dw
        nbytes = xb * (1 + res) + 2 * yb + wb + 8 * co + 8 * ci * (pro + res)
    flops = 2.0 * n * ho * wo * ci * co * k * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _conv_inputs(case, dtype, dev, gen):
    n, h, w, ci, co, k, _, _, kind, ho, wo = _conv_dims(case)

    def rnd(*shape, scale=1.0, shift=0.0, uniform=False):
        t = torch.rand(shape, generator=gen, device=dev) if uniform else \
            torch.randn(shape, generator=gen, device=dev)
        return t * scale + shift

    t = dict(x=rnd(n, h, w, ci).to(dtype),
             w=rnd(k, k, ci, co, scale=1 / math.sqrt(k * k * ci)).to(dtype),
             dy=rnd(n, ho, wo, co).to(dtype), ds=rnd(co, scale=0.1),
             dss=rnd(co, scale=0.01))
    if kind != "plain":
        t.update(a=rnd(ci, shift=0.5, uniform=True), b=rnd(ci, scale=0.5))
    if kind == "res":
        t.update(r=rnd(n, h, w, ci).to(dtype),
                 ar=rnd(ci, shift=0.5, uniform=True), br=rnd(ci, scale=0.5),
                 g=rnd(n, h, w, ci).to(dtype))
    return t


def _conv_errs(names, got, want, dtype):
    """Max abs error over max(1, max|plain|) of each output (and, fp32,
    the relative L2 error of the per-channel sums and dW); raises past
    the tolerances. Returns (max abs error, worst relative error)."""
    worst_abs, worst_rel = 0.0, 0.0
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: shape {tuple(g.shape)} or "
                                 "non-finite values")
        err = (g - w).abs().max().item()
        rel = err / max(1.0, w.abs().max().item())
        if rel > TOLS[dtype]:
            raise AssertionError(f"{name} {DTYPE_NAMES[dtype]}: max abs err "
                                 f"{err} > {TOLS[dtype]} x max(1, max|plain|)")
        if dtype == torch.float32 and (w.dim() == 1 or name == "dw"):
            l2 = (g - w).norm().item() / max(w.norm().item(), 1e-30)
            if l2 > CONV_L2_TOL:
                raise AssertionError(f"{name}: relative L2 {l2} > "
                                     f"{CONV_L2_TOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def _route_launches():
    """{(kernel, route): launches} of the three conv kernels."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {(k, r): getattr(fc, f"{k}_{r}_launches") for k in ROUTED
            for r in CONV_ROUTES[k]}


def conv_routes_expected(dtype):
    """{kernel: route} of ResNet-50's convs in ``dtype``, as
    ``fused_conv.conv_route`` gives them for its widths (multiples of 8)
    and the model's operands (16-byte aligned): bf16 every kernel on the
    tensor cores, fp32 every kernel on f32."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {kernel: fc.conv_route(dtype, 64, 64, kernel)
            for kernel in ROUTED}


def _route_taken(before, kernel):
    """The route ``kernel`` took since ``before`` (one launch)."""
    now = _route_launches()
    taken = [r for r in CONV_ROUTES[kernel]
             if now[kernel, r] - before[kernel, r] == 1]
    if len(taken) != 1:
        raise AssertionError(f"{kernel}: launches by route {now} after "
                             f"{before}: not one launch")
    return taken[0]


def k1_sums_fp64(x, w, a=None, b=None, stride=1, pad=0, relu=True, r=None,
                 ar=None, br=None):
    """K1's per-channel sum and sum of squares as the plain version takes
    them, with the prologue output rounded to the input type as the kernels
    round it, and the conv and the sums in fp64."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    xp = fc.apply_prologue(x, a, b, r, ar, br, relu)
    acc = fc._nhwc(F.conv2d(fc._nchw(xp.double()), fc._oihw(w.double()),
                            stride=stride, padding=pad))
    return acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))


def conv_kernel_phase(seed):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    results = []
    for case in CONV_CASES:
        name = case[0]
        n, h, w, ci, co, k, stride, pad, kind, ho, wo = _conv_dims(case)
        res = kind == "res"
        for dtype in (torch.float32, torch.bfloat16):
            t = _conv_inputs(case, dtype, dev, gen)
            rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
            fargs = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                     True)
            want_f = fc.fused_conv_reference(*fargs, emit=res, **rkw)
            bargs = fargs[:4] + (want_f[0], t["dy"], t["ds"], t["dss"],
                                 stride, pad, True)
            calls = {
                "fused_conv": (
                    lambda: fc.fused_conv(*fargs, emit=res, **rkw),
                    lambda: fc.fused_conv_reference(*fargs, emit=res,
                                                    **rkw),
                    ("y", "sum", "sumsq", "emitted")),
                "conv_bwd_dx": (
                    lambda: fc.conv_bwd_dx(*bargs, g=t.get("g"), **rkw),
                    lambda: fc.conv_bwd_dx_reference(*bargs, g=t.get("g"),
                                                     **rkw),
                    ("dx", "da", "db", "dr", "dar")),
                "conv_bwd_dw": (
                    lambda: (fc.conv_bwd_dw(*bargs, **rkw),),
                    lambda: (fc.conv_bwd_dw_reference(*bargs, **rkw),),
                    ("dw",)),
            }
            # cuDNN on channels-last tensors: timed only, never used by
            # the port
            x_cl, dy_cl = t["x"].permute(0, 3, 1, 2), t["dy"].permute(
                0, 3, 1, 2)
            w_cl = t["w"].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv_args = ([stride] * 2, [pad] * 2, [1, 1], False, [0, 0], 1)
            library = {
                "fused_conv": lambda: F.conv2d(x_cl, w_cl, stride=stride,
                                               padding=pad),
                "conv_bwd_dx": lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [True, False, False]),
                "conv_bwd_dw": lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [False, True, False]),
            }
            # the SIMT kernels on the same inputs, timed beside the
            # route the rule takes
            simt = {
                "fused_conv": lambda: fc.fused_conv(
                    *fargs, emit=res, route="simt", **rkw),
                "conv_bwd_dx": lambda: fc.conv_bwd_dx(
                    *bargs, g=t.get("g"), route="simt", **rkw),
                "conv_bwd_dw": lambda: (fc.conv_bwd_dw(*bargs, route="simt",
                                                       **rkw),),
            }
            for kernel in CONV_KERNELS:
                launch, plain, names = calls[kernel]
                before = _route_launches()
                got, want = launch(), plain()
                torch.cuda.synchronize()
                route = None
                if kernel in ROUTED:
                    route = _route_taken(before, kernel)
                    expect = fc.conv_route(dtype, ci, co, kernel)
                    if route != expect:
                        raise AssertionError(f"{kernel} {name} "
                                             f"{DTYPE_NAMES[dtype]} took "
                                             f"{route}, not {expect}")
                err, rel = _conv_errs(names, got, want, dtype)
                sums_l2 = None
                if kernel == "fused_conv" and route == "tc" \
                        and name == CONV_HEAD:
                    exact = k1_sums_fp64(*fargs, **rkw)
                    sums_l2 = [((g.double() - e).norm() / e.norm()).item()
                               for g, e in zip(got[1:3], exact)]
                    print(f"K1 sums guard {name} bf16 route tc: relative L2 "
                          f"from fp64 sum {sums_l2[0]:.3e}, sumsq "
                          f"{sums_l2[1]:.3e} (tol {K1_SUMS_RTOL:g})",
                          flush=True)
                    if not all(math.isfinite(v) and v <= K1_SUMS_RTOL
                               for v in sums_l2):
                        raise AssertionError(f"K1 sums guard: {sums_l2} > "
                                             f"{K1_SUMS_RTOL}")
                simt_err = None
                if route == "f32":
                    again, by_simt = launch(), simt[kernel]()
                    if not all(a is None and b is None or torch.equal(a, b)
                               for a, b in zip(got, again)):
                        raise AssertionError(f"{kernel} {name} f32: a "
                                             "second launch differs")
                    # the f32 K1 gives the SIMT K1's bits (y and the sums)
                    if kernel == "fused_conv" and not all(
                            torch.equal(a, b) for a, b in zip(got, by_simt)):
                        raise AssertionError(f"fused_conv {name} f32: not "
                                             "the SIMT kernel's bits")
                    simt_err = _conv_errs(names, by_simt, want, dtype)
                    del again, by_simt
                ms = device_ms(launch)
                plain_ms = device_ms(plain)
                library_ms = device_ms(library[kernel])
                simt_ms = device_ms(simt[kernel]) if route != "simt" \
                    else None
                bound_ms, bound_by = conv_bound(kernel, case, dtype)
                r = dict(kernel=kernel, case=name, dtype=DTYPE_NAMES[dtype],
                         route=route, max_abs_err=err, err_over_max_ref=rel,
                         tol=TOLS[dtype], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, simt_ms=simt_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
                if sums_l2 is not None:
                    r["sums_rel_l2_fp64"] = sums_l2
                results.append(r)
                if simt_err is not None:    # the SIMT K2: a row of its own
                    results.append(dict(r, route="simt", ms=simt_ms,
                                        max_abs_err=simt_err[0],
                                        err_over_max_ref=simt_err[1],
                                        simt_ms=None))
                also = "" if simt_ms is None else \
                    f" simt_ms={simt_ms:.5f} (SIMT kernel)"
                print(f"kernel {kernel} {name} {r['dtype']}"
                      f"{'' if route is None else ' route ' + route}: "
                      f"max_abs_err={err:.3e} ({rel:.2e} of max|plain|, tol "
                      f"{TOLS[dtype]:g}) ms={ms:.5f} (device, CUDA graph) "
                      f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f}"
                      f" (cuDNN){also} bound_ms={bound_ms:.5f} "
                      f"({bound_by})", flush=True)
            del t, want_f, calls, library, simt
            gc.collect()
    return results


# ---------------------------------------------------------------------------
# ResNet phase
# ---------------------------------------------------------------------------
def _plain_fused_conv_bn(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                         resid=None, resid_scale=None, resid_shift=None,
                         emit_act=False):
    """``fused_conv_bn`` through the autograd of the plain forward (dense
    PyTorch, fp32 inside), with its argument defaults: the oracle."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    if resid is not None:
        a, b, resid_scale, resid_shift = fc.join_defaults(
            x, a, b, resid_scale, resid_shift)
    return fc.fused_conv_reference(x, w, a, b, stride, pad, relu, resid,
                                   resid_scale, resid_shift, emit=emit_act)


class _PlainBackward(torch.autograd.Function):
    """K1's forward values with the autograd of the plain forward as their
    gradient: the gradient oracle's reference, which follows the kernels'
    forward trajectory (the same ReLU masks and batch statistics), so the
    comparison sees K2, K3 and the autograd wiring and nothing else."""

    @staticmethod
    def forward(ctx, x, w, a, b, r, ar, br, stride, pad, relu, emit):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        ctx.save_for_backward(x, w, a, b, r, ar, br)
        ctx.conf = (stride, pad, relu, emit)
        return fc.fused_conv(x, w, a, b, stride, pad, relu, r, ar, br, emit)

    @staticmethod
    def backward(ctx, *cts):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        stride, pad, relu, emit = ctx.conf
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = fc.fused_conv_reference(*ins[:4], stride, pad, relu,
                                           *ins[4:], emit)
        grads = iter(torch.autograd.grad(
            outs, [t for t in ins if t is not None], cts, allow_unused=True))
        return tuple(None if t is None else next(grads) for t in ins) \
            + (None,) * 4


def _pinned_fused_conv_bn(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                          resid=None, resid_scale=None, resid_shift=None,
                          emit_act=False):
    """``fused_conv_bn`` with K1's values and the plain backward."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    if resid is not None:
        a, b, resid_scale, resid_shift = fc.join_defaults(
            x, a, b, resid_scale, resid_shift)
    return _PlainBackward.apply(x, w, a, b, resid, resid_scale, resid_shift,
                                stride, pad, relu, emit_act)


class swap_convs:
    """``with swap_convs(fn):`` the fused ResNet calls ``fn`` in place of
    ``fused_conv_bn`` (the swap is made here, for the oracles only)."""

    def __init__(self, fn):
        self._fn = fn

    def __enter__(self):
        from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
            fused_resnet
        self._mod = fused_resnet
        self._saved = fused_resnet.fused_conv_bn
        fused_resnet.fused_conv_bn = self._fn
        return self

    def __exit__(self, *exc):
        self._mod.fused_conv_bn = self._saved


def _conv_launches():
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {k: getattr(fc, k + "_launches") for k in CONV_KERNELS}


def _reset_conv_launches():
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    for k in CONV_KERNELS:
        setattr(fc, k + "_launches", 0)
    for k in ROUTED:
        for r in CONV_ROUTES[k]:
            setattr(fc, f"{k}_{r}_launches", 0)


def _check_launches(label, got, per_pass, forwards, backwards, routes=None,
                    route=None):
    """The window's launches against ``per_pass`` per forward and per
    backward; with ``route`` (one route, or {kernel: route}), every launch
    in ``routes`` (from ``_route_launches``) took that route."""
    want = {"fused_conv": per_pass * forwards,
            "conv_bwd_dx": per_pass * backwards,
            "conv_bwd_dw": per_pass * backwards}
    print(f"{label}: launches {got} over {forwards} forwards and "
          f"{backwards} backwards ({per_pass} each per pass: {want})"
          + ("" if route is None else f", by route {routes}"), flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    if route is not None:
        if isinstance(route, str):
            route = dict.fromkeys(ROUTED, route)
        want_r = {(k, r): want[k] if r == route[k] else 0 for k in ROUTED
                  for r in CONV_ROUTES[k]}
        if routes != want_r:
            raise AssertionError(f"{label}: launches by route {routes} != "
                                 f"{want_r}")


def convs_per_pass(net):
    """Fused convs in one forward: three per bottleneck, one more per
    downsample projection (52 for ResNet-50)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        FusedBottleneckV1

    blocks = [m for m in net.modules() if isinstance(m, FusedBottleneckV1)]
    return sum(3 + (b.bnd is not None) for b in blocks)


def _frozen(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()
            if not p.requires_grad}


def _rel_l2(got, want):
    den = want.norm().item()
    return (got - want).norm().item() / (den if den > 0 else 1.0)


def resnet_oracle(net, ce, x, y):
    """The fp32 oracle of one training step from one state, three runs:
    the kernels; the model with ``fused_conv_bn`` swapped for the autograd
    of its plain versions (loss and the running statistics after the
    forward: 1e-5); and the plain backward on K1's forward values (every
    trainable tensor's gradient: relative L2 <= GRAD_RTOL). The kernels'
    gradients against the fully plain run's are printed, not held: the two
    forwards sum in other orders, and this fp32 network at its initial
    weights turns such differences into percents of the gradients of the
    early layers."""
    def loss_fn(logits, labels):
        return ce(logits, labels).mean()

    start = _frozen(net)

    def run(fn):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        if fn is None:
            return _grads(net, loss_fn, x, y), _frozen(net)
        with swap_convs(fn):
            return _grads(net, loss_fn, x, y), _frozen(net)

    _reset_conv_launches()
    (loss, grads), stats = run(None)
    launches, routes = _conv_launches(), _route_launches()
    (ref_loss, plain_grads), ref_stats = run(_plain_fused_conv_bn)
    (_, ref_grads), _ = run(_pinned_fused_conv_bn)
    _check_launches("gradient oracle (kernel run)", launches,
                    convs_per_pass(net), 1, 1, routes,
                    conv_routes_expected(torch.float32))
    if not torch.isfinite(loss) or abs(float(loss - ref_loss)) > \
            1e-5 * abs(float(ref_loss)):
        raise AssertionError(f"oracle loss {float(loss)} != plain "
                             f"{float(ref_loss)}")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    worst, worst_plain = (0.0, ""), (0.0, "")
    for name, g, r, q in zip(names, grads, ref_grads, plain_grads):
        rel = _rel_l2(g, r)
        if not math.isfinite(rel) or rel > GRAD_RTOL:
            raise AssertionError(f"gradient oracle: {name} relative L2 "
                                 f"error {rel} > {GRAD_RTOL}")
        worst = max(worst, (rel, name))
        worst_plain = max(worst_plain, (_rel_l2(g, q), name))
    worst_stat = (0.0, "")
    for name, v in stats.items():
        r = ref_stats[name]
        err = (v - r).abs().max().item() / max(1.0, r.abs().max().item())
        if not err <= 1e-5:
            raise AssertionError(f"running statistic {name}: error {err}")
        worst_stat = max(worst_stat, (err, name))
    print(f"gradient oracle (fp32, B={x.shape[0]}, {len(names)} trainable "
          f"tensors, {len(stats)} running statistics): loss "
          f"{float(loss):.6f} vs plain {float(ref_loss):.6f}; worst "
          f"relative L2 error against the plain backward on K1's forward "
          f"{worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL:g}; against "
          f"the fully plain run {worst_plain[0]:.3e} ({worst_plain[1]}, "
          f"not held); worst running statistic {worst_stat[0]:.3e} "
          f"({worst_stat[1]}), tolerance 1e-05", flush=True)
    return dict(worst=worst[0], worst_plain=worst_plain[0],
                worst_stat=worst_stat[0], n_trainable=len(names),
                n_running_stats=len(stats))


# bf16 gradients of one step, K2/K3 against their plain versions in the
# same backward on K1's forward values: relative L2 error per trainable
# tensor. Both fold and round where the TPU kernels do; they differ in the
# order of fp32 sums, which flips a bf16 rounding of dx now and then
# (2^-9 of an element), carried down the 52 convs of the backward. 2e-2
# is the loosest the port allows itself.
BF16_GRAD_RTOL = 2e-2


class plain_conv_backward:
    """``with plain_conv_backward():`` the fused conv's autograd Functions
    call the plain versions of K2 and K3 (the swap is made here, for the
    bf16 gate only); K1 still computes the forward. cuDNN runs its
    deterministic algorithms meanwhile: the plain versions' convolution
    gradients otherwise differ from run to run in the last fp32 bits, which
    the bf16 network carries to percents in the stem's gradients (measured
    on an H100), while the kernels repeat bit for bit."""

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = (fc.conv_bwd_dx, fc.conv_bwd_dw,
                       torch.backends.cudnn.deterministic)
        fc.conv_bwd_dx = fc.conv_bwd_dx_reference
        fc.conv_bwd_dw = fc.conv_bwd_dw_reference
        torch.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        fc.conv_bwd_dx, fc.conv_bwd_dw, det = self._saved
        torch.backends.cudnn.deterministic = det


def resnet_bf16_gate(net, ce, x, y):
    """One bf16 training step from one state, three times: through K2/K3
    (the tensor-core route); through their plain versions
    (``plain_conv_backward``): every trainable tensor's gradient within
    ``BF16_GRAD_RTOL`` relative L2; and through the autograd of the plain
    forward on K1's forward values (``_pinned_fused_conv_bn``), printed,
    not held: that backward keeps dy_t in fp32 and differentiates the fp32
    accumulator where the kernels (and the TPU's) round to bf16. Returns
    the worst errors."""
    def loss_fn(logits, labels):
        return ce(logits, labels).mean()

    start = _frozen(net)

    def run(fn):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        if fn is None:
            return _grads(net, loss_fn, x, y)
        with swap_convs(fn):
            return _grads(net, loss_fn, x, y)

    _reset_conv_launches()
    loss, grads = run(None)
    launches, routes = _conv_launches(), _route_launches()
    with plain_conv_backward():
        ref_loss, ref_grads = run(None)
    _, auto_grads = run(_pinned_fused_conv_bn)
    _check_launches("bf16 gradient gate (kernel run)", launches,
                    convs_per_pass(net), 1, 1, routes, "tc")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    worst, worst_auto = (0.0, ""), (0.0, "")
    for name, g, r, q in zip(names, grads, ref_grads, auto_grads):
        rel = _rel_l2(g.float(), r.float())
        if not math.isfinite(rel) or rel > BF16_GRAD_RTOL:
            raise AssertionError(f"bf16 gradient gate: {name} relative L2 "
                                 f"error {rel} > {BF16_GRAD_RTOL}")
        worst = max(worst, (rel, name))
        worst_auto = max(worst_auto, (_rel_l2(g.float(), q.float()), name))
    print(f"bf16 gradient gate (B={x.shape[0]}, {len(names)} trainable "
          f"tensors): loss {float(loss):.6f} vs {float(ref_loss):.6f}; "
          f"worst relative L2 error against the plain K2/K3 on K1's "
          f"forward {worst[0]:.3e} ({worst[1]}), tolerance "
          f"{BF16_GRAD_RTOL:g}; against the autograd of the plain forward "
          f"{worst_auto[0]:.3e} ({worst_auto[1]}, not held)", flush=True)
    return dict(worst=worst[0], worst_name=worst[1],
                worst_autograd=worst_auto[0], n_trainable=len(names))


# The bf16 forward gate: the tensor-core K1's distance from the fp32
# forward over the SIMT K1's, held for the logits (relative L2) and the
# running statistics (worst), each at most 1 + FWD_GATE_SLACK. Both kernels
# round x_pro and y to bf16 at the same places and differ in how their fp32
# sums round, which flips a bf16 rounding now and then; 52 layers carry
# the flips on. At the net as drawn the logits' ratio lay in 0.984-1.005
# over eleven batches on an H100 and the statistics' at 1.000, while a
# kernel that lost precision or summed the wrong rows would be farther by
# multiples. After fp32 training steps the same ratio spread over
# 0.91-1.22 (six batches), too wide to hold anything by, so the gate runs
# at the net as drawn. The loss is printed, not held: one scalar whose two
# distances differ by a ratio of 0.16 to 2.95 between batches.
FWD_GATE_HELD = ("logits", "stats")
FWD_GATE_SLACK = 0.05


class force_conv_route:
    """``with force_conv_route(route):`` every ``fused_conv`` call (K1)
    names ``route`` (None: the rule's); the swap is made here, for the
    forward gate only."""

    def __init__(self, route):
        self._route = route

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = fc.fused_conv
        if self._route is not None:
            fc.fused_conv = functools.partial(self._saved, route=self._route)
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        fc.fused_conv = self._saved


def bf16_forward_distances(net, ce, x, y):
    """One training-mode forward of the bf16 net (batch statistics; the
    running statistics move) from one state, three times: through the
    tensor-core K1 (the route the rule takes); through the SIMT K1
    (``route="simt"``) on the same inputs; and in fp32, the net cast up
    (the same bf16-rounded weights, running statistics and input; the f32
    K1). Each bf16 forward's distance from the fp32 one: the loss
    (relative), the logits (relative L2) and the running statistics after
    the forward (the worst max abs error over max(1, max|fp32|)). The state
    is restored after each run. Returns ``{"tc": {...}, "simt": {...}}``
    and the number of running statistics."""
    import incubator_mxnet_tpu_torch as mx

    per_pass = convs_per_pass(net)
    start = _frozen(net)

    def run(label, route=None, fp32=False):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        _reset_conv_launches()
        if fp32:
            net.cast("float32")
        try:
            with torch.no_grad(), mx.autograd.train_mode(), \
                    force_conv_route(route):
                logits = net(x.float() if fp32 else x).float()
                loss = float(ce(logits, y).mean())
            stats = {n: v.float() for n, v in _frozen(net).items()}
        finally:
            if fp32:
                net.cast("bfloat16")
        _check_launches(f"bf16 forward gate ({label})", _conv_launches(),
                        per_pass, 1, 0, _route_launches(),
                        conv_routes_expected(torch.float32) if fp32
                        else "simt" if route == "simt" else "tc")
        return loss, logits, stats

    ref_loss, ref_logits, ref_stats = run("fp32", fp32=True)
    dist = {}
    for route in ("tc", "simt"):
        loss, logits, stats = run(route, None if route == "tc" else route)
        worst_stat = max(
            (v - ref_stats[n]).abs().max().item()
            / max(1.0, ref_stats[n].abs().max().item())
            for n, v in stats.items())
        dist[route] = dict(loss=abs(loss - ref_loss) / abs(ref_loss),
                           logits=_rel_l2(logits, ref_logits),
                           stats=worst_stat)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n in start:
                p.copy_(start[n])
    return dist, len(ref_stats)


def resnet_bf16_forward_gate(net, ce, x, y):
    """The bf16 forward gate: ``bf16_forward_distances`` on one batch; the
    tensor-core K1's distances over the SIMT K1's are printed and held as
    ``FWD_GATE_HELD`` and ``FWD_GATE_SLACK`` say. Returns both distances
    and the ratios."""
    dist, n_stats = bf16_forward_distances(net, ce, x, y)
    ratio = {k: dist["tc"][k] / max(dist["simt"][k], 1e-30)
             for k in dist["tc"]}
    held = {k: ratio[k] for k in FWD_GATE_HELD}
    print(f"bf16 forward gate (B={x.shape[0]}, training mode, "
          f"{n_stats} running statistics): distance from the fp32 "
          f"forward on the same bf16-rounded inputs, tensor-core K1 "
          + ", ".join(f"{k} {v:.4e}" for k, v in dist["tc"].items())
          + "; the SIMT K1 "
          + ", ".join(f"{k} {v:.4e}" for k, v in dist["simt"].items())
          + "; ratio " + ", ".join(f"{k} {v:.4f}" for k, v in ratio.items())
          + f" (held: {', '.join(FWD_GATE_HELD)} <= "
          f"{1 + FWD_GATE_SLACK:g}; the loss printed)", flush=True)
    if not all(math.isfinite(v) and v <= 1 + FWD_GATE_SLACK
               for v in held.values()):
        raise AssertionError(f"bf16 forward gate: the tensor-core K1 is "
                             f"farther from the fp32 forward than the SIMT "
                             f"K1: ratios {held}")
    return dict(tc=dist["tc"], simt=dist["simt"], ratio=ratio,
                n_running_stats=n_stats)


CONV_TAGS = ("fused_conv_fwd_kernel", "fused_conv_tc_kernel",
             "fused_conv_f32_kernel", "conv_bwd_dx_kernel",
             "conv_bwd_dw_kernel", "conv_bwd_dx_f32_kernel",
             "conv_bwd_dw_f32_kernel",
             "conv_bwd_dx_tc_kernel", "conv_bwd_dw_tc_kernel",
             "column_sum_kernel", "column_sums_kernel", "split_sum_kernel",
             "split_finish_kernel", "join_emit_kernel")


# batch sizes of the ResNet phase: eval, gradient oracle, learning check
# and eager steps, bench row (then its fallback)
RESNET_BATCHES = (32, 8, 16, (128, 64))


def resnet_phase(seed, card, net, ctx, hw=224, batches=RESNET_BATCHES):
    """Drive ``net`` (``fused_resnet50_v1`` from ``main``; initialized on
    ``ctx``) through eval, the gradient oracle and the training entry
    points on ``hw`` x ``hw`` images, as the module docstring says."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel

    dev = ctx.torch_device()
    per_pass = convs_per_pass(net)
    classes = net.output.weight.shape[0]
    b_eval, b_oracle, b_train, b_bench = batches
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)

    def batch(b):
        x = torch.rand((b, 3, hw, hw), generator=gen, device=dev)
        y = torch.randint(0, classes, (b,), generator=gen, device=dev)
        return x, y.float()

    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    # the fp32 gradient oracle
    x, y = batch(b_oracle)
    oracle = resnet_oracle(net, ce, x, y)

    # the bf16 forward gate, at the net as drawn (see FWD_GATE_SLACK): the
    # net cast to bf16 for it, then cast back and its fp32 values restored;
    # its batch comes from a generator of its own, so nothing after it moves
    fp32_values = {n: p.detach().clone() for n, p in net.named_parameters()}
    net.cast("bfloat16")
    gate_gen = torch.Generator(device=dev)
    gate_gen.manual_seed(seed + 41)
    xg = torch.rand((b_oracle, 3, hw, hw), generator=gate_gen, device=dev)
    yg = torch.randint(0, classes, (b_oracle,), generator=gate_gen,
                       device=dev)
    fwd_gate = resnet_bf16_forward_gate(net, ce, xg.to(torch.bfloat16),
                                        yg.float())
    net.cast("float32")
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(fp32_values[n])
    del fp32_values, xg, yg

    # the training path, counted in two windows (the eval check between
    # them is counted on its own)
    _reset_conv_launches()
    passes = 0
    x, y = batch(b_train)
    st = parallel.SPMDTrainer(net, ce, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
    losses = [float(st.step(x, y)) for _ in range(10)]
    passes += 10
    print(f"learning check (fp32 SPMDTrainer, B={b_train}, sgd lr 0.05 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the loss did not fall by 5% over 10 steps")
    st.sync_to_net()
    del st

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    eager = []
    for _ in range(2):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(x.shape[0])
        eager.append(float(per_sample.detach().mean()))
    passes += 2
    if not all(math.isfinite(v) for v in eager):
        raise AssertionError(f"gluon.Trainer losses not finite: {eager}")
    print(f"gluon.Trainer (fp32, B={b_train}, sgd lr 0.01 momentum 0.9): 2 "
          f"steps, losses {eager}", flush=True)
    del trainer
    first, first_routes = _conv_launches(), _route_launches()

    # eval logits. One training-mode forward of the eval batch (no grad)
    # with the BatchNorm momentum at 0 sets every running statistic to this
    # batch's statistics; the eval forward of the same batch must then give
    # that forward's logits (the same folded BatchNorm), and the logits of
    # the model with fused_conv_bn swapped for the plain versions
    x, _ = batch(b_eval)
    momenta = {m: m._momentum for m in net.modules()
               if hasattr(m, "_momentum")}
    _reset_conv_launches()
    try:
        for m in momenta:
            m._momentum = 0.0
        with torch.no_grad(), mx.autograd.train_mode():
            train_logits = net(x)
    finally:
        for m, v in momenta.items():
            m._momentum = v
    with mx.autograd.pause():
        logits = net(x)
    eval_launches, eval_routes = _conv_launches(), _route_launches()
    with mx.autograd.pause(), swap_convs(_plain_fused_conv_bn):
        want = net(x)
    torch.cuda.synchronize()
    eval_err = _rel_l2(logits, want)
    self_err = _rel_l2(logits, train_logits)
    print(f"eval logits (fp32, B={b_eval}, running statistics of this "
          f"batch): shape {tuple(logits.shape)}, max |logit| "
          f"{want.abs().max().item():.4g}; relative L2 error against the "
          f"plain swap {eval_err:.3e}, against the training-mode forward "
          f"{self_err:.3e} (tol {TOLS[torch.float32]:g} each)", flush=True)
    if logits.shape != want.shape or not torch.isfinite(logits).all() \
            or max(eval_err, self_err) > TOLS[torch.float32]:
        raise AssertionError("eval logits disagree with the plain path or "
                             "with the training-mode forward")
    _check_launches("eval", eval_launches, per_pass, 2, 0, eval_routes,
                    conv_routes_expected(torch.float32))
    _check_launches("fp32 training path (SPMDTrainer, gluon.Trainer)",
                    first, per_pass, passes, passes, first_routes,
                    conv_routes_expected(torch.float32))

    # bf16: the gradient gate, a learning check, then (e) the bench row:
    # B=128, SPMDTrainer SGD lr 0.1 momentum 0.9; K2/K3 on the tensor cores
    net.cast("bfloat16")
    gc.collect()
    x, y = batch(b_oracle)
    bf16_gate = resnet_bf16_gate(net, ce, x.to(torch.bfloat16), y)
    _reset_conv_launches()
    bf16_passes = 0
    x, y = batch(b_train)
    x = x.to(torch.bfloat16)
    st = parallel.SPMDTrainer(net, ce, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
    bf16_learning = [float(st.step(x, y)) for _ in range(10)]
    bf16_passes += 10
    print(f"bf16 learning check (SPMDTrainer, B={b_train}, sgd lr 0.05 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in bf16_learning]}", flush=True)
    if not all(math.isfinite(v) for v in bf16_learning) \
            or not bf16_learning[-1] < 0.95 * bf16_learning[0]:
        raise AssertionError("the bf16 loss did not fall by 5% over 10 "
                             "steps")
    st.sync_to_net()
    del st
    gc.collect()
    bench = None
    for b in b_bench:
        xb, yb = batch(b)
        xb = xb.to(torch.bfloat16)
        st = parallel.SPMDTrainer(net, ce, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
        for _ in range(2):
            st.step(xb, yb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        bf16_losses = [st.step(xb, yb) for _ in range(5)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        peak = torch.cuda.max_memory_allocated(dev)
        bf16_passes += 7
        if not all(torch.isfinite(v) for v in bf16_losses):
            raise AssertionError("bf16 SPMDTrainer loss not finite")
        print(f"bf16 SPMDTrainer step (B={b}, sgd lr 0.1 "
              f"momentum 0.9; {card}): {step_ms:.3f} ms per step (host "
              f"clock, 5 steps after 2 warmup), {b / step_ms * 1e3:.1f} "
              f"images/s, peak memory {peak / 2**20:.1f} MiB", flush=True)
        bench = dict(batch=b, step_ms=step_ms, images_s=b / step_ms * 1e3,
                     peak_bytes=peak)
        if step_ms <= 2000.0 or b == b_bench[-1]:   # the last one stays
            break
        print(f"the B={b} step took over 2 s: the row drops to the next "
              "batch size", flush=True)
        del st
    rows = _profile_step(st.step, xb, yb, card, bench["step_ms"],
                         tags=CONV_TAGS, top=16)
    bf16_passes += 1
    second, second_routes = _conv_launches(), _route_launches()
    _check_launches("bf16 training path (learning check, bench row)",
                    second, per_pass, bf16_passes, bf16_passes,
                    second_routes, "tc")
    launches = {k: first[k] + second[k] for k in CONV_KERNELS}
    routes = {k: first_routes[k] + second_routes[k] for k in first_routes}
    return dict(launches=launches, routes=routes,
                eval_launches=eval_launches, eval_routes=eval_routes,
                per_pass=per_pass,
                passes=passes + bf16_passes, bf16_passes=bf16_passes,
                oracle=oracle, learning_losses=losses, eval_err=eval_err,
                bf16_fwd_gate=fwd_gate, bf16_gate=bf16_gate,
                bf16_learning_losses=bf16_learning,
                bench=bench, profile=rows[:16])



def resnet_main(seed, card):
    """The ResNet phase on ``fused_resnet50_v1``: 1000 classes, 224x224,
    52 fused convs per pass, 161 trainable tensors, 106 running
    statistics."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    t0 = time.perf_counter()
    net = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=ctx)
    nparams = sum(p.numel() for p in net.parameters())
    print(f"model fused_resnet50_v1: {nparams} parameters, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = resnet_phase(seed, card, net, ctx)
    if (out["per_pass"], out["oracle"]["n_trainable"],
            out["oracle"]["n_running_stats"]) != (52, 161, 106):
        raise AssertionError("fused_resnet50_v1 runs 52 fused convs per "
                             "pass and has 161 trainable tensors and 106 "
                             "running statistics")
    return out


# ---------------------------------------------------------------------------
# unfused ResNet phase: the zoo resnet50_v1 of the gluon layer set (bench.py's
# resnet50 row), and the MLP phase (bench.py's mlp row)
# ---------------------------------------------------------------------------
# the unfused model against the fused one, fp32, same weights: eval logits,
# the training loss and the running statistics (relative), each gradient
# (relative L2: the JAX package's own bound between the two models on a
# chip, tests/test_fused_resnet.py)
UNFUSED_TOL = 1e-4
UNFUSED_GRAD_RTOL = 5e-2
# batch sizes of the unfused phase: the parity check, the learning check,
# the bench row
UNFUSED_BATCHES = (8, 16, 128)


def zoo_to_fused(zoo, fused):
    """Set ``fused``'s parameters (NHWC/HWIO) to ``zoo``'s (NCHW/OIHW), on
    the device, as the JAX package's ``tests/test_fused_resnet.py``
    ``_build_pair`` maps them: the two inventories in order, conv weights
    OIHW -> HWIO. Returns the pairs of names."""
    zp = list(zoo.collect_params().items())
    fp = list(fused.collect_params().items())
    if len(zp) != len(fp):
        raise AssertionError(f"{len(zp)} zoo tensors against {len(fp)} "
                             "fused ones")
    with torch.no_grad():
        for (zn, z), (fn, f) in zip(zp, fp):
            v = z.detach().permute(2, 3, 1, 0) if z.dim() == 4 \
                else z.detach()
            if tuple(v.shape) != tuple(f.shape):
                raise AssertionError(f"{zn} {tuple(z.shape)} does not map "
                                     f"to {fn} {tuple(f.shape)}")
            fused.set_param(fn, v.contiguous().clone())
    return [(zn, fn) for (zn, _), (fn, _) in zip(zp, fp)]


def unfused_parity(zoo, fused, ce, x, y):
    """One fp32 training step of ``zoo`` and of ``fused`` (its weights
    mapped from ``zoo``'s) from the same state: the loss and every running
    statistic within ``UNFUSED_TOL`` (largest difference over the largest
    value), every gradient within ``UNFUSED_GRAD_RTOL`` relative L2; then
    a training-mode forward of each at BatchNorm momentum 0 (the running
    statistics become this batch's) and the eval logits within
    ``UNFUSED_TOL`` relative L2. The zoo model's passes launch no fused conv kernel.
    Returns the worst distances."""
    import incubator_mxnet_tpu_torch as mx

    pairs = zoo_to_fused(zoo, fused)
    zps, fps = zoo.collect_params(), fused.collect_params()
    out = {}
    _reset_conv_launches()
    for net in (zoo, fused):
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
        loss.backward()
        out[net] = loss.item()
        if net is zoo:
            zoo_launches = _conv_launches()
    loss_err = abs(out[zoo] - out[fused]) / abs(out[fused])
    stats, grads = (0.0, ""), (0.0, "")
    n_stats = n_grads = 0
    for zn, fn in pairs:
        z, f = zps[zn], fps[fn]
        if z.requires_grad:
            g = f.grad.permute(3, 2, 0, 1) if f.dim() == 4 else f.grad
            grads = max(grads, (_rel_l2(z.grad, g), zn))
            n_grads += 1
        else:
            stats = max(stats, (_rel_l2(z.detach(), f.detach()), zn))
            n_stats += 1
    momenta = {m: m._momentum for net in (zoo, fused)
               for m in net.modules() if hasattr(m, "_momentum")}
    try:
        for m in momenta:
            m._momentum = 0.0
        with torch.no_grad(), mx.autograd.train_mode():
            zoo(x), fused(x)
    finally:
        for m, v in momenta.items():
            m._momentum = v
    with mx.autograd.pause():
        logits_err = _rel_l2(zoo(x), fused(x))
    res = dict(loss=out[zoo], fused_loss=out[fused], loss_err=loss_err,
               stats_worst=stats[0], stats_worst_name=stats[1],
               grad_worst=grads[0], grad_worst_name=grads[1],
               eval_logits_err=logits_err, n_trainable=n_grads,
               n_running_stats=n_stats, zoo_launches=zoo_launches)
    print(f"unfused vs fused (fp32, B={x.shape[0]}, same weights): loss "
          f"{out[zoo]:.6f} vs {out[fused]:.6f} (relative {loss_err:.3e}); "
          f"worst of the {n_stats} running statistics {stats[0]:.3e} "
          f"relative L2 ({stats[1]}), tol {UNFUSED_TOL:g}; worst of the "
          f"{n_grads} "
          f"gradients {grads[0]:.3e} relative L2 ({grads[1]}), tol "
          f"{UNFUSED_GRAD_RTOL:g}; eval logits {logits_err:.3e} relative "
          f"L2, tol "
          f"{UNFUSED_TOL:g}; fused conv launches over the unfused passes "
          f"{zoo_launches}", flush=True)
    if not (loss_err <= UNFUSED_TOL and stats[0] <= UNFUSED_TOL
            and logits_err <= UNFUSED_TOL and grads[0] <= UNFUSED_GRAD_RTOL
            and math.isfinite(out[zoo])):
        raise AssertionError("the unfused ResNet disagrees with the fused "
                             "one")
    if any(zoo_launches.values()):
        raise AssertionError("the unfused ResNet launched a fused conv "
                             f"kernel: {zoo_launches}")
    for net in (zoo, fused):
        for p in net.parameters():
            p.grad = None
    return res


def _bench_steps(st, x, y, steps=5, warmup=2):
    """Host-clock ms per ``st.step`` over ``steps`` after ``warmup``, and
    the peak memory of those steps."""
    for _ in range(warmup):
        st.step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [st.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not all(torch.isfinite(v) for v in losses):
        raise AssertionError("bench row: loss not finite")
    return step_ms, torch.cuda.max_memory_allocated(), \
        [float(v) for v in losses]


def _idle(rows, step_ms):
    total = sum(r[0] for r in rows)
    return None if total == 0 else max(0.0, 1 - total / step_ms)


def unfused_resnet_phase(seed, card, net, fused, ctx, hw=224,
                         batches=UNFUSED_BATCHES):
    """Drive ``net`` (the zoo ``resnet50_v1`` from ``unfused_resnet_main``,
    initialized on ``ctx``, deferred shapes filled) as the module
    docstring says: the parity check against ``fused`` (a fused ResNet of
    the same architecture), the fp32 learning check through
    ``gluon.Trainer(..., kvstore="device")``, then bench.py's resnet50 row
    in bf16 (NCHW, then the activations and conv weights in
    ``torch.channels_last`` memory format). No fused conv kernel may
    launch on the unfused passes."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel

    dev = ctx.torch_device()
    b_parity, b_train, b_bench = batches
    classes = net.output.weight.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 53)

    def batch(b):
        x = torch.rand((b, 3, hw, hw), generator=gen, device=dev)
        y = torch.randint(0, classes, (b,), generator=gen, device=dev)
        return x, y.float()

    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    parity = unfused_parity(net, fused, ce, *batch(b_parity))

    # the fp32 learning check: eager record -> backward -> gluon.Trainer
    _reset_conv_launches()
    x, y = batch(b_train)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9},
                            kvstore="device")
    losses = []
    for _ in range(6):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(x.shape[0])
        losses.append(float(per_sample.detach().mean()))
    print(f"unfused learning check (fp32 gluon.Trainer kvstore='device', "
          f"B={b_train}, sgd lr 0.01 momentum 0.9, one batch repeated): "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the unfused loss did not fall by 5% over 5 "
                             "steps")
    del trainer
    _check_launches("unfused fp32 learning check", _conv_launches(), 0, 6,
                    6, _route_launches(), "f32")

    # bench.py's resnet50 row: bf16, SPMDTrainer SGD lr 0.1 momentum 0.9
    net.cast("bfloat16")
    gc.collect()
    x, y = batch(b_bench)
    x = x.to(torch.bfloat16)
    rows = {}
    _reset_conv_launches()
    for layout in ("nchw", "channels_last"):
        if layout == "channels_last":
            with torch.no_grad():
                for p in net.parameters():
                    if p.dim() == 4:
                        p.data = p.data.contiguous(
                            memory_format=torch.channels_last)
            x = x.contiguous(memory_format=torch.channels_last)
        st = parallel.SPMDTrainer(net, ce, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
        step_ms, peak, bench_losses = _bench_steps(st, x, y)
        prof = _profile_step(st.step, x, y, card, step_ms, tags=(),
                             top=12, what=f"unfused bf16 step ({layout})")
        rows[layout] = dict(batch=b_bench, step_ms=step_ms,
                            images_s=b_bench / step_ms * 1e3,
                            peak_bytes=peak, idle=_idle(prof, step_ms),
                            device_ms=sum(r[0] for r in prof),
                            losses=bench_losses, profile=prof[:12])
        print(f"unfused bf16 SPMDTrainer step ({layout}, B={b_bench}, sgd "
              f"lr 0.1 momentum 0.9; {card}): {step_ms:.3f} ms per step "
              f"(host clock, 5 steps after 2 warmup), "
              f"{rows[layout]['images_s']:.1f} images/s, peak memory "
              f"{peak / 2**20:.1f} MiB", flush=True)
        del st
        gc.collect()
    _check_launches("unfused bf16 bench row (both layouts)", _conv_launches(),
                    0, 16, 16, _route_launches(), "tc")
    return dict(parity=parity, learning_losses=losses, bench=rows)


def unfused_resnet_main(seed, card):
    """The unfused phase on ``get_model("resnet50_v1", classes=1000)``,
    held against ``fused_resnet50_v1`` with the same weights."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_model("resnet50_v1", classes=1000).initialize("xavier",
                                                           ctx=ctx)
    with mx.autograd.pause():              # fills the deferred shapes
        net(torch.zeros(2, 3, 224, 224, device=ctx.torch_device()))
    ps = net.collect_params()
    counts = (sum(p.numel() for p in ps.values()),
              sum(p.requires_grad for p in ps.values()),
              sum(not p.requires_grad for p in ps.values()),
              sum(p.dim() == 4 for p in ps.values()))
    print(f"model resnet50_v1 (unfused, NCHW): {counts[0]} parameters "
          f"with the running statistics, {counts[1]} trainable tensors, "
          f"{counts[2]} running statistics, {counts[3]} convs", flush=True)
    if counts != (25_610_152, 161, 106, 53):
        raise AssertionError(f"resnet50_v1's inventory {counts}")
    fused = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=ctx)
    out = unfused_resnet_phase(seed, card, net, fused, ctx)
    out["inventory"] = counts
    return out


# bench.py's mlp row: B=8192, 784 -> 512 -> 512 -> 10
MLP_BATCH = 8192


def mlp_phase(seed, card, ctx, b=MLP_BATCH, steps=20):
    """bench.py's mlp row at one card: ``HybridSequential`` of
    ``Dense(512, activation="relu")`` twice and ``Dense(10)`` (no
    ``in_units``), ``initialize("xavier")``, ``cast("bfloat16")``, one
    forward of zeros that fills the deferred shapes, then
    ``SPMDTrainer`` SGD lr 0.1 momentum 0.9 on one batch of ``b`` uniform
    images whose labels a fixed random linear map of the image picks (a
    task the net can learn; the row's random labels fall under 5% in
    tens of steps): the loss must fall by 5% over ``steps`` steps; then
    timed (5 steps after 2 warmup)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon import nn

    dev = ctx.torch_device()
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(512, activation="relu"),
            nn.Dense(512, activation="relu"), nn.Dense(10))
    net.initialize("xavier", ctx=ctx)
    net.cast("bfloat16")
    net(torch.zeros(2, 784, dtype=torch.bfloat16, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 61)
    x = torch.rand((b, 784), generator=gen, device=dev)
    proj = torch.randn((784, 10), generator=gen, device=dev)
    y = ((x - 0.5) @ proj).argmax(1).float()
    x = x.to(torch.bfloat16)
    st = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    losses = [float(st.step(x, y)) for _ in range(steps)]
    print(f"MLP learning check (bf16 SPMDTrainer, B={b}, sgd lr 0.1 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError(f"the MLP loss did not fall by 5% over "
                             f"{steps} steps")
    step_ms, peak, _ = _bench_steps(st, x, y)
    print(f"MLP bf16 SPMDTrainer step (B={b}, 784-512-512-10; {card}): "
          f"{step_ms:.4f} ms per step (host clock, 5 steps after 2 warmup), "
          f"{b / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    prof = _profile_step(st.step, x, y, card, step_ms, tags=(), top=8,
                         what="MLP bf16 step")
    return dict(batch=b, learning_losses=losses, step_ms=step_ms,
                images_s=b / step_ms * 1e3, peak_bytes=peak,
                idle=_idle(prof, step_ms),
                device_ms=sum(r[0] for r in prof))


# ---------------------------------------------------------------------------
# graph phase: the step engines on CUDA graphs (parallel/superstep.py)
# ---------------------------------------------------------------------------
# window K of each row
GRAPH_K = {"mlp": 20, "gpt": 10, "resnet50_fused": 5, "resnet50_unfused": 5}
# windows a row times after the one that captures
GRAPH_TIMED = 2


def _counts_by_name(counts):
    """``ops.launches`` counts keyed by counter name (``flash_fwd_tc``,
    ``conv_bwd_dw``, ...; ``rtc:<kernel>``), zeros left out."""
    return {(f"rtc:{name}" if mod == "rtc"
             else name[:-len("_launches")]): n
            for (mod, name), n in sorted(counts.items()) if n}


def _launch_delta(before):
    from incubator_mxnet_tpu_torch.ops import launches

    return _counts_by_name(launches.delta(before, launches.snapshot()))


def _worst_rel(pairs):
    """The largest relative L2 distance over ``(name, got, want)``."""
    worst = (0.0, "")
    for name, got, want in pairs:
        got, want = got.float(), want.float()
        den = want.norm().item()
        rel = (got - want).norm().item() / (den if den > 0 else 1.0)
        worst = max(worst, (rel, name))
    return worst


def _replay_span_ms(fn, *args):
    """Device time from the first to the last kernel of ``fn(*args)``
    (CUDA events on the current stream; the host waits after)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _check_graph_launches(label, per_step, expect):
    """Each counter of ``expect`` launched exactly so often a step."""
    for name, want in expect.items():
        if per_step.get(name, 0) != want:
            raise AssertionError(f"graph {label}: {name} launched "
                                 f"{per_step.get(name, 0)} times a "
                                 f"step, not {want}")


def _kernel_counts(rows, symbols):
    """Launches by CUDA function in ``_profile_step``'s rows (the
    profiler's own count: the kernels that ran on the card, inside a
    graph replay too), for each name of ``symbols``."""
    out = {}
    for sym in symbols:
        pat = re.compile(rf"(?<![\w]){re.escape(sym)}(?![\w])")
        out[sym] = sum(count for _, count, key in rows if pat.search(key))
    return out


def _check_profiled(label, rows, kernels, steps):
    """The profiler saw each CUDA function of ``kernels`` (name ->
    launches a step) launched exactly ``steps`` times as often."""
    got = _kernel_counts(rows, kernels)
    want = {sym: n * steps for sym, n in kernels.items()}
    print(f"profiled launches of {label}: {got} (want {want})", flush=True)
    if got != want:
        raise AssertionError(f"{label}: the profiler saw {got}, not {want}")


class ClockSampler:
    """The card's SM clock and power draw, sampled every ``ms`` by
    ``nvidia-smi`` in the background while the block runs; ``between(t0,
    t1)`` gives the median of the samples in a window of ``time.time()``
    (the timestamps are nvidia-smi's own, on the same clock). Without
    ``nvidia-smi`` there are no samples ("not measured")."""

    def __init__(self, ms=20):
        self.ms = ms
        self.samples = []
        self._proc = None

    def __enter__(self):
        import threading
        from datetime import datetime

        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.ms}",
                 "-i", "0"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self

        def read():
            for line in self._proc.stdout:
                try:
                    ts, clk, watts = (f.strip() for f in line.split(","))
                    t = datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f")
                    self.samples.append((t.timestamp(), float(clk),
                                         float(watts)))
                except ValueError:
                    continue

        self._reader = threading.Thread(target=read, daemon=True)
        self._reader.start()
        time.sleep(0.3)                 # nvidia-smi's first sample
        return self

    def __exit__(self, *exc):
        if self._proc is not None:
            time.sleep(2 * self.ms / 1e3)
            self._proc.terminate()
            try:
                self._proc.wait(5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._reader.join(5)
        return False

    def between(self, windows):
        """``(median SM MHz, median W, samples)`` over the samples inside
        any of ``windows`` (``(t0, t1)`` pairs), or None."""
        got = [(c, w) for t, c, w in self.samples
               if any(t0 <= t <= t1 for t0, t1 in windows)]
        if not got:
            return None
        return (float(np.median([c for c, _ in got])),
                float(np.median([w for _, w in got])), len(got))


def _clock_text(reading):
    if reading is None:
        return "SM clock not measured"
    mhz, watts, n = reading
    return f"SM clock {mhz:.0f} MHz at {watts:.1f} W (median of {n})"


# alternating eager and graph turns a row times, after the first window
GRAPH_ROUNDS = 5


def graph_row(label, make, wins, card, seed, expect, kernels=None,
              tags=()):
    """One row of the graph phase. ``make()`` gives a fresh
    ``SPMDTrainer`` (the same start state each call), ``wins`` at least
    ``1 + GRAPH_TIMED`` windows ``(data, labels)`` of K batches on the
    device; ``expect``: launch counter name -> launches a step;
    ``kernels``: CUDA function -> launches a step.

    From the same state and seed, K eager ``step()`` calls and one
    ``run_superstep`` (warm-up step, capture, one replay) on the first
    window: the [K] losses and every parameter and running statistic bit
    for bit. The launch counters: the K eager steps count ``expect`` a
    step; the capture records K steps' worth and counts nothing; the first
    ``run_superstep`` counts K + 1 steps (the warm-up ran), every later
    one K (each graph call's own counter change, measured around it and
    summed into ``launches``). Then ``GRAPH_ROUNDS`` alternating turns
    (K eager steps, one graph window) on the next windows give host ms a
    step, the median of each; the peak memory above what the row held
    before (the eager turn of the first round; the graph's first call);
    a profile (``torch.profiler``) of K eager steps and of one graph
    window: device time a step, idle share against the medians, and the
    profiler's own launch count of each of ``kernels`` (K a step in both:
    the kernels ran on the card); the SM clock and power of each kind of
    turn and profile (``ClockSampler``); the device span of a replay
    (CUDA events)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import launches

    kernels = kernels or {}
    k = int(wins[0][0].shape[0])
    x0, y0 = wins[0]
    eager = make()
    mx.random.seed(seed)
    c0 = launches.snapshot()
    ref = torch.stack([eager.step(x0[i], y0[i]) for i in range(k)])
    eager_counts = _launch_delta(c0)
    per_step = {n: c // k for n, c in eager_counts.items()}
    if any(c % k for c in eager_counts.values()):
        raise AssertionError(f"graph {label}: K={k} eager steps launched "
                             f"{eager_counts}, not K times a step's")
    _check_graph_launches(label, per_step, expect)

    graph = make()
    mx.random.seed(seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total = {}

    def graph_call(fn, *args, windows=1, warm=0):
        """``fn(*args)``, its own launch counts gated (``windows`` graph
        windows and ``warm`` eager warm-up steps) and summed into
        ``total``."""
        c = launches.snapshot()
        out = fn(*args)
        got = _launch_delta(c)
        want = {n: v * (k * windows + warm) for n, v in per_step.items()}
        if got != want:
            raise AssertionError(f"graph {label}: a call of {windows} "
                                 f"window(s) and {warm} warm-up step(s) "
                                 f"launched {got}, not {want}")
        for n, v in got.items():
            total[n] = total.get(n, 0) + v
        return out

    t0 = time.perf_counter()
    got = graph_call(graph.run_superstep, x0, y0, warm=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() - base
    entries = graph._graphs.graphs()
    capture_counts = _counts_by_name(entries[0].counted) if entries \
        else {}
    if entries and capture_counts != {n: v * k for n, v in
                                      per_step.items()}:
        raise AssertionError(f"graph {label}: the capture recorded "
                             f"{capture_counts}, not K={k} steps of "
                             f"{per_step}")

    equal = torch.equal(ref, got) and all(
        torch.equal(eager.params[n], graph.params[n]) for n in eager.params)
    worst = _worst_rel([("losses", got, ref)] + [
        (n, graph.params[n], eager.params[n]) for n in eager.params])
    print(f"graph {label}: K={k}, one run_superstep (warm-up, capture, one "
          f"replay) in {first_s:.2f} s; [K] losses and "
          f"{len(eager.params)} parameter tensors against K eager step() "
          f"calls: {'bit-equal' if equal else 'NOT bit-equal'} (worst "
          f"relative L2 {worst[0]:.3e}, {worst[1] or '-'}); launches a "
          f"step {per_step}, recorded by the capture {capture_counts}",
          flush=True)
    if not equal:
        raise AssertionError(f"graph {label}: the graph path is not "
                             f"bit-equal to K eager steps ({worst})")

    timed = wins[1:1 + GRAPH_TIMED]
    turns = {"eager": [], "graph": []}
    spans = {"eager": [], "graph": [], "eager_profile": [],
             "graph_profile": []}
    eager_peak = 0
    with ClockSampler() as clocks:
        for r in range(GRAPH_ROUNDS):
            x, y = timed[r % len(timed)]
            torch.cuda.synchronize()
            if r == 0:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            w0, t0 = time.time(), time.perf_counter()
            for i in range(k):
                eager.step(x[i], y[i])
            torch.cuda.synchronize()
            turns["eager"].append((time.perf_counter() - t0) * 1e3 / k)
            spans["eager"].append((w0, time.time()))
            if r == 0:
                eager_peak = torch.cuda.max_memory_allocated() - base
            w0, t0 = time.time(), time.perf_counter()
            losses = graph_call(graph.run_superstep, x, y)
            torch.cuda.synchronize()
            turns["graph"].append((time.perf_counter() - t0) * 1e3 / k)
            spans["graph"].append((w0, time.time()))
        eager_ms = float(np.median(turns["eager"]))
        graph_ms = float(np.median(turns["graph"]))
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"graph {label}: a loss is not finite")
        x1, y1 = timed[0]
        span_ms = _replay_span_ms(graph_call, graph.run_superstep, x1, y1)

        def eager_window(x, y):
            for i in range(k):
                eager.step(x[i], y[i])

        w0 = time.time()
        prof_e = _profile_step(eager_window, x1, y1, card, eager_ms * k,
                               tags=tags, top=6,
                               what=f"{label} eager window (K={k})")
        spans["eager_profile"].append((w0, time.time()))
        w0 = time.time()
        prof_g = _profile_step(
            lambda x, y: graph_call(graph.run_superstep, x, y), x1, y1,
            card, graph_ms * k, tags=tags, top=6,
            what=f"{label} graph window (K={k})")
        spans["graph_profile"].append((w0, time.time()))
    clock = {kind: clocks.between(w) for kind, w in spans.items()}
    if kernels:
        _check_profiled(f"{label} eager window", prof_e, kernels, k)
        _check_profiled(f"{label} graph window", prof_g, kernels, k)
    dev_e = sum(r[0] for r in prof_e) / k
    dev_g = sum(r[0] for r in prof_g) / k
    print(f"graph {label} ({card}): eager step() {eager_ms:.4f} ms per "
          f"step, graph path {graph_ms:.4f} ms per step (host clock, "
          f"median of {GRAPH_ROUNDS} alternating turns of {k} steps: eager "
          f"{[round(t, 4) for t in turns['eager']]}, graph "
          f"{[round(t, 4) for t in turns['graph']]}); device time "
          f"{dev_e:.4f} ms a step eager (idle "
          f"{100 * (_idle(prof_e, eager_ms * k) or 0):.1f}%), {dev_g:.4f} "
          f"ms a step in the graph (idle "
          f"{100 * (_idle(prof_g, graph_ms * k) or 0):.1f}%), a replay's "
          f"device span {span_ms / k:.4f} ms a step; peak memory above the "
          f"row's baseline: eager {eager_peak / 2**20:.1f} MiB, graph "
          f"(warm-up, capture, replay) {graph_peak / 2**20:.1f} MiB; "
          f"eager turns {_clock_text(clock['eager'])}, graph turns "
          f"{_clock_text(clock['graph'])}, eager profile "
          f"{_clock_text(clock['eager_profile'])}, graph profile "
          f"{_clock_text(clock['graph_profile'])}; launches on the graph "
          f"path (every graph call of the row, measured) {total}",
          flush=True)
    return dict(k=k, eager_ms=eager_ms, graph_ms=graph_ms,
                eager_turns_ms=turns["eager"], graph_turns_ms=turns["graph"],
                eager_device_ms=dev_e, graph_device_ms=dev_g,
                eager_idle=_idle(prof_e, eager_ms * k),
                graph_idle=_idle(prof_g, graph_ms * k),
                replay_span_ms=span_ms / k, eager_peak_bytes=eager_peak,
                graph_peak_bytes=graph_peak, first_call_s=first_s,
                per_step=per_step, per_capture=capture_counts,
                clocks=clock, launches=total)


def _windows(n, make_batch):
    """``n`` windows, each a stacked ``(data, labels)`` of K batches."""
    out = []
    for _ in range(n):
        xs, ys = zip(*make_batch())
        out.append((torch.stack(xs), torch.stack(ys)))
    return out


def gluon_superstep_row(seed, card, net, wins):
    """The gluon SuperStep (``Trainer.superstep``) on ``net`` with sgd and
    momentum: the fused path (one replay a window on the card) against
    its eager path (``MXTPU_SUPERSTEP=0``: forward, backward,
    ``Trainer.step(1)``) from the same weights and seed over the first
    window, bit for bit, then host ms a step of each over the others."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.config import config

    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for mode, knob in (("graph", "auto"), ("eager", "0")):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(start[n])
        config.set("MXTPU_SUPERSTEP", knob)
        try:
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
            eng = tr.superstep(net, ce, window=int(wins[0][0].shape[0]))
            mx.random.seed(seed)
            first = eng.run_window(*wins[0])
            params = {n: p.detach().clone()
                      for n, p in net.named_parameters()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y in wins[1:]:
                last = eng.run_window(x, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / sum(
                int(x.shape[0]) for x, _ in wins[1:])
        finally:
            config.unset("MXTPU_SUPERSTEP")
        if not bool(torch.isfinite(last).all()):
            raise AssertionError("gluon superstep: a loss is not finite")
        out[mode] = dict(first=first, params=params, ms=ms,
                         dispatches=eng.dispatch_count,
                         fallback=eng.last_fallback)
    g, e = out["graph"], out["eager"]
    equal = torch.equal(g["first"], e["first"]) and all(
        torch.equal(g["params"][n], e["params"][n]) for n in g["params"])
    print(f"gluon SuperStep (MLP, sgd lr 0.1 momentum 0.9, K="
          f"{wins[0][0].shape[0]}; {card}): fused {g['ms']:.4f} ms per step "
          f"({g['dispatches']} dispatches), eager path {e['ms']:.4f} ms per "
          f"step ({e['fallback']}); first window "
          f"{'bit-equal' if equal else 'NOT bit-equal'}", flush=True)
    if not equal or g["dispatches"] != len(wins) or e["dispatches"] != 0 \
            or g["fallback"] is not None:
        raise AssertionError(f"gluon superstep: fused against eager "
                             f"{equal}, dispatches {g['dispatches']}/"
                             f"{e['dispatches']}, {g['fallback']}")
    return dict(graph_ms=g["ms"], eager_ms=e["ms"], k=int(wins[0][0].shape[0]))


def fresh_thread_capture(dev, n=32, h=56, c=64):
    """K3 (the weight gradient, TMA-fed) and K1 captured in a CUDA graph on
    a thread that never ran an encode, at ResNet-50's 3x3 64->64 56x56
    shape, fp32 and bf16: the replay equals the eager calls bit for bit
    (the encoder binds the thread's context with libcuda calls, which a
    capture allows)."""
    import threading

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, h, h, c, generator=gen, device=dev).to(dtype)
        w = (torch.randn(3, 3, c, c, generator=gen, device=dev) / 24
             ).to(dtype)
        a = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.5
        y = fc.fused_conv(x, w, a, b, 1, 1, True)[0]
        dy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
        z = torch.zeros(c, device=dev)
        args = (x, w, a, b, y, dy, z, z, 1, 1, True)
        want = (fc.conv_bwd_dw(*args), fc.fused_conv(x, w, a, b, 1, 1,
                                                     True)[0])
        torch.cuda.synchronize()
        res = {}

        def run():
            try:
                side = torch.cuda.Stream()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=side):
                    got = (fc.conv_bwd_dw(*args),
                           fc.fused_conv(x, w, a, b, 1, 1, True)[0])
                g.replay()
                torch.cuda.synchronize()
                res["got"] = got
            except Exception as e:  # re-raised on this thread
                res["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in res:
            raise AssertionError(f"capture on a fresh thread failed "
                                 f"({DTYPE_NAMES[dtype]}): {res['err']}")
        ok = all(torch.equal(g, r) for g, r in zip(res["got"], want))
        out[DTYPE_NAMES[dtype]] = ok
        if not ok:
            raise AssertionError(f"the fresh-thread capture of K3/K1 "
                                 f"({DTYPE_NAMES[dtype]}) differs from the "
                                 f"eager calls")
    print(f"fresh-thread capture: K3 and K1 at B={n}, {h}x{h}, {c}->{c} "
          f"captured on a new thread and replayed, bit-equal to the eager "
          f"calls in fp32 and bf16", flush=True)
    return out


def graph_phase(seed, card, ctx, mlp_b=MLP_BATCH, gpt=("gpt_decoder_117m",
                50257, 8, 256, {}), resnet_b=128, hw=224,
                resnet_layers=None, k=None):
    """The graph phase (the module docstring's phase 10): each row's
    ``SPMDTrainer.run_superstep`` over windows of distinct synthetic
    batches drawn from ``seed`` against K eager steps (``graph_row``), the
    gluon SuperStep on the MLP, and the fresh-thread capture. Sizes are
    the rows' own unless a test passes small ones (``gpt``: spec name,
    vocab, B, T, extra spec keys; ``resnet_layers``: (layers, channels)
    of a small ResNet of both kinds; ``k``: window K for every row)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.model_zoo import (get_gpt,
                                                          get_model, vision)

    dev = ctx.torch_device()
    gk = {row: (k or kk) for row, kk in GRAPH_K.items()}
    n_win = 1 + GRAPH_TIMED
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 71)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    rows = {}

    # the MLP row (bench.py's mlp: bf16, B=8192, 784-512-512-10)
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(512, activation="relu"),
            nn.Dense(512, activation="relu"), nn.Dense(10))
    net.initialize("xavier", ctx=ctx)
    net.cast("bfloat16")
    net(torch.zeros(2, 784, dtype=torch.bfloat16, device=dev))

    def mlp_batch():
        return [(torch.rand((mlp_b, 784), generator=gen, device=dev).to(
            torch.bfloat16), torch.randint(0, 10, (mlp_b,), generator=gen,
                                           device=dev).float())
                for _ in range(gk["mlp"])]

    wins = _windows(n_win, mlp_batch)
    rows["mlp"] = graph_row(
        "mlp", lambda: parallel.SPMDTrainer(
            net, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        wins, card, seed, expect={})
    rows["mlp_gluon_superstep"] = gluon_superstep_row(seed, card, net, wins)
    del net, wins
    gc.collect()

    # the GPT bf16 row: dropout as built
    name, vocab, b, t, spec = gpt
    mx.random.seed(seed)
    net = get_gpt(name, vocab_size=vocab, max_length=t, **spec).initialize(
        "xavier", ctx=ctx)
    net.cast("bfloat16")
    layers = net.num_layers

    def lm_loss(logits, labels):
        return ce(logits, labels).mean()

    def gpt_batch():
        return [(torch.randint(0, vocab, (b, t), generator=gen, device=dev,
                               dtype=torch.int32),
                 torch.randint(0, vocab, (b, t), generator=gen,
                               device=dev).float())
                for _ in range(gk["gpt"])]

    rows["gpt"] = graph_row(
        "gpt", lambda: parallel.SPMDTrainer(
            net, lm_loss, "sgd", {"learning_rate": 1e-4, "momentum": 0.9}),
        _windows(n_win, gpt_batch), card, seed,
        expect={f"{kern}{route}": layers for kern in COUNTERS
                for route in ("", "_tc")},
        kernels={f"{kern}_tc_kernel": layers for kern in COUNTERS},
        tags=FLASH_TAGS)
    del net
    gc.collect()

    # the fused and unfused ResNet-50 rows (bf16, B=128; unfused in
    # channels-last memory format)
    if resnet_layers is None:
        fused = get_model("fused_resnet50_v1", classes=1000)
        zoo = get_model("resnet50_v1", classes=1000)
    else:
        lay, chans = resnet_layers
        fused = vision.FusedResNetV1(lay, chans, classes=10)
        zoo = vision.ResNetV1(vision.BottleneckV1, lay, chans, classes=10)
    for row, net in (("resnet50_fused", fused), ("resnet50_unfused", zoo)):
        mx.random.seed(seed)
        net.initialize("xavier", ctx=ctx)
        with mx.autograd.pause():             # fills deferred shapes
            net(torch.zeros(2, 3, hw, hw, device=dev))
        net.cast("bfloat16")
        classes = net.output.weight.shape[0]
        channels_last = row == "resnet50_unfused"
        if channels_last:
            with torch.no_grad():
                for p in net.parameters():
                    if p.dim() == 4:
                        p.data = p.data.contiguous(
                            memory_format=torch.channels_last)

        def resnet_batch(k_row=gk[row], cl=channels_last, nc=classes):
            out = []
            for _ in range(k_row):
                x = torch.rand((resnet_b, 3, hw, hw), generator=gen,
                               device=dev).to(torch.bfloat16)
                y = torch.randint(0, nc, (resnet_b,), generator=gen,
                                  device=dev).float()
                out.append((x, y))
            return out

        wins = _windows(n_win, resnet_batch)
        if channels_last:       # each batch of the window channels-last
            wins = [(x.permute(0, 1, 3, 4, 2).contiguous().permute(
                0, 1, 4, 2, 3), y) for x, y in wins]
        per_pass = convs_per_pass(net) if row == "resnet50_fused" else 0
        expect = {f"{kern}_tc": per_pass for kern in CONV_KERNELS} \
            if per_pass else {}
        expect.update({kern: per_pass for kern in CONV_KERNELS})
        rows[row] = graph_row(
            row, lambda n=net: parallel.SPMDTrainer(
                n, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9}),
            wins, card, seed, expect=expect,
            kernels={f"{kern}_tc_kernel": per_pass
                     for kern in CONV_KERNELS} if per_pass else None,
            tags=CONV_TAGS if per_pass else ())
        rows[row]["per_pass"] = per_pass
        del wins
        gc.collect()
    del fused, zoo
    gc.collect()
    rows["fresh_thread"] = fresh_thread_capture(dev) \
        if dev.type == "cuda" else None
    return rows


# ---------------------------------------------------------------------------
# imperative phase: mx.nd, mx.operator and mx.rtc (K7)
# ---------------------------------------------------------------------------
RTC_KERNELS = ("scale", "saxpy", "first_row", "softmax_ce_fwd",
               "softmax_ce_bwd")
# gpt_decoder_117m's parameter count at max_length 1024: the flat vector
# scale and saxpy run over
RTC_FLAT = 163_037_184
RTC_HEAD = "softmax_ce_fwd"
# softmax_ce_fwd: probabilities, a sum of exponentials in another order;
# held elementwise relative to the plain version's, since most of them are
# far below any absolute bound worth holding (median 1e-8 at 4*randn logits)
RTC_FWD_RTOL = 1e-5
# the imperative step's gradients against the plain loss's: relative L2
IMPERATIVE_GRAD_RTOL = 1e-4
# K7's cases beside the path's own shapes: softmax_ce_fwd over a row longer
# than the resident limit (streamed) and over small odd rows (and, with
# req="add", at the path's shape); scale over a flat vector less 3 floats
# on views at these float offsets of a larger buffer
RTC_SOFTMAX_SHAPES = ((256, 100003), (5, 7), (3, 4099))
RTC_SCALE_OFFSETS = (1, 3)


def _rtc_counts(reset=False):
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    out = {}
    for name in RTC_KERNELS:
        key = rk.KERNELS[name].lookup
        out[name] = rtc.launches[key]
        if reset:
            rtc.launches[key] = 0
    return out


def rtc_bound(name, shape, req="write"):
    """Least time (ms) of one rtc kernel call and what bounds it: each
    input read once, each output written once (fp32; int32 labels), and
    the fp32 operations at 67 TFLOP/s (scale 1, saxpy 2, softmax_ce_fwd 5
    per element: max, subtract, exp, sum, divide; softmax_ce_bwd 1).
    ``req="add"`` (softmax_ce_fwd) also reads the output and adds."""
    if name == "first_row":
        nbytes, flops = 2 * shape[1] * 4, 0          # one row in, one out
    else:
        n = math.prod(shape)
        nbytes, flops = {"scale": (2 * n * 4, n),
                         "saxpy": (3 * n * 4, 2 * n),
                         "softmax_ce_fwd": (2 * n * 4, 5 * n),
                         "softmax_ce_bwd": (2 * n * 4 + shape[0] * 4, n)}[name]
        if req == "add":
            nbytes, flops = nbytes + n * 4, flops + n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_rel_err(got, want):
    """Largest ``|got - want| / |want|``; 0 where both are 0, inf where
    only ``want`` is."""
    rel = (got - want).abs() / want.abs()
    return torch.nan_to_num(rel, nan=0.0, posinf=math.inf).max().item()


def _ce_bwd_ms(logits, labels):
    """Device ms of ``F.cross_entropy``'s backward (sum): a CUDA graph of
    forward + ``autograd.grad`` less a graph of the forward alone."""
    import torch.nn.functional as F

    lg = logits.detach().requires_grad_(True)
    lab = labels.long()

    def fwd():
        return F.cross_entropy(lg, lab, reduction="sum")

    def fwd_bwd():
        return torch.autograd.grad(fwd(), lg)

    both = device_ms(fwd_bwd)
    return both - device_ms(fwd), both


def _plan_text(plan):
    return (f"{'resident' if plan.resident else 'streamed'}: "
            f"{plan.threads} threads, {plan.shared_bytes} bytes of shared "
            "memory")


def rtc_cases(gen, dev, path_shape, flat, softmax_shapes=RTC_SOFTMAX_SHAPES,
              offsets=RTC_SCALE_OFFSETS):
    """K7's cases beside the path, each held against its plain version
    (softmax_ce_fwd 1e-5 relative, scale and saxpy bit for bit) and timed
    beside its plain version, one library call (none for req="add") and
    its bound:
    softmax_ce_fwd at each of ``softmax_shapes`` and, with req="add", at
    ``path_shape``, each with its plan (resident or streamed); scale over
    ``flat - 3`` floats on views of a larger buffer at each of ``offsets``,
    into a new array (x and y at two alignment phases: single floats) and
    into a view at x's offset (one phase: a head, 16-byte quads, a
    tail); saxpy over the same views, a at each offset with b and out
    aligned (three pointers at two phases: single floats) and all three at
    the offset into a view (a head, quads, a tail). Launches made here are
    not counted. Any failure raises."""
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    limit = rk.smem_optin(dev)
    cases = []

    def check(case, name, shape, got, want, tol, call, plain, library,
              bound, **extra):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _max_rel_err(got, want)
        if got.shape != want.shape or not math.isfinite(err) or rel > tol:
            raise AssertionError(f"rtc {case}: max relative err {rel} > "
                                 f"{tol}")
        ms, plain_ms = device_ms(call), device_ms(plain)
        library_ms = device_ms(library) if library else None
        lib_txt = "none" if library_ms is None else f"{library_ms:.5f}"
        bound_ms, bound_by = bound
        print(f"kernel rtc case {case} {name} {tuple(shape)} fp32: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:g} "
              f"relative) ms={ms:.5f} (device, CUDA graph) "
              f"plain_ms={plain_ms:.5f} library_ms={lib_txt} "
              f"bound_ms={bound_ms:.5f} ({bound_by})"
              + "".join(f"; {k} {v}" for k, v in extra.items()
                        if k != "plan"), flush=True)
        cases.append(dict(case=case, name=name, shape=list(shape),
                          max_abs_err=err, max_rel_err=rel, rel_tol=tol,
                          ms=ms, timing="cuda_graph", plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, **extra))

    for shape, req in ([(sh, "write") for sh in softmax_shapes]
                       + [(tuple(path_shape), "add")]):
        x = NDArray(4 * torch.randn(shape, generator=gen, device=dev))
        y0 = torch.rand(shape, generator=gen, device=dev) if req == "add" \
            else torch.zeros(shape, device=dev)
        y = NDArray(y0.clone())
        plan = rk.softmax_ce_fwd_plan(shape[1], limit)
        print(f"softmax_ce_fwd plan {shape} (req {req}): "
              f"{_plan_text(plan)}", flush=True)
        rk.softmax_ce_fwd(x, y, req)
        want = rk.softmax_ce_fwd_reference(x.as_torch())
        if req == "add":
            want = y0 + want
        check(f"softmax_ce_fwd_{req}_{shape[0]}x{shape[1]}",
              "softmax_ce_fwd", shape, y.as_torch(), want, RTC_FWD_RTOL,
              lambda: rk.softmax_ce_fwd(x, y, req),
              (lambda: rk.softmax_ce_fwd_reference(x.as_torch()))
              if req == "write" else
              (lambda: y0 + rk.softmax_ce_fwd_reference(x.as_torch())),
              (lambda: torch.softmax(x.as_torch(), -1))
              if req == "write" else None,
              rtc_bound("softmax_ce_fwd", shape, req), req=req,
              plan=plan._asdict())
        del x, y, y0, want
    n = flat - 3
    buf = torch.randn(flat + 1, generator=gen, device=dev)
    out = torch.zeros(flat + 1, device=dev)
    for off in offsets:
        x = NDArray(buf[off:off + n])
        want = rk.scale_reference(x.as_torch(), 0.5)
        y = rk.scale(x, 0.5)
        check(f"scale_view{off}_new_out", "scale", (n,), y.as_torch(), want,
              0.0, lambda: rk.scale(x, 0.5),
              lambda: rk.scale_reference(x.as_torch(), 0.5),
              lambda: torch.mul(x.as_torch(), 0.5), rtc_bound("scale", (n,)),
              offset_x=off, offset_y=0)
        y = NDArray(out[off:off + n])

        def into_view():                # the kernel itself: x's phase
            if x.ctx.device_type == "cpu":  # the CPU rehearsal
                y.as_torch().copy_(rk.scale_reference(x.as_torch(), 0.5))
            else:
                rk.kernel("scale").launch([x, y, 0.5, n], x.ctx,
                                          *rk.scale_plan(n))
        into_view()
        check(f"scale_view{off}_view_out", "scale", (n,), y.as_torch(),
              want, 0.0, into_view,
              lambda: rk.scale_reference(x.as_torch(), 0.5),
              lambda: torch.mul(x.as_torch(), 0.5, out=y.as_torch()),
              rtc_bound("scale", (n,)), offset_x=off, offset_y=off)
        del x, y, want
    # saxpy over the same views: a at the offset with b and out aligned
    # (several phases: single floats), and all three at the offset into a
    # view (one phase: a head, 16-byte quads, a tail)
    bbuf = torch.randn(flat + 1, generator=gen, device=dev)
    for off in offsets:
        a = NDArray(buf[off:off + n])
        for label, b, y in (
                ("mixed", NDArray(bbuf[:n]), NDArray(out[:n])),
                ("view_out", NDArray(bbuf[off:off + n]),
                 NDArray(out[off:off + n]))):
            want = rk.saxpy_reference(a.as_torch(), b.as_torch(), 2.0)

            def launch(a=a, b=b, y=y):      # the kernel itself, into y
                if a.ctx.device_type == "cpu":  # the CPU rehearsal
                    y.as_torch().copy_(rk.saxpy_reference(
                        a.as_torch(), b.as_torch(), 2.0))
                else:
                    rk.kernel("saxpy").launch([a, b, y, 2.0, n], a.ctx,
                                              *rk.saxpy_plan(n))
            launch()
            check(f"saxpy_view{off}_{label}", "saxpy", (n,), y.as_torch(),
                  want, 0.0, launch,
                  lambda a=a, b=b: rk.saxpy_reference(a.as_torch(),
                                                      b.as_torch(), 2.0),
                  lambda a=a, b=b, y=y: torch.add(
                      b.as_torch(), a.as_torch(), alpha=2.0,
                      out=y.as_torch()),
                  rtc_bound("saxpy", (n,)), offset_a=off,
                  offset_b=0 if label == "mixed" else off,
                  offset_out=0 if label == "mixed" else off)
            del b, y, want
        del a
    del buf, bbuf, out
    gc.collect()
    return cases


def _check_imperative_launches(rtc_got, rtc_want, flash_got, flash_want,
                               routes_got, routes_want):
    print(f"launches on the imperative path: rtc {rtc_got} (want "
          f"{rtc_want}); flash {flash_got} (want {flash_want} each); by "
          f"route {routes_got} (want {routes_want})", flush=True)
    if rtc_got != rtc_want or any(v != flash_want
                                  for v in flash_got.values()) \
            or routes_got != routes_want:
        raise AssertionError("imperative path: launch counts differ")


def imperative_phase(seed, card, net, ctx, b=8, flat=RTC_FLAT, lr=3e-4,
                     conv_case=None, softmax_shapes=RTC_SOFTMAX_SHAPES):
    """The imperative front door on a GPT decoder ``net`` (dropout 0) at
    B=``b`` and T=its ``max_length``: the main path (an mx.rtc program of
    scale/saxpy/first_row over a ``flat``-element vector and the size of
    the net's embedding, then the imperative training step whose loss is
    the ``softmax_ce_rtc`` custom op, with its gradient oracle, learning
    check and timing), counted; then (a) the five rtc kernels against
    their plain versions and timed, (b) K7's cases beside the path
    (``rtc_cases``, with ``softmax_shapes``), (c) the registered kernel
    ops through ``invoke`` against the direct calls, bit for bit
    (``conv_case``: a ``CONV_CASES`` entry, default the conv kernel
    phase's head case)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    dev = ctx.torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    t, vocab = net.max_length, net.vocab_size
    heads, head_dim = net.num_heads, net.head_dim
    units, n_rows = heads * head_dim, b * net.max_length
    params = [p for p in net.parameters() if p.requires_grad]
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    rs = np.random.RandomState(seed + 5)
    tokens = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx)
    labels = mx.nd.array(rs.randint(0, vocab, (n_rows,)), ctx=ctx)
    lab = labels.as_torch().long()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def rtc_inputs():
        def randn(*shape):
            return NDArray(torch.randn(shape, generator=gen, device=dev))
        return randn(flat), randn(flat), randn(vocab, units)

    def rtc_program(x, y, emb):
        """The user program of mx.rtc kernels: scale, saxpy, first_row."""
        out = dict(scale=rk.scale(x, 0.5))
        out["saxpy"] = rk.saxpy(out["scale"], y, 2.0)
        out["first_row"] = rk.first_row(emb)
        return out

    def rtc_step():
        """record -> net(NDArray) -> Custom(softmax_ce_rtc) -> backward;
        returns the mean cross entropy of this forward."""
        with mx.autograd.record():
            logits = net(tokens)
            probs = mx.nd.Custom(logits.reshape((-1, vocab)), labels,
                                 op_type="softmax_ce_rtc")
        probs.backward()
        p = probs.as_torch()
        return -torch.log(p[torch.arange(n_rows, device=dev), lab]).mean()

    # the main path, counted: every count set to 0 just before and read
    # just after. The mx.rtc program, its results held against the plain
    # versions; then the plain loss's step (the oracle's reference) and
    # the imperative steps: the oracle's, 5 learning steps, 3 timed steps
    torch.cuda.synchronize()
    _rtc_counts(reset=True)
    _reset_launches(fa)
    x, y, emb = rtc_inputs()
    program = rtc_program(x, y, emb)
    for name, want_t in (
            ("scale", rk.scale_reference(x.as_torch(), 0.5)),
            ("saxpy", rk.saxpy_reference(program["scale"].as_torch(),
                                         y.as_torch(), 2.0)),
            ("first_row", rk.first_row_reference(emb.as_torch()))):
        if not torch.equal(program[name].as_torch(), want_t):
            raise AssertionError(f"rtc program: {name} differs from its "
                                 "plain version")
        del want_t
    print(f"rtc program (scale, saxpy over {flat} fp32, first_row of "
          f"({vocab}, {units})): equal to the plain versions bit for bit",
          flush=True)
    del x, y, emb, program
    gc.collect()
    with mx.autograd.record():
        plain = ce(net(tokens).reshape((-1, vocab)), labels)
    plain.backward()                       # head of ones: the summed loss
    plain_loss = plain.as_torch().detach().mean().item()
    plain_grads = [p.grad.clone() for p in params]
    del plain
    loss0 = rtc_step()
    rtc_steps, passes = 1, 2
    worst = (0.0, "")
    for name, g, p in zip(names, plain_grads, params):
        rel = _rel_l2(p.grad, g)
        if not math.isfinite(rel) or rel > IMPERATIVE_GRAD_RTOL:
            raise AssertionError(f"imperative step: {name} gradient "
                                 f"relative L2 error {rel} > "
                                 f"{IMPERATIVE_GRAD_RTOL} against the plain "
                                 "loss")
        worst = max(worst, (rel, name))
    print(f"imperative step oracle (fp32, {len(names)} parameter tensors): "
          f"mean cross entropy {loss0.item():.6f} (softmax_ce_rtc) vs "
          f"{plain_loss:.6f} (SoftmaxCrossEntropyLoss, summed); worst "
          f"gradient relative L2 error {worst[0]:.3e} ({worst[1]}), "
          f"tolerance {IMPERATIVE_GRAD_RTOL:g}", flush=True)
    if abs(loss0.item() - plain_loss) > 1e-5 * abs(plain_loss):
        raise AssertionError("imperative step: the loss differs from the "
                             "plain loss's")
    del plain_grads
    # learning: the same step with gluon.Trainer (adam), one batch
    losses = [loss0.item()]
    trainer.step(n_rows)
    for _ in range(5):
        losses.append(rtc_step().item())
        trainer.step(n_rows)
    rtc_steps += 5
    passes += 5
    print(f"imperative learning check (fp32, gluon.Trainer adam lr {lr:g}, "
          f"one batch repeated): mean cross entropy "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("imperative step: the loss did not fall by 5% "
                             "over 5 steps")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        rtc_step()
        trainer.step(n_rows)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = torch.cuda.max_memory_allocated(dev)
    rtc_steps += 3
    passes += 3
    launches = _rtc_counts()
    flash = _read_launches(fa)
    flash_routes = _read_routes(fa)
    print(f"imperative step (fp32, B={b}, T={t}, record -> net -> "
          f"Custom(softmax_ce_rtc) -> backward -> gluon.Trainer adam; "
          f"{card}): {step_ms:.3f} ms per step (host clock, 3 steps), peak "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    # every pass fp32: K4 where the rule sends T (f32 at 256), K5/K6 on
    # f32, 12 a pass each
    _check_imperative_launches(
        launches, dict(scale=1, saxpy=1, first_row=1,
                       softmax_ce_fwd=rtc_steps, softmax_ce_bwd=rtc_steps),
        flash, net.num_layers * passes, flash_routes,
        training_routes(passes, 0, net.num_layers, t, head_dim))

    # beside it (not counted): the same step on tensors with the plain loss,
    # and a profile of one imperative step
    x_t, y_t = tokens.as_torch(), labels.as_torch()

    def tensor_step(*_):
        with mx.autograd.record():
            loss = ce(net(x_t).reshape(-1, vocab), y_t)
        mx.autograd.backward(loss)
        trainer.step(n_rows)

    tensor_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        tensor_step()
    torch.cuda.synchronize()
    tensor_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"the same step on tensors with SoftmaxCrossEntropyLoss (fp32; "
          f"{card}): {tensor_ms:.3f} ms per step (host clock, 3 steps after "
          f"1 warmup) against {step_ms:.3f} ms imperative", flush=True)
    profile = _profile_step(lambda *_: (rtc_step(), trainer.step(n_rows)),
                            None, None, card, step_ms,
                            tags=("softmax_ce_fwd", "softmax_ce_bwd")
                            + FLASH_TAGS, top=12,
                            what="fp32 imperative step")

    # (a) each rtc kernel against its plain version, then timed (launches
    # made here are not counted)
    x, y, emb = rtc_inputs()
    program = rtc_program(x, y, emb)
    logits = NDArray(4 * torch.randn(n_rows, vocab, generator=gen,
                                     device=dev))
    probs = NDArray(torch.zeros_like(logits.as_torch()))
    dx = NDArray(torch.zeros_like(logits.as_torch()))
    rk.softmax_ce_fwd(logits, probs)
    rk.softmax_ce_bwd(labels, probs, dx)
    got = dict(program, softmax_ce_fwd=probs, softmax_ce_bwd=dx)
    plain = {
        "scale": lambda: rk.scale_reference(x.as_torch(), 0.5),
        "saxpy": lambda: rk.saxpy_reference(program["scale"].as_torch(),
                                            y.as_torch(), 2.0),
        "first_row": lambda: rk.first_row_reference(emb.as_torch()),
        "softmax_ce_fwd": lambda: rk.softmax_ce_fwd_reference(
            logits.as_torch()),
        "softmax_ce_bwd": lambda: rk.softmax_ce_bwd_reference(
            labels.as_torch(), probs.as_torch()),
    }
    calls = {"scale": lambda: rk.scale(x, 0.5),
             "saxpy": lambda: rk.saxpy(program["scale"], y, 2.0),
             "first_row": lambda: rk.first_row(emb),
             "softmax_ce_fwd": lambda: rk.softmax_ce_fwd(logits, probs),
             "softmax_ce_bwd": lambda: rk.softmax_ce_bwd(labels, probs, dx)}
    # one PyTorch call computing the same function, timed only
    library = {
        "scale": lambda: torch.mul(x.as_torch(), 0.5),
        "saxpy": lambda: torch.add(y.as_torch(), program["scale"].as_torch(),
                                   alpha=2.0),
        "first_row": lambda: torch.clone(emb.as_torch()[0]),
        "softmax_ce_fwd": lambda: torch.softmax(logits.as_torch(), -1),
    }
    shapes = {"scale": (flat,), "saxpy": (flat,), "first_row": (vocab, units),
              "softmax_ce_fwd": (n_rows, vocab),
              "softmax_ce_bwd": (n_rows, vocab)}
    rows = {}
    for name in RTC_KERNELS:
        want_t = plain[name]()
        got_t = got[name].as_torch()
        torch.cuda.synchronize()
        err = (got_t - want_t).abs().max().item()
        rel = _max_rel_err(got_t, want_t)
        # softmax_ce_fwd relative to the plain version, the rest bit for bit
        tol = RTC_FWD_RTOL if name == "softmax_ce_fwd" else 0.0
        if got_t.shape != want_t.shape or not math.isfinite(err) \
                or rel > tol:
            raise AssertionError(f"rtc {name}: max relative err {rel} > "
                                 f"{tol}")
        del want_t
        ms = device_ms(calls[name])
        plain_ms = device_ms(plain[name])
        ce_both = None
        if name == "softmax_ce_bwd":
            library_ms, ce_both = _ce_bwd_ms(logits.as_torch(),
                                             labels.as_torch())
        else:
            library_ms = device_ms(library[name])
        bound_ms, bound_by = rtc_bound(name, shapes[name])
        rows[name] = dict(
            name=name, source="incubator_mxnet_tpu_torch/csrc/rtc/"
            + rk.KERNELS[name].source + ".cu",
            lookup=rk.KERNELS[name].lookup, shape=list(shapes[name]),
            launches=launches[name], max_abs_err=err, max_rel_err=rel,
            rel_tol=tol, ms=ms, timing="cuda_graph", plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        lib_txt = f"{library_ms:.5f}"
        if ce_both is not None:
            lib_txt += (f" (F.cross_entropy backward; forward + backward "
                        f"{ce_both:.5f})")
        print(f"kernel rtc {name} {shapes[name]} fp32: max_abs_err="
              f"{err:.3e} max_rel_err={rel:.3e} (tol {tol:g} relative) "
              f"ms={ms:.5f} (device, CUDA graph) "
              f"plain_ms={plain_ms:.5f} library_ms={lib_txt} bound_ms="
              f"{bound_ms:.5f} ({bound_by}); launches on the path "
              f"{launches[name]}", flush=True)
    if dev.type == "cuda":
        # first_row's floor: the graph replay of a launch that does nothing
        empty = mx.rtc.CudaModule(
            'extern "C" __global__ void empty_kernel(int n) {}').get_kernel(
                "empty_kernel", "int n")
        empty_ms = device_ms(lambda: empty.launch([0], ctx, (1, 1, 1),
                                                  (32, 1, 1)))
        rows["first_row"]["empty_kernel_ms"] = empty_ms
        print(f"an empty kernel (launch floor): ms={empty_ms:.5f} (device, "
              f"CUDA graph) beside first_row's "
              f"{rows['first_row']['ms']:.5f}", flush=True)
    plan = rk.softmax_ce_fwd_plan(vocab, rk.smem_optin(dev))
    print(f"softmax_ce_fwd plan {shapes['softmax_ce_fwd']} (the path's): "
          f"{_plan_text(plan)}", flush=True)
    rows["softmax_ce_fwd"]["plan"] = plan._asdict()
    del x, y, emb, program, got, plain, calls, library, logits, probs, dx
    gc.collect()

    # (b) K7's cases beside the path
    cases = rtc_cases(gen, dev, (n_rows, vocab), flat, softmax_shapes)

    # (c) the registered kernel ops through invoke equal the direct calls
    q, k, v, g = (torch.randn(b, heads, t, head_dim, generator=gen,
                              device=dev) for _ in range(4))
    direct = [z.clone().requires_grad_(True) for z in (q, k, v)]
    out = fa.flash_attention(*direct, causal=True)
    torch.autograd.backward(out, g)
    nds = [NDArray(z.clone()) for z in (q, k, v)]
    for z in nds:
        z.attach_grad()
    with mx.autograd.record():
        out_nd = mx.nd.flash_attention(*nds, causal=True)
    out_nd.backward(NDArray(g))
    same_fa = torch.equal(out_nd.as_torch(), out.detach()) and all(
        torch.equal(z.grad.as_torch(), w.grad) for z, w in zip(nds, direct))
    case = conv_case or next(c for c in CONV_CASES if c[0] == CONV_HEAD)
    stride, pad = _conv_dims(case)[6:8]
    ti = _conv_inputs(case, torch.float32, dev, gen)
    ins = [ti[key] for key in ("x", "w", "a", "b")]
    heads_g = [ti["dy"], ti["ds"], ti["dss"]]
    direct = [z.clone().requires_grad_(True) for z in ins]
    outs = fc.fused_conv_bn(*direct, stride=stride, pad=pad, relu=True)
    torch.autograd.backward(outs, heads_g)
    nds = [NDArray(z.clone()) for z in ins]
    for z in nds:
        z.attach_grad()
    with mx.autograd.record():
        outs_nd = mx.nd.invoke_op("fused_conv_bn", *nds, stride=stride,
                                  pad=pad, relu=True)
    mx.autograd.backward(list(outs_nd), [NDArray(h) for h in heads_g])
    same_conv = all(torch.equal(a.as_torch(), o.detach())
                    for a, o in zip(outs_nd, outs)) and all(
        torch.equal(z.grad.as_torch(), w.grad) for z, w in zip(nds, direct))
    print(f"registered kernel ops through invoke: mx.nd.flash_attention "
          f"(B={b}, H={heads}, T={t}, D={head_dim}, causal; output and dq, "
          f"dk, dv) {'equal' if same_fa else 'DIFFER from'} the direct call "
          f"bit for bit; invoke_op('fused_conv_bn') at {case[0]} (y, sum, "
          f"sumsq and dx, dw, da, db) "
          f"{'equal' if same_conv else 'DIFFER from'} the direct call bit "
          "for bit", flush=True)
    if not (same_fa and same_conv):
        raise AssertionError("a registered kernel op through invoke differs "
                             "from its direct call")
    return dict(rows=rows, rtc_cases=cases, launches=launches,
                flash_launches=flash, flash_routes=flash_routes,
                passes=passes, rtc_steps=rtc_steps, n_params=len(names),
                grad_worst_rel=worst[0], learning_losses=losses,
                step_ms=step_ms, tensor_step_ms=tensor_ms, peak_bytes=peak,
                profile=profile[:12])


def imperative_main(seed, card):
    """The imperative phase on ``gpt_decoder_117m`` at ``max_length`` 256
    (12 layers, 768 units, vocab 50257; 149 trainable tensors)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    out = imperative_phase(seed, card, net, ctx)
    if out["n_params"] != 149:
        raise AssertionError("gpt_decoder_117m has 149 trainable tensors")
    return out


def _entry(name, source, replaces, launches, cases, head_case,
           dtype="fp32"):
    """A kernel's record: its numbers at ``head_case`` in ``dtype``, and
    (an fp32 head) the bf16 head case's under ``"bf16"``."""
    def head_of(dt):
        return next((r for r in cases if r["case"] == head_case
                     and r["dtype"] == dt), None)

    head = head_of(dtype)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in cases
                                if r["dtype"] == dtype),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "shape": head_case,
             "dtype": dtype, "cases": cases}
    bf16 = head_of("bf16") if dtype == "fp32" else None
    if bf16 is not None:
        entry["bf16"] = {k: bf16[k] for k in ("ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")}
    return entry


# the bf16 conv and flash kernels, which must run on the tensor cores and
# load through TMA, and their sources
TC_KERNELS = ("fused_conv_tc_kernel", "conv_bwd_dx_tc_kernel",
              "conv_bwd_dw_tc_kernel", "flash_fwd_tc_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
TC_SOURCES = ("fused_conv_tc", "conv_bwd_tc", "flash_fwd_tc",
              "flash_bwd_tc")
# the fp32 kernels on the FP32 pipes (no HGMMA, tiles by TMA), with their
# instantiations: the flash backward and forward (D 64 and 128), the conv
# forward, input gradient and weight gradient (one tap or a row of 3 taps
# a block); their sources
F32_KERNELS = {"flash_bwd_dq_f32_kernel": 2, "flash_bwd_dkv_f32_kernel": 2,
               "flash_fwd_f32_kernel": 2, "fused_conv_f32_kernel": 1,
               "conv_bwd_dx_f32_kernel": 1, "conv_bwd_dw_f32_kernel": 2}
F32_SOURCES = ("flash_bwd_f32", "flash_fwd_f32", "fused_conv_f32",
               "conv_bwd_f32")


def kernel_sass():
    """``tools/torch_ptxas_report.py fused_conv_tc conv_bwd_tc flash_fwd_tc
    flash_bwd_tc flash_bwd_f32 flash_fwd_f32 fused_conv_f32 conv_bwd_f32``,
    printed:
    registers, spills, and the HGMMA (wgmma) and UTMALDG (TMA)
    instructions in each kernel's SASS; raises unless every tensor-core
    instantiation has both, every instantiation of the fp32 kernels
    (``F32_KERNELS``, as many instantiations as it names) has UTMALDG and no
    HGMMA, and none spills."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools"
                             / "torch_ptxas_report.py"), *TC_SOURCES,
         *F32_SOURCES],
        capture_output=True, text=True, timeout=300, check=True).stdout
    print(out.rstrip(), flush=True)
    rows = [ln for ln in out.splitlines()
            if any(k in ln for k in TC_KERNELS) and "Used" in ln]
    if {k for k in TC_KERNELS if any(k in ln for ln in rows)} \
            != set(TC_KERNELS) or any(" HGMMA 0" in ln or "UTMALDG 0" in ln
                                      or "SASS" not in ln for ln in rows):
        raise AssertionError("a tensor-core kernel without HGMMA or "
                             "UTMALDG in its SASS")
    f32 = [ln for ln in out.splitlines()
           if any(k in ln for k in F32_KERNELS) and "Used" in ln]
    if len(f32) != sum(F32_KERNELS.values()) \
            or {k for k in F32_KERNELS if any(k in ln for ln in f32)} \
            != set(F32_KERNELS) \
            or any(" HGMMA 0," not in ln or "UTMALDG 0" in ln for ln in f32):
        raise AssertionError(f"the fp32 kernels' SASS: {f32}")
    spills = [ln for ln in out.splitlines()
              if any(k in ln for k in TC_KERNELS + tuple(F32_KERNELS))
              and "spill" in ln
              and not re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", ln)]
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    print(f"SASS: {len(rows)} tensor-core kernels with HGMMA and UTMALDG, "
          f"{len(f32)} fp32 kernels on the FP32 pipes with UTMALDG, no spills "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if importlib.util.find_spec("incubator_mxnet_tpu_torch") is None:
        # the script alone, without the repository beside it
        print("chip_smoke: the port (incubator_mxnet_tpu_torch) is not "
              "importable: run the script from the root of the repository",
              file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    kernel_sass()
    t0 = time.perf_counter()
    for name in RTC_KERNELS:                 # NVRTC, or the cubin cache
        rk.kernel(name)
    print(f"build: the rtc kernels {list(RTC_KERNELS)} (NVRTC, sm_90a "
          f"cubins) in {time.perf_counter() - t0:.1f} s", flush=True)

    kernel = kernel_phase(args.seed)
    bwd = backward_kernel_phase(args.seed)
    conv = conv_kernel_phase(args.seed)
    served = slice_phase(args.seed, card)
    gc.collect()
    trained = train_phase(args.seed, card)
    gc.collect()
    resnet = resnet_main(args.seed, card)
    gc.collect()
    unfused = unfused_resnet_main(args.seed, card)
    gc.collect()
    mlp = mlp_phase(args.seed, card, mx.gpu(0))
    gc.collect()
    graph = graph_phase(args.seed, card, mx.gpu(0))
    gc.collect()
    imperative = imperative_main(args.seed, card)

    src = "incubator_mxnet_tpu_torch/csrc/"
    ref = "incubator_mxnet_tpu/ops/pallas_attention.py:"
    train_case = BWD_HEAD
    # K4 by route: the f32 kernel carries fp32 training, the imperative
    # step and the longer fp32 prefills, the SIMT kernel the prefills of 32
    # rows or fewer, the tensor-core kernel bf16 training (the bench row;
    # the gate), the split kernels the decode steps; launches: the sum over
    # the main paths (serving, training, the imperative step), each read
    # in its own windows; the gate and train -> decode stand in
    # launches_by_path alone
    record = {"kernels": []}
    for route, source, head, dtype in (
            ("simt", "flash_fwd.cu", FWD_HEAD, "fp32"),
            ("f32", "flash_fwd_f32.cu", FWD_HEAD, "fp32"),
            ("tc", "flash_fwd_tc.cu", FWD_HEAD, "bf16"),
            ("split", "flash_fwd_split.cu", FWD_DECODE, "fp32")):
        name = "flash_fwd" if route == "simt" else f"flash_fwd_{route}"
        by_path = {
            "decode": served["routes"][route],
            "train": trained["routes"][f"flash_fwd_{route}"],
            "imperative": imperative["flash_routes"][f"flash_fwd_{route}"],
            "gpt_graph": graph["gpt"]["launches"].get(f"flash_fwd_{route}",
                                                      0)}
        main_paths = sum(by_path.values())
        by_path["train_to_decode"] = trained["decode_routes"][route]
        if route == "tc":
            by_path["bf16_gate"] = trained["gate_launches"]["flash_fwd_tc"]
        entry = _entry(name, src + source, ref + "54", main_paths,
                       [r for r in kernel if r["route"] == route], head,
                       dtype)
        row = next(r for r in entry["cases"] if r["case"] == head
                   and r["dtype"] == dtype)
        entry["library_causal_ms"] = row["library_causal_ms"]
        entry["simt_ms"] = row["simt_ms"]
        entry["launches_by_path"] = by_path
        record["kernels"].append(entry)
    # K5 and K6 by route: the f32 kernels carry fp32 (the oracle, the fp32
    # training steps, the imperative step), the tensor-core kernels bf16
    # (the gate, the bench row); the SIMT kernels, which no main path
    # launches any more, timed on the same inputs through route="simt"
    for name, line in (("flash_bwd_dq", "209"), ("flash_bwd_dkv", "267")):
        for route, source, dtype in (("simt", "flash_bwd.cu", "fp32"),
                                     ("f32", "flash_bwd_f32.cu", "fp32"),
                                     ("tc", "flash_bwd_tc.cu", "bf16")):
            in_graph = graph["gpt"]["launches"].get(f"{name}_{route}", 0)
            entry = _entry(name if route == "simt" else f"{name}_{route}",
                           src + source, ref + line,
                           trained["routes"][f"{name}_{route}"]
                           + imperative["flash_routes"][f"{name}_{route}"]
                           + in_graph,
                           [r for r in bwd if r["kernel"] == name
                            and r["route"] == route], train_case, dtype)
            head = next(r for r in entry["cases"] if r["case"] == train_case
                        and r["dtype"] == dtype)
            entry["library_causal_ms"] = head["library_causal_ms"]
            entry["simt_ms"] = head["simt_ms"]
            entry["launches_by_path"] = {
                "train": trained["routes"][f"{name}_{route}"],
                "imperative": imperative["flash_routes"][f"{name}_{route}"],
                "gpt_graph": in_graph}
            if route == "tc":
                entry["launches_by_path"]["bf16_gate"] = \
                    trained["gate_launches"][f"{name}_tc"]
            record["kernels"].append(entry)
    conv_ref = "incubator_mxnet_tpu/ops/pallas_conv.py:"
    # K1, K2 and K3 by route: fp32 (the oracle, the fp32 training steps,
    # eval) on the f32 kernels; bf16 (the gates, the bf16 learning check
    # and the bench row) on the tensor cores; the SIMT kernels, which no
    # main path launches any more, timed on the same inputs through
    # route="simt"
    for name, line, cuda_fns, sources in (
            ("fused_conv", "222", ("fused_conv_fwd_kernel",
                                   "fused_conv_tc_kernel",
                                   "fused_conv_f32_kernel"),
             ("fused_conv.cu", "fused_conv_tc.cu", "fused_conv_f32.cu")),
            ("conv_bwd_dx", "553", ("conv_bwd_dx_kernel",
                                    "conv_bwd_dx_tc_kernel",
                                    "conv_bwd_dx_f32_kernel"),
             ("conv_bwd.cu", "conv_bwd_tc.cu", "conv_bwd_f32.cu")),
            ("conv_bwd_dw", "780", ("conv_bwd_dw_kernel",
                                    "conv_bwd_dw_tc_kernel",
                                    "conv_bwd_dw_f32_kernel"),
             ("conv_bwd.cu", "conv_bwd_tc.cu", "conv_bwd_f32.cu"))):
        for route, fn, source, dtype in zip(("simt", "tc", "f32"), cuda_fns,
                                            sources, ("fp32", "bf16",
                                                      "fp32")):
            in_graph = graph["resnet50_fused"]["launches"].get(
                f"{name}_{route}", 0)
            entry = _entry(name if route == "simt" else f"{name}_{route}",
                           src + source, conv_ref + line,
                           resnet["routes"][name, route] + in_graph,
                           [r for r in conv if r["kernel"] == name
                            and r["route"] == route], CONV_HEAD, dtype)
            entry["kernel"] = fn
            if route != "simt":
                entry["simt_ms"] = next(
                    r["simt_ms"] for r in entry["cases"]
                    if r["case"] == CONV_HEAD)
            entry["launches_by_path"] = {"resnet_train":
                                         resnet["routes"][name, route],
                                         "resnet_graph": in_graph}
            if name == "fused_conv":
                entry["launches_by_path"]["resnet_eval"] = \
                    resnet["eval_routes"][name, route]
            record["kernels"].append(entry)
    rows = imperative["rows"]
    head = rows[RTC_HEAD]
    cases = list(rows.values()) + imperative["rtc_cases"]
    record["kernels"].append({
        "name": "rtc_cuda_module", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/rtc.py",
        "replaces": "incubator_mxnet_tpu/rtc.py:66",
        "launches": sum(r["launches"] for r in rows.values()),
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": RTC_HEAD,
        "cases": cases})
    bench = unfused["bench"]
    print("rows: " + json.dumps({
        "resnet50_fused_bf16": {k: resnet["bench"][k]
                                for k in ("batch", "step_ms", "images_s")},
        "resnet50_unfused_bf16": {
            layout: {k: row[k] for k in ("batch", "step_ms", "images_s",
                                         "peak_bytes", "idle")}
            for layout, row in bench.items()},
        "mlp_bf16": {k: mlp[k] for k in ("batch", "step_ms", "images_s",
                                         "peak_bytes", "idle")},
        "graph": {row: {k: v for k, v in r.items()
                        if k in ("k", "eager_ms", "graph_ms",
                                 "eager_device_ms", "graph_device_ms",
                                 "eager_idle", "graph_idle",
                                 "replay_span_ms", "eager_peak_bytes",
                                 "graph_peak_bytes")}
                  for row, r in graph.items() if isinstance(r, dict)
                  and "graph_ms" in r},
        "decode_step": {k: served["step_times"][k] for k in (
            "graph_ms", "eager_ms", "graph_device_ms", "eager_device_ms")}}),
        flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
