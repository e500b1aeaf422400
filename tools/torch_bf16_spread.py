#!/usr/bin/env python3
"""How far the bf16 conv kernels of the fused ResNet-50 lie from fp32 and
fp64, forward and backward, beside the SIMT kernels and the plain versions.

    python3 tools/torch_bf16_spread.py [--seed 0] [--batch 8]
        [--gate-batches 6] [--fp32-steps 10]

Draws ``fused_resnet50_v1`` as ``chip_smoke.py`` does (1000 classes,
weights from ``--seed``), casts it to bf16 and takes batches of ``--batch``
224x224 images. Four parts, each printed:

1. the whole step: one training step's gradients through three bf16
   backwards on the same forward (K1 on the tensor cores): ``tc``, the
   tensor-core K2/K3 (the route the rule takes); ``plain``, their plain
   versions (``chip_smoke.plain_conv_backward``, the bf16 gradient gate's
   reference); ``simt``, the SIMT K2/K3 (``csrc/conv_bwd.cu``) in bf16;
   each against the step of the net cast back up to fp32 (the same
   bf16-rounded weights and input) through the fp32 kernels, by the
   relative L2 error of the 161 gradients. At a fresh net the bf16
   forward's ReLU masks and batch statistics already part from the fp32
   forward's, so this mostly measures the forward;
2. per conv, on identical inputs: every K2/K3 call of the ``tc`` backward
   is recorded and made again by the three and by an fp64 evaluation of
   the same algorithm (the fold and the prologue rounded to bf16 where the
   kernels round them, every product and sum in fp64): the relative L2
   error of each output from the fp64 one, by output (dx, da, db, dr,
   dar, dw), and on how many outputs each is the farthest;
3. the same for K1: every ``fused_conv`` call of one bf16 forward, made by
   the tensor-core K1, the SIMT K1 (``csrc/fused_conv.cu``) and the plain
   version (fp32 cuDNN), against fp64 (the prologue rounded to bf16, the
   conv and the sums in fp64): y, sum, sumsq, the emitted activation;
4. ``chip_smoke.bf16_forward_distances`` (the bf16 forward gate's
   measure: the whole net's forward through each K1 against an fp32
   forward) on ``--gate-batches`` batches at the fresh net, then again
   after ``--fp32-steps`` fp32 SGD steps (lr 0.05, momentum 0.9, as
   ``chip_smoke.py``'s learning check), printing each batch's ratio of the
   tensor-core K1's distance to the SIMT K1's.

Needs a card.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


class simt_conv_backward:
    """``with simt_conv_backward():`` the fused conv's autograd Functions
    call the SIMT K2/K3 whatever the type."""

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = (fc.conv_bwd_dx, fc.conv_bwd_dw)
        fc.conv_bwd_dx = functools.partial(fc.conv_bwd_dx, route="simt")
        fc.conv_bwd_dw = functools.partial(fc.conv_bwd_dw, route="simt")
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        fc.conv_bwd_dx, fc.conv_bwd_dw = self._saved


class record_calls:
    """``with record_calls("fused_conv", ...) as rec:`` each call of the
    named ``ops.fused_conv`` functions that the autograd Functions make is
    recorded in ``rec.calls`` (name and arguments, cloned) and then made as
    usual."""

    def __init__(self, *names):
        self._names = names

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = {n: getattr(fc, n) for n in self._names}
        self.calls = []

        def wrap(name, fn):
            def call(*args, **kw):
                self.calls.append((name, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kw)))
                return fn(*args, **kw)
            return call

        for n, fn in self._saved.items():
            setattr(fc, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        for n, fn in self._saved.items():
            setattr(fc, n, fn)


def fp64_forward(x, w, a=None, b=None, stride=1, pad=0, relu=True, r=None,
                 ar=None, br=None, emit=False):
    """K1 as the plain version computes it, with the prologue output
    rounded to bf16 as the kernels round it, and the conv and its sums in
    fp64 (y not rounded)."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    xp = fc.apply_prologue(x, a, b, r, ar, br, relu)
    acc = fc._nhwc(torch.nn.functional.conv2d(
        fc._nchw(xp.double()), fc._oihw(w.double()), stride=stride,
        padding=pad))
    out = (acc, acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2)))
    return out + (xp.double(),) if emit else out


def fp64_backward(name, x, w, a, b, y, dy, ds, dss, stride=1, pad=0,
                  relu=True, r=None, ar=None, br=None, g=None):
    """K2 (``conv_bwd_dx``: ``(dx, da, db[, dr, dar])``) or K3
    (``conv_bwd_dw``) as the plain versions compute them, with the fold and
    the prologue output rounded to bf16 as the kernels round them and every
    product and sum in fp64."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    d = torch.float64
    dyt = (dy.double() + ds.double() + 2.0 * y.double() * dss.double()) \
        .to(y.dtype).to(d)
    wd = fc._oihw(w.to(d))
    if name == "conv_bwd_dw":
        xp = fc.apply_prologue(x, a, b, r, ar, br, relu).to(d)
        return (torch.nn.grad.conv2d_weight(
            fc._nchw(xp), tuple(wd.shape), fc._nchw(dyt), stride=stride,
            padding=pad).permute(2, 3, 1, 0),)
    n, h, wdt, ci = x.shape
    dxp = fc._nhwc(torch.nn.grad.conv2d_input(
        (n, ci, h, wdt), wd, fc._nchw(dyt), stride=stride, padding=pad))
    if g is not None:
        dxp = dxp + g.to(d)
    if a is None and r is None:
        return (dxp,)
    x64 = x.to(d)
    av = a.to(d) if a is not None else torch.ones_like(x64[0, 0, 0])
    lin = x64 * av + (b.to(d) if a is not None else 0.0)
    if r is not None:
        lin = lin + r.to(d) * ar.to(d) + br.to(d)
    dxf = torch.where(lin > 0.0, dxp, torch.zeros_like(dxp)) if relu \
        else dxp
    out = [dxf * av]
    if a is not None:
        out += [(dxf * x64).sum(dim=(0, 1, 2)), dxf.sum(dim=(0, 1, 2))]
    if r is not None:
        out += [dxf * ar.to(d), (dxf * r.to(d)).sum(dim=(0, 1, 2))]
    return tuple(out)


def _outputs(name, value, args):
    """(kind, tensor) of one call's outputs, by the names the contract
    gives them."""
    value = value if isinstance(value, tuple) else (value,)
    if name == "fused_conv":
        kinds = ("y", "sum", "sumsq", "emitted")
    elif name == "conv_bwd_dw":
        kinds = ("dw",)
    else:
        has_a, has_r = args[2] is not None, len(args) > 11 and \
            args[11] is not None
        kinds = ("dx",) + (("da", "db") if has_a else ()) \
            + (("dr", "dar") if has_r else ())
    return list(zip(kinds, [t for t in value if t is not None]))


def per_conv_spread(calls):
    """Each recorded call made again by the kernels, the SIMT kernels and
    the plain version, and in fp64: ``{method: {kind: [relative L2 error
    of each output]}}``."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    methods = {"fused_conv": (fc.fused_conv, fc.fused_conv_reference),
               "conv_bwd_dx": (fc.conv_bwd_dx, fc.conv_bwd_dx_reference),
               "conv_bwd_dw": (fc.conv_bwd_dw, fc.conv_bwd_dw_reference)}
    errs = {"tc": {}, "plain": {}, "simt": {}}
    for name, args, kw in calls:
        kernel, plain = methods[name]
        want = _outputs(name, fp64_forward(*args, **kw)
                        if name == "fused_conv"
                        else fp64_backward(name, *args, **kw), args)
        got = {"tc": kernel(*args, **kw), "plain": plain(*args, **kw),
               "simt": kernel(*args, route="simt", **kw)}
        for k, v in got.items():
            v = _outputs(name, v, args)
            assert [o[0] for o in v] == [o[0] for o in want], (name, k)
            for (kind, o), (_, r) in zip(v, want):
                errs[k].setdefault(kind, []).append(
                    cs._rel_l2(o.double(), r))
    return errs


def farthest_counts(errs):
    """On how many items (index i of each method's list) each method is
    strictly the farthest of all; ties are counted apart."""
    counts = {k: 0 for k in errs}
    counts["tie"] = 0
    for i in range(len(next(iter(errs.values())))):
        top = max(e[i] for e in errs.values())
        who = [k for k, e in errs.items() if e[i] == top]
        counts[who[0] if len(who) == 1 else "tie"] += 1
    return counts


def print_spread(title, errs):
    """Per output kind: each method's worst, median and mean error, and on
    how many outputs each is strictly the farthest of the three."""
    print(title, flush=True)
    for kind in errs["tc"]:
        n = len(errs["tc"][kind])
        far = farthest_counts({k: e[kind] for k, e in errs.items()})
        print(f"  {kind} ({n} outputs): " + "; ".join(
            f"{k} worst {max(e[kind]):.4e} median "
            f"{statistics.median(e[kind]):.4e} mean "
            f"{statistics.fmean(e[kind]):.4e} farthest on {far[k]}"
            for k, e in errs.items()) + f"; ties {far['tie']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gate-batches", type=int, default=6)
    ap.add_argument("--fp32-steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_spread: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    mx.random.seed(args.seed)
    net = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=mx.gpu(0)).cast("bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 31)

    def batch():
        x = torch.rand((args.batch, 3, 224, 224), generator=gen, device=dev)
        y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
        return x.to(torch.bfloat16), y.float()

    x, y = batch()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(logits, labels):
        return ce(logits, labels).mean()

    start = cs._frozen(net)

    def step(ctx=None, fp32=False):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        if fp32:
            net.cast("float32")
        try:
            if ctx is None:
                loss, grads = cs._grads(net, loss_fn,
                                        x.float() if fp32 else x, y)
            else:
                with ctx:
                    loss, grads = cs._grads(net, loss_fn, x, y)
        finally:
            if fp32:
                net.cast("bfloat16")
        return float(loss), [g.float() for g in grads]

    # 1. the whole step
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    ref_loss, ref = step(fp32=True)
    runs = {"tc": step(), "plain": step(cs.plain_conv_backward()),
            "simt": step(simt_conv_backward())}
    errs = {k: [cs._rel_l2(g, r) for g, r in zip(grads, ref)]
            for k, (_, grads) in runs.items()}
    farthest = farthest_counts(errs)
    print(f"1. bf16 backwards of fused_resnet50_v1 at a fresh net (B="
          f"{args.batch}, seed {args.seed}, {len(names)} trainable tensors)"
          f" against the fp32 step on the same bf16-rounded weights and "
          f"input (fp32 loss {ref_loss:.6f}); relative L2 error of each "
          f"gradient:", flush=True)
    for k, e in errs.items():
        worst = max(range(len(e)), key=e.__getitem__)
        print(f"  {k:5s} loss {runs[k][0]:.6f}: worst {e[worst]:.4e} "
              f"({names[worst]}), median {statistics.median(e):.4e}, mean "
              f"{statistics.fmean(e):.4e}; farthest of the three on "
              f"{farthest[k]} tensors (ties {farthest['tie']})", flush=True)

    # 2. and 3. per conv, on identical inputs
    with record_calls("conv_bwd_dx", "conv_bwd_dw") as rec:
        step()
    print_spread(f"2. per conv, on identical inputs ({len(rec.calls)} K2/K3 "
                 "calls of the tc backward): relative L2 error from the "
                 "fp64 evaluation of the same algorithm, by output",
                 per_conv_spread(rec.calls))
    with record_calls("fused_conv") as rec:
        step()
    print_spread(f"3. per conv, on identical inputs ({len(rec.calls)} K1 "
                 "calls of the bf16 forward): relative L2 error from the "
                 "fp64 evaluation of the same algorithm, by output",
                 per_conv_spread(rec.calls))

    # 4. the forward gate's measure over batches, fresh then trained
    def gate(label):
        ratios = []
        for _ in range(args.gate_batches):
            xb, yb = batch()
            dist, _ = cs.bf16_forward_distances(net, ce, xb, yb)
            ratios.append({k: dist["tc"][k] / max(dist["simt"][k], 1e-30)
                           for k in dist["tc"]})
        print(f"4. bf16 forward distances, tensor-core K1 over the SIMT K1, "
              f"{label}, {args.gate_batches} batches of {args.batch}: "
              + "; ".join(f"{k} " + " ".join(f"{r[k]:.4f}" for r in ratios)
                          for k in ratios[0]), flush=True)

    gate("fresh net")
    net.cast("float32")
    xb, yb = batch()
    st = parallel.SPMDTrainer(net, ce, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
    for _ in range(args.fp32_steps):
        st.step(xb.float(), yb)
    st.sync_to_net()
    net.cast("bfloat16")
    gate(f"after {args.fp32_steps} fp32 SGD steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
