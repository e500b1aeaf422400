"""The port's CUDA fused conv + BatchNorm kernels against their plain
versions.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX (``python -m pytest --noconftest
tests/test_torch_fused_conv_kernel.py``; the repo's conftest imports JAX).
Without a card the kernel tests skip: the kernels have no CPU mode. The
wrapper's checks and the weight-gradient split rule run everywhere.

Tolerances on the card (TF32 off): every output by its max abs error over
max(1, max|plain|), fp32 1e-4 (the kernels sum in another order than
cuDNN), bf16 2e-2 (outputs rounded to bf16 on both sides, at times on the
two sides of a rounding boundary); the fp32 per-channel sums and dW also
by relative L2 error, 1e-4.

Each kernel takes the route ``fc.conv_route`` names: bf16 with both
widths multiples of 8 the tensor-core kernels (``csrc/fused_conv_tc.cu``
forward, ``csrc/conv_bwd_tc.cu`` backward), fp32 with both widths
multiples of 4 and 16-byte aligned operands the register micro-tile
kernels (``csrc/fused_conv_f32.cu`` forward, ``csrc/conv_bwd_f32.cu``
backward), everything else the SIMT kernels (``csrc/fused_conv.cu``,
``csrc/conv_bwd.cu``); each test below states which it reaches.
"""

import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
from incubator_mxnet_tpu_torch.ops import fused_conv as fc

TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
L2_TOL = 1e-4

# (name, n, h, w, ci, co, k, stride, pad, kind); kind "plain": no prologue,
# "pro": BatchNorm prologue + ReLU, "res": + residual join and emit
CASES = [
    ("1x1_plain", 2, 9, 7, 8, 16, 1, 1, 0, "plain"),
    ("1x1_s2_plain_odd", 3, 9, 11, 24, 40, 1, 2, 0, "plain"),
    ("3x3_pro_ragged", 2, 7, 7, 20, 72, 3, 1, 1, "pro"),
    ("3x3_s2_pro", 2, 14, 14, 64, 64, 3, 2, 1, "pro"),
    ("1x1_res_emit", 2, 8, 8, 72, 24, 1, 1, 0, "res"),
    ("3x3_res_emit", 2, 6, 5, 16, 16, 3, 1, 1, "res"),
    ("5x5_s2_res_emit_odd", 2, 15, 15, 24, 40, 5, 2, 2, "res"),
    ("1x1_bottleneck_B4_28", 4, 28, 28, 256, 64, 1, 1, 0, "res"),
    # bf16: a row of 3 taps per weight-gradient block over 13-pixel boxes
    # (11 output columns + 2), 4 rows a box, the last box part empty
    ("3x3_pro_odd_rows", 2, 9, 11, 16, 24, 3, 1, 1, "pro"),
]
# ResNet-50's widths at a small batch: bf16 takes the tensor-core kernels
RESNET_CASES = [
    ("3x3_64_56_pro", 2, 56, 56, 64, 64, 3, 1, 1, "pro"),
    ("3x3_s2_128_28to14_pro", 2, 28, 28, 128, 128, 3, 2, 1, "pro"),
    ("1x1_s2_512to1024_14to7_plain", 2, 14, 14, 512, 1024, 1, 2, 0,
     "plain"),
    ("1x1_256to64_28_join_emit", 2, 28, 28, 256, 64, 1, 1, 0, "res"),
    ("3x3_512_7_pro_B4", 4, 7, 7, 512, 512, 3, 1, 1, "pro"),
    ("1x1_2048to512_7_pro", 2, 7, 7, 2048, 512, 1, 1, 0, "pro"),
    # enough boxes that the forward takes 128 output channels a block
    ("1x1_64to256_56_pro_B8", 8, 56, 56, 64, 256, 1, 1, 0, "pro"),
    ("1x1_256to128_56_join_emit_B8", 8, 56, 56, 256, 128, 1, 1, 0, "res"),
]


def make_case(case, dtype, device, seed=0):
    """Inputs of one case on ``device``: activations in ``dtype``, the
    per-channel operands fp32."""
    _, n, h, w, ci, co, k, stride, pad, kind = case
    rs = np.random.RandomState(seed)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    d = dict(x=rs.randn(n, h, w, ci), w=rs.randn(k, k, ci, co) / np.sqrt(
        k * k * ci), dy=rs.randn(n, ho, wo, co), ds=rs.randn(co) * 0.1,
        dss=rs.randn(co) * 0.01)
    if kind != "plain":
        d.update(a=rs.rand(ci) + 0.5, b=rs.randn(ci) * 0.5)
    if kind == "res":
        d.update(r=rs.randn(n, h, w, ci), ar=rs.rand(ci) + 0.5,
                 br=rs.randn(ci) * 0.5, g=rs.randn(n, h, w, ci))
    act = ("x", "w", "dy", "r", "g")
    return {key: torch.from_numpy(v.astype(np.float32)).to(
        device, dtype if key in act else torch.float32)
        for key, v in d.items()}


def _err(got, want):
    """(max abs err over max(1, max|want|), relative L2 error)."""
    got, want = got.float(), want.float()
    ref = max(1.0, want.abs().max().item())
    den = want.norm().item()
    diff = (got - want).norm().item()
    return ((got - want).abs().max().item() / ref,
            diff / den if den > 0 else diff)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _run_all(t, case, kernel):
    _, _, _, _, _, _, _, stride, pad, kind = case
    res = kind == "res"
    rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
    fwd = fc.fused_conv if kernel else fc.fused_conv_reference
    dx = fc.conv_bwd_dx if kernel else fc.conv_bwd_dx_reference
    dw = fc.conv_bwd_dw if kernel else fc.conv_bwd_dw_reference
    out = fwd(t["x"], t["w"], t.get("a"), t.get("b"), stride, pad, True,
              emit=res, **rkw)
    # the backward from the plain forward's y, for both
    y = t["y"]
    args = (t["x"], t["w"], t.get("a"), t.get("b"), y, t["dy"], t["ds"],
            t["dss"], stride, pad, True)
    gx = dx(*args, g=t.get("g"), **rkw)
    gw = dw(*args, **rkw)
    names = ["y", "sum", "sumsq"] + (["emitted"] if res else []) \
        + ["dx", "da", "db"] + (["dr", "dar"] if res else []) + ["dw"]
    return dict(zip(names, list(out) + list(gx) + [gw]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain_on_card(cuda_device, case, dtype):
    t = make_case(case, dtype, cuda_device)
    t["y"] = fc.fused_conv_reference(t["x"], t["w"], t.get("a"), t.get("b"),
                                     case[7], case[8], True, t.get("r"),
                                     t.get("ar"), t.get("br"))[0]
    n0 = (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
          fc.conv_bwd_dw_launches)
    route = fc.conv_route(dtype, case[4], case[5])
    r0 = getattr(fc, f"fused_conv_{route}_launches")
    got = _run_all(t, case, True)
    torch.cuda.synchronize()
    assert (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
            fc.conv_bwd_dw_launches) == tuple(v + 1 for v in n0)
    assert getattr(fc, f"fused_conv_{route}_launches") == r0 + 1
    want = _run_all(t, case, False)
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        err, l2 = _err(g, w)
        assert err <= TOLS[dtype], f"{name}: {err} > {TOLS[dtype]}"
        if dtype == torch.float32 and (name == "dw" or w.dim() == 1):
            assert l2 <= L2_TOL, f"{name}: relative L2 {l2} > {L2_TOL}"


def _route_launches():
    """(dx tc, dw tc, dx simt, dw simt, fwd tc, fwd simt, dx f32, fwd f32,
    dw f32) launches."""
    return (fc.conv_bwd_dx_tc_launches, fc.conv_bwd_dw_tc_launches,
            fc.conv_bwd_dx_simt_launches, fc.conv_bwd_dw_simt_launches,
            fc.fused_conv_tc_launches, fc.fused_conv_simt_launches,
            fc.conv_bwd_dx_f32_launches, fc.fused_conv_f32_launches,
            fc.conv_bwd_dw_f32_launches)


def _check_against_plain(t, case, dtype):
    t["y"] = fc.fused_conv_reference(t["x"], t["w"], t.get("a"), t.get("b"),
                                     case[7], case[8], True, t.get("r"),
                                     t.get("ar"), t.get("br"))[0]
    got = _run_all(t, case, True)
    torch.cuda.synchronize()
    want = _run_all(t, case, False)
    for name in want:
        if want[name] is None:
            continue
        assert torch.isfinite(got[name]).all(), name
        err, _ = _err(got[name], want[name])
        assert err <= TOLS[dtype], f"{name}: {err} > {TOLS[dtype]}"
    return got


@pytest.mark.parametrize("case", RESNET_CASES,
                         ids=[c[0] for c in RESNET_CASES])
def test_bf16_resnet_widths_take_the_tensor_cores(cuda_device, case):
    """bf16 at ResNet-50's widths (a stride-2 3x3, a 1x1/2 512->1024, a
    join with its emitted rows, and 7x7 convs whose deep K the forward
    splits over the grid at this batch among them) goes through the
    tensor-core K1, K2 and K3 and matches the plain versions."""
    t = make_case(case, torch.bfloat16, cuda_device)
    n0 = _route_launches()
    _check_against_plain(t, case, torch.bfloat16)
    assert _route_launches() == (n0[0] + 1, n0[1] + 1, n0[2], n0[3],
                                 n0[4] + 1, n0[5], n0[6], n0[7], n0[8])


def test_bf16_tensor_core_kernels_repeat_bit_for_bit(cuda_device):
    """The tensor-core K1 (partials, then the ordered column sums; split
    planes summed in order), K2 (partials, then the ordered column sum)
    and K3 (fp32 split planes, then the ordered split sum) use no
    atomics."""
    for case in (RESNET_CASES[1], RESNET_CASES[3], RESNET_CASES[5]):
        t = make_case(case, torch.bfloat16, cuda_device)
        t["y"] = fc.fused_conv_reference(
            t["x"], t["w"], t.get("a"), t.get("b"), case[7], case[8], True,
            t.get("r"), t.get("ar"), t.get("br"))[0]
        n0 = _route_launches()
        first, second = (_run_all(t, case, True) for _ in range(2))
        assert _route_launches()[:2] == (n0[0] + 2, n0[1] + 2)
        assert _route_launches()[4] == n0[4] + 2
        for name in first:
            if first[name] is not None:
                assert torch.equal(first[name], second[name]), name


def test_ragged_bf16_widths_take_the_simt_kernels(cuda_device):
    """Ci = 20 is no whole number of 16-byte rows: bf16 stays on the SIMT
    kernels, forward and backward, and they still match."""
    case = CASES[2]
    assert fc.conv_route(torch.bfloat16, case[4], case[5]) == "simt"
    t = make_case(case, torch.bfloat16, cuda_device)
    n0 = _route_launches()
    _check_against_plain(t, case, torch.bfloat16)
    assert _route_launches() == (n0[0], n0[1], n0[2] + 1, n0[3] + 1, n0[4],
                                 n0[5] + 1, n0[6], n0[7], n0[8])


def test_padding_is_zero_after_the_prologue(cuda_device):
    """A padded tap contributes 0, not relu(b): with x = 0 and b > 0 every
    interior output of a 3x3 all-ones conv is 9*relu(b)*Ci, the corners
    4*relu(b)*Ci."""
    ci = 8
    x = torch.zeros(1, 5, 5, ci, device=cuda_device)
    w = torch.ones(3, 3, ci, 1, device=cuda_device)
    a = torch.ones(ci, device=cuda_device)
    b = torch.full((ci,), 0.5, device=cuda_device)
    y, _, _ = fc.fused_conv(x, w, a, b, 1, 1, True)
    torch.cuda.synchronize()
    assert y[0, 2, 2, 0].item() == 9 * 0.5 * ci
    assert y[0, 0, 0, 0].item() == 4 * 0.5 * ci


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_padding_is_zero_after_the_prologue_on_the_tensor_cores(
        cuda_device, stride):
    """The tensor-core K1 rewrites a padded tap to 0, not relu(b) (TMA
    fills it with 0, which the prologue would map to relu(b)): with x = 0
    and b = 0.5 the centre of a 3x3 all-ones conv is 9*0.5*Ci, a corner
    4*0.5*Ci (both exact in bf16), at stride 1 (a row of taps per step)
    and stride 2 (a tap per step)."""
    ci = 16
    x = torch.zeros(2, 5, 5, ci, device=cuda_device, dtype=torch.bfloat16)
    w = torch.ones(3, 3, ci, 8, device=cuda_device, dtype=torch.bfloat16)
    a = torch.ones(ci, device=cuda_device)
    b = torch.full((ci,), 0.5, device=cuda_device)
    n0 = fc.fused_conv_tc_launches
    y, s, _ = fc.fused_conv(x, w, a, b, stride, 1, True)
    torch.cuda.synchronize()
    assert fc.fused_conv_tc_launches == n0 + 1
    want, want_s, _ = fc.fused_conv_reference(x, w, a, b, stride, 1, True)
    assert torch.equal(y, want) and torch.equal(s, want_s)
    c = 2 // stride
    assert y[0, c, c, 0].item() == 9 * 0.5 * ci
    assert y[1, 0, 0, 7].item() == 4 * 0.5 * ci


def test_kernels_repeat_bit_for_bit(cuda_device):
    """No atomics: the partial sums are added in a fixed order."""
    case = CASES[3]
    t = make_case(case, torch.float32, cuda_device)
    t["y"] = fc.fused_conv_reference(t["x"], t["w"], t["a"], t["b"], 2, 1,
                                     True)[0]
    first, second = (_run_all(t, case, True) for _ in range(2))
    for name in first:
        if first[name] is not None:
            assert torch.equal(first[name], second[name]), name


@pytest.mark.parametrize("emit", [False, True])
def test_autograd_through_the_kernels_on_card(cuda_device, emit):
    """``fused_conv_bn``'s Functions on CUDA tensors reach K1, K2 and K3,
    and their gradients equal the same Functions on the CPU (the plain
    versions), fp32."""
    case = CASES[4] if emit else CASES[3]
    base = make_case(case, torch.float32, torch.device("cpu"), seed=3)
    names = [k for k in ("x", "w", "a", "b", "r", "ar", "br") if k in base]
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = {k: base[k].to(dev).requires_grad_(True) for k in names}
        n0 = fc.conv_bwd_dw_launches
        outs = fc.fused_conv_bn(
            leaves["x"], leaves["w"], leaves["a"], leaves["b"],
            stride=case[7], pad=case[8], relu=True, resid=leaves.get("r"),
            resid_scale=leaves.get("ar"), resid_shift=leaves.get("br"),
            emit_act=emit)
        cts = [base["dy"], base["ds"], base["dss"]] + (
            [base["g"]] if emit else [])
        torch.autograd.backward(list(outs), [c.to(dev) for c in cts])
        assert fc.conv_bwd_dw_launches == n0 + int(dev.type == "cuda")
        grads.append({k: leaves[k].grad.cpu() for k in names})
    for k in names:
        err, _ = _err(grads[0][k], grads[1][k])
        assert err <= TOLS[torch.float32], f"d{k}: {err}"


@pytest.mark.parametrize("bad, err, match", [
    (dict(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    (dict(k=2), ValueError, "only odd"),
    (dict(stride=3), ValueError, "stride 3"),
    (dict(ci_w=4), ValueError, "channel mismatch"),
    (dict(pad=-1), ValueError, "pad -1"),
    (dict(empty=True), ValueError, "empty conv"),
], ids=["fp16", "even_kernel", "stride3", "channels", "neg_pad", "empty"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad, err, match):
    """The contract checks every wrapper runs first (here on CPU tensors:
    they read only shapes and types)."""
    dtype = bad.get("dtype", torch.float32)
    k = bad.get("k", 3)
    x = torch.zeros(1, 1 if bad.get("empty") else 6, 6, 8, dtype=dtype)
    w = torch.zeros(k, k, bad.get("ci_w", 8), 4, dtype=dtype)
    with pytest.raises(err, match=match):
        fc.fused_conv(x, w, stride=bad.get("stride", 1),
                      pad=bad.get("pad", 0))


def test_weight_gradient_splits_fill_the_card_and_keep_whole_steps():
    # SIMT (fp32 and ragged bf16). ResNet-50 stage 1 at B=32: 1x1 64->64
    # over 100,352 pixels is one 64x64 tile, so the pixels are cut into
    # 528 ranges of 12 steps
    assert fc.dw_splits(32, 56, 56, 64, 64, 1, 1) == 528
    # 3x3 512->512 at 7x7 is 576 tiles already: no split
    assert fc.dw_splits(32, 7, 7, 512, 512, 3, 3) == 1
    # a tiny conv is never cut below 8 steps of 16 pixels per range
    assert fc.dw_splits(1, 4, 4, 8, 8, 1, 1) == 1
    assert fc.dw_splits(1, 32, 32, 8, 8, 1, 1) == 8
    # tensor cores: a step is a box of at most 64 pixels (one 56-pixel
    # row at 56x56, so 1792 boxes at B=32), 264 blocks aimed for
    assert fc.tc_box(32, 56, 56) == (56, 1, 1)
    assert fc.dw_splits(32, 56, 56, 64, 64, 1, 1, "tc") == 256   # 7 each
    assert fc.dw_splits(32, 7, 7, 512, 512, 3, 3, "tc") == 1
    # a tiny conv is never cut below 4 boxes per range (32x32: 16 boxes
    # of two 32-pixel rows)
    assert fc.dw_splits(1, 4, 4, 8, 8, 1, 1, "tc") == 1
    assert fc.dw_splits(1, 32, 32, 8, 8, 1, 1, "tc") == 4


@pytest.mark.parametrize("case", CASES + RESNET_CASES[:5],
                         ids=[c[0] for c in CASES + RESNET_CASES[:5]])
def test_fp32_input_gradient_takes_the_f32_kernel(cuda_device, case):
    """fp32 with both widths multiples of 4 (every case here): K2 on the
    register micro-tile kernel, and K1 and K3 too, all matching the plain
    versions; the SIMT K2 named on the same inputs matches too, and the
    f32 K2 repeats bit for bit (partials, then the ordered column
    sums)."""
    for kernel in ("fused_conv", "conv_bwd_dx", "conv_bwd_dw"):
        assert fc.conv_route(torch.float32, case[4], case[5], kernel) \
            == "f32"
    t = make_case(case, torch.float32, cuda_device)
    n0 = _route_launches()
    got = _check_against_plain(t, case, torch.float32)
    assert _route_launches() == (n0[0], n0[1], n0[2], n0[3], n0[4],
                                 n0[5], n0[6] + 1, n0[7] + 1, n0[8] + 1)
    _, _, _, _, _, _, _, stride, pad, kind = case
    rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"), g=t.get("g"))
    args = (t["x"], t["w"], t.get("a"), t.get("b"), t["y"], t["dy"],
            t["ds"], t["dss"], stride, pad, True)
    again = fc.conv_bwd_dx(*args, **rkw)
    for x, y in zip(again, (got[k] for k in ("dx", "da", "db", "dr", "dar")
                            if k in got)):
        assert (x is None and y is None) or torch.equal(x, y)
    want = fc.conv_bwd_dx_reference(*args, **rkw)
    simt = fc.conv_bwd_dx(*args, route="simt", **rkw)
    assert _route_launches()[2] == n0[2] + 1
    for x, y in zip(simt, want):
        if y is not None:
            err, l2 = _err(x, y)
            assert err <= TOLS[torch.float32]
            if y.dim() == 1:
                assert l2 <= L2_TOL


def test_fp32_input_gradient_of_a_misaligned_view_takes_simt(cuda_device):
    """An operand whose base is not 16-byte aligned (a view 4 bytes into
    its buffer) keeps K2 on SIMT; named, the f32 route raises."""
    case = CASES[0]
    t = make_case(case, torch.float32, cuda_device)
    t["y"] = fc.fused_conv_reference(t["x"], t["w"], None, None, 1, 0,
                                     True)[0]
    buf = torch.empty(t["dy"].numel() + 1, device=cuda_device)
    dy = buf[1:].view_as(t["dy"])
    dy.copy_(t["dy"])
    assert dy.data_ptr() % 16 == 4
    args = (t["x"], t["w"], None, None, t["y"], dy, t["ds"], t["dss"], 1, 0,
            True)
    n0 = _route_launches()
    got = fc.conv_bwd_dx(*args)
    assert _route_launches()[2] == n0[2] + 1
    assert _route_launches()[6] == n0[6]
    want = fc.conv_bwd_dx_reference(*args)
    assert _err(got[0], want[0])[0] <= TOLS[torch.float32]
    with pytest.raises(ValueError, match="16-byte"):
        fc.conv_bwd_dx(*args, route="f32")


@pytest.mark.parametrize("case", RESNET_CASES,
                         ids=[c[0] for c in RESNET_CASES])
def test_fp32_resnet_widths_take_the_f32_kernels(cuda_device, case):
    """fp32 at ResNet-50's widths (a stride-2 3x3, a 1x1/2 512->1024, a
    join with its emitted rows, the 7x7 convs) goes through the f32 K1, K2
    and K3 and matches the plain versions (sums and dW also by relative
    L2); the SIMT K1 and K3 named on the same inputs match too."""
    t = make_case(case, torch.float32, cuda_device)
    n0 = _route_launches()
    got = _check_against_plain(t, case, torch.float32)
    assert _route_launches() == n0[:6] + (n0[6] + 1, n0[7] + 1, n0[8] + 1)
    want = _run_all(t, case, False)
    for name in ("sum", "sumsq", "dw"):
        assert _err(got[name], want[name])[1] <= L2_TOL, name
    _, _, _, _, _, _, _, stride, pad, kind = case
    rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
    simt = fc.fused_conv(t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                         True, emit=kind == "res", route="simt", **rkw)
    args = (t["x"], t["w"], t.get("a"), t.get("b"), t["y"], t["dy"],
            t["ds"], t["dss"], stride, pad, True)
    simt_dw = fc.conv_bwd_dw(*args, route="simt", **rkw)
    assert _route_launches()[3] == n0[3] + 1
    assert _route_launches()[5] == n0[5] + 1
    assert _err(simt[0], want["y"])[0] <= TOLS[torch.float32]
    assert _err(simt_dw, want["dw"])[1] <= L2_TOL


def test_fp32_misaligned_view_takes_simt_for_the_forward_and_dw(
        cuda_device):
    """An x whose base is not 16-byte aligned (a view 4 bytes into its
    buffer) keeps K1 and K3 on SIMT, matching the plain versions; named,
    the f32 route raises."""
    case = CASES[3]
    t = make_case(case, torch.float32, cuda_device)
    buf = torch.empty(t["x"].numel() + 1, device=cuda_device)
    x = buf[1:].view_as(t["x"])
    x.copy_(t["x"])
    assert x.data_ptr() % 16 == 4
    fargs = (x, t["w"], t["a"], t["b"], 2, 1, True)
    n0 = _route_launches()
    got = fc.fused_conv(*fargs)
    want = fc.fused_conv_reference(*fargs)
    args = (x, t["w"], t["a"], t["b"], want[0], t["dy"], t["ds"], t["dss"],
            2, 1, True)
    dw = fc.conv_bwd_dw(*args)
    now = _route_launches()
    assert (now[3], now[5], now[7], now[8]) == (n0[3] + 1, n0[5] + 1, n0[7],
                                                n0[8])
    assert _err(got[0], want[0])[0] <= TOLS[torch.float32]
    assert _err(dw, fc.conv_bwd_dw_reference(*args))[1] <= L2_TOL
    with pytest.raises(ValueError, match="16-byte"):
        fc.fused_conv(*fargs, route="f32")
    with pytest.raises(ValueError, match="16-byte"):
        fc.conv_bwd_dw(*args, route="f32")


def test_f32_kernels_repeat_bit_for_bit(cuda_device):
    """The f32 K1 (partials, then the ordered column sums) and K3 (fp32
    range planes, then the ordered split sum; one range writes dW itself)
    use no atomics: two runs give the same bits, at a stride-2 3x3, a join
    that emits and the 7x7 convs whose K3 takes one range."""
    for case in (RESNET_CASES[1], RESNET_CASES[3], RESNET_CASES[4]):
        t = make_case(case, torch.float32, cuda_device)
        t["y"] = fc.fused_conv_reference(
            t["x"], t["w"], t.get("a"), t.get("b"), case[7], case[8], True,
            t.get("r"), t.get("ar"), t.get("br"))[0]
        n0 = _route_launches()
        first, second = (_run_all(t, case, True) for _ in range(2))
        assert _route_launches()[7:] == (n0[7] + 2, n0[8] + 2)
        for name in first:
            if first[name] is not None:
                assert torch.equal(first[name], second[name]), name


@pytest.mark.parametrize("stride", [1, 2])
def test_f32_padding_is_zero_after_the_prologue(cuda_device, stride):
    """The f32 K1 rewrites a padded tap to 0, not relu(b) (TMA fills it
    with 0, which the prologue would map to relu(b)): with x = 0 and b =
    0.5 the centre of a 3x3 all-ones conv is 9*0.5*Ci, a corner 4*0.5*Ci
    (exact in fp32); the f32 K3 of the same conv, with dy = 1 and no
    statistics cotangents, counts the taps inside: its centre tap sees
    every output pixel, a corner tap fewer."""
    ci = 8
    x = torch.zeros(2, 5, 5, ci, device=cuda_device)
    w = torch.ones(3, 3, ci, 8, device=cuda_device)
    a = torch.ones(ci, device=cuda_device)
    b = torch.full((ci,), 0.5, device=cuda_device)
    n0 = _route_launches()
    y, s, _ = fc.fused_conv(x, w, a, b, stride, 1, True)
    torch.cuda.synchronize()
    want, want_s, _ = fc.fused_conv_reference(x, w, a, b, stride, 1, True)
    assert torch.equal(y, want) and torch.equal(s, want_s)
    c = 2 // stride
    assert y[0, c, c, 0].item() == 9 * 0.5 * ci
    assert y[1, 0, 0, 7].item() == 4 * 0.5 * ci
    dy = torch.ones_like(y)
    zero = torch.zeros(8, device=cuda_device)
    dw = fc.conv_bwd_dw(x, w, a, b, y, dy, zero, zero, stride, 1, True)
    want_dw = fc.conv_bwd_dw_reference(x, w, a, b, y, dy, zero, zero,
                                       stride, 1, True)
    assert _route_launches()[7:] == (n0[7] + 1, n0[8] + 1)
    assert torch.equal(dw, want_dw)
    pixels = y.shape[0] * y.shape[1] * y.shape[2]
    assert dw[1, 1, 0, 0].item() == 0.5 * pixels
    assert dw[0, 0, 0, 0].item() < 0.5 * pixels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_tma_kernels_launch_from_a_fresh_thread(cuda_device, dtype):
    """A thread whose first CUDA work is a kernel fed by TMA (torch's
    autograd thread running a conv's backward, or any new thread) still
    launches it: the tensor-map encoder (cuTensorMapEncodeTiled) needs
    the thread's context, which the encoder binds with libcuda calls
    where the thread has none (``bind_context`` in
    ``csrc/hopper.cuh``). K3
    (f32 in fp32, tensor cores in bf16) and then K1 on the new thread
    match the same calls on this one."""
    case = RESNET_CASES[1]
    t = make_case(case, dtype, cuda_device)
    args = (t["x"], t["w"], t["a"], t["b"], t["x"][:, ::2, ::2, :]
            .contiguous(), t["dy"], t["ds"], t["dss"], 2, 1, True)
    want = (fc.conv_bwd_dw(*args), fc.fused_conv(*args[:4], 2, 1, True)[0])
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = (fc.conv_bwd_dw(*args),
                          fc.fused_conv(*args[:4], 2, 1, True)[0])
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            out["err"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "err" in out:
        raise out["err"]
    for got, ref in zip(out["got"], want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("case", CASES + RESNET_CASES,
                         ids=[c[0] for c in CASES + RESNET_CASES])
def test_f32_forward_gives_the_simt_kernels_bits(cuda_device, case):
    """Where fp32 K1 takes the f32 route, its y, sums and emitted
    activation equal the SIMT K1's bit for bit: both accumulate each
    output over (tap, channel) in ascending order in fp32 FMAs, and the
    f32 route takes the sums in the SIMT epilogue's order. So the fp32
    results do not depend on the route (a misaligned view takes SIMT)."""
    _, _, _, _, ci, co, _, stride, pad, kind = case
    assert fc.conv_route(torch.float32, ci, co) == "f32"
    t = make_case(case, torch.float32, cuda_device)
    args = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad, True)
    rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"),
               emit=kind == "res")
    n0 = _route_launches()
    got = fc.fused_conv(*args, **rkw)
    simt = fc.fused_conv(*args, route="simt", **rkw)
    assert _route_launches()[5] == n0[5] + 1
    assert _route_launches()[7] == n0[7] + 1
    for a, b in zip(got, simt):
        assert torch.equal(a, b)
