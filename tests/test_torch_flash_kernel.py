"""The port's CUDA flash-attention kernels against their plain versions.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX (``python -m pytest --noconftest tests/test_torch_flash_kernel.py``;
the repo's conftest imports JAX). Without a card the kernel tests skip: the
kernel has no CPU mode. The wrapper's checks and the plain version's
handling of strided inputs run everywhere.

Tolerances on the card, forward: fp32 1e-4 abs (the kernel sums in
another order than the plain version's matmuls, TF32 off on both); bf16
2e-2 abs (the output is rounded to bf16; both compute in fp32 inside).
Backward (dq, dk, dv), relative to max|plain| of each: fp32 1e-4 (order of
sums), bf16 2e-2 (the kernels round p and dS to bf16 before their
products, as the TPU kernels do; the plain version keeps them in fp32).
The forward takes the route ``flash_fwd_route`` names: a decode step (one
query row) on the split kernels (``csrc/flash_fwd_split.cu``), the rest
with D 64 or 128 and 16-byte aligned operands in bf16 on the tensor-core
kernel (``csrc/flash_fwd_tc.cu``) and in fp32 from ``FWD_F32_MIN_TQ``
query rows on the register micro-tile kernel (``csrc/flash_fwd_f32.cu``),
everything else on the SIMT kernel (``csrc/flash_fwd.cu``); every route
is also run by name on every case its kernel takes. The backward takes the route ``flash_bwd_route`` names:
with D 64 or 128 and 16-byte aligned operands, bf16 on the tensor-core
kernels (``csrc/flash_bwd_tc.cu``) and fp32 on the register micro-tile
kernels (``csrc/flash_bwd_f32.cu``); everything else on the SIMT kernels
(``csrc/flash_bwd.cu``); the card tests check which one ran.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

# (name, b, h, tq, tk, d, causal, cache_offset, lengths)
CASES = [
    ("square_causal_d32", 2, 3, 40, 40, 32, True, False, None),
    ("tq_lt_tk_causal_d128", 2, 2, 24, 56, 128, True, False, None),
    ("lengths", 3, 2, 19, 56, 64, False, False, [56, 17, 1]),
    ("cache_offset_tq3", 3, 2, 3, 48, 32, True, True, [48, 20, 3]),
    ("masked_rows", 2, 2, 20, 8, 64, True, False, [8, 0]),
    ("prefill_T256", 1, 12, 256, 256, 64, True, False, None),
    ("decode_S8_Tk512", 8, 12, 1, 512, 64, True, True,
     [1, 7, 64, 65, 129, 300, 511, 512]),
    ("causal_d128_T320", 2, 3, 320, 320, 128, True, False, None),
    # decode steps with an empty slot, at the other head dims
    ("decode_d32_len0", 3, 2, 1, 130, 32, True, True, [0, 130, 63]),
    ("decode_d128_lengths", 2, 3, 1, 200, 128, False, False, [200, 1]),
]
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _inputs(b, h, tq, tk, d, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = (t.to(cuda_device, dtype) for t in _inputs(b, h, tq, tk, d))
    lens = None if lengths is None else torch.tensor(lengths)
    n0 = fa.flash_fwd_launches
    got, got_lse = fa.flash_attention(q, k, v, lens, causal=causal,
                                      cache_offset=cache_offset,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches == n0 + 1
    want, want_lse = fa.flash_attention_reference(
        q, k, v, lens, causal=causal, cache_offset=cache_offset,
        return_lse=True)
    tol = TOLS[dtype]
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=tol)


FWD_ROUTES = ("tc", "f32", "split", "simt")


def _fwd_route_counts():
    return {r: getattr(fa, f"flash_fwd_{r}_launches") for r in FWD_ROUTES}


def _expect_fwd_route(before, route):
    """One forward launch since ``before``, on ``route``."""
    now = _fwd_route_counts()
    assert {r: now[r] - before[r] for r in FWD_ROUTES} == \
        {r: int(r == route) for r in FWD_ROUTES}, (route, now)


def _takes(route, dtype, tq, d):
    """Whether the route's kernel takes a contiguous case of this dtype,
    query count and head dim (``flash_attention._fwd_routes``)."""
    if route == "tc":
        return dtype == torch.bfloat16 and d in (64, 128)
    if route == "f32":
        return dtype == torch.float32 and d in (64, 128) and tq > 1
    if route == "split":
        return tq == 1
    return True


ROUTE_CASES = [(c, dt, r) for c in CASES
               for dt in (torch.float32, torch.bfloat16)
               for r in FWD_ROUTES if _takes(r, dt, c[3], c[5])]


@pytest.mark.parametrize(
    "case, dtype, route", ROUTE_CASES,
    ids=[f"{c[0]}-{'bf16' if dt == torch.bfloat16 else 'fp32'}-{r}"
         for c, dt, r in ROUTE_CASES])
def test_each_forward_route_matches_plain_on_card(cuda_device, case, dtype,
                                                  route):
    """Every route's kernel, named, on every case it takes: o within the
    dtype's tolerance, the lse within 1e-3 with the -inf rows identical,
    no NaN."""
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = (t.to(cuda_device, dtype) for t in _inputs(b, h, tq, tk, d))
    lens = None if lengths is None else torch.tensor(lengths)
    before = _fwd_route_counts()
    got, got_lse = fa.flash_attention(q, k, v, lens, causal=causal,
                                      cache_offset=cache_offset,
                                      return_lse=True, route=route)
    torch.cuda.synchronize()
    _expect_fwd_route(before, route)
    want, want_lse = fa.flash_attention_reference(
        q, k, v, lens, causal=causal, cache_offset=cache_offset,
        return_lse=True)
    assert not torch.isnan(got).any() and not torch.isnan(got_lse).any()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOLS[dtype])
    assert torch.equal(torch.isneginf(got_lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(got_lse[fin], want_lse[fin], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("route, dtype", [
    ("tc", torch.bfloat16), ("split", torch.float32),
    ("split", torch.bfloat16), ("f32", torch.float32)],
    ids=["tc", "split_fp32", "split_bf16", "f32"])
def test_forward_routes_repeat_bit_for_bit(cuda_device, route, dtype):
    """No atomics: the tensor-core, split and f32 kernels repeat exactly
    (the prefill case on tc and f32, the decode case on split)."""
    case = CASES[5] if route in ("tc", "f32") else CASES[6]
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = (t.to(cuda_device, dtype) for t in _inputs(b, h, tq, tk, d))
    lens = None if lengths is None else torch.tensor(lengths)
    kw = dict(causal=causal, cache_offset=cache_offset, return_lse=True)
    before = _fwd_route_counts()
    first = fa.flash_attention(q, k, v, lens, **kw)
    _expect_fwd_route(before, route)
    second = fa.flash_attention(q, k, v, lens, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_forward_rule_on_the_main_paths_shapes(cuda_device):
    """The GPT's bf16 head-split views take tc and its fp32 ones f32, a
    decode step takes split (fp32 and bf16), a misaligned bf16 view and an
    fp32 prompt of 16 rows take simt; each matches the plain version."""
    rs = np.random.RandomState(13)
    qkv = torch.from_numpy(rs.randn(2, 150, 3, 4, 64).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    wide = torch.zeros(2, 4, 150, 72, dtype=q.dtype, device=q.device)
    wide[..., :64] = q
    odd = wide[..., 1:65]                  # a base 2 bytes off 16
    for qq, route in ((q, "tc"), (odd, "simt")):
        before = _fwd_route_counts()
        out = fa.flash_attention(qq, k, v, causal=True)
        _expect_fwd_route(before, route)
        want = fa.flash_attention_reference(qq, k, v, causal=True)
        torch.testing.assert_close(out.float(), want.float(), rtol=0,
                                   atol=TOLS[torch.bfloat16])
    q32, k32, v32 = (t.float() for t in (q, k, v))
    for qq, route in ((q32, "f32"), (q32[:, :, :16], "simt")):
        before = _fwd_route_counts()
        out = fa.flash_attention(qq, k32, v32, causal=True)
        _expect_fwd_route(before, route)
        want = fa.flash_attention_reference(qq, k32, v32, causal=True)
        torch.testing.assert_close(out, want, rtol=0,
                                   atol=TOLS[torch.float32])
    _, b, h, tq, tk, d, causal, cache_offset, lengths = CASES[6]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(cuda_device, dtype)
                   for t in _inputs(b, h, tq, tk, d, seed=2))
        lens = torch.tensor(lengths, device=cuda_device)
        before = _fwd_route_counts()
        out = fa.flash_attention(q, k, v, lens, cache_offset=True)
        _expect_fwd_route(before, "split")
        want = fa.flash_attention_reference(q, k, v, lens, cache_offset=True)
        torch.testing.assert_close(out.float(), want.float(), rtol=0,
                                   atol=TOLS[dtype])


def test_kernel_takes_head_split_views_and_merges_heads(cuda_device):
    """The GPT path: q/k/v are strided views of a fused projection, and the
    output's head merge is a view."""
    rs = np.random.RandomState(5)
    qkv = torch.from_numpy(rs.randn(2, 37, 3, 4, 64).astype(np.float32))
    qkv = qkv.to(cuda_device)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    out = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_reference(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    merged = out.transpose(1, 2)
    assert merged.is_contiguous()


def test_plain_version_reads_strided_views_like_copies():
    rs = np.random.RandomState(5)
    qkv = torch.from_numpy(rs.randn(2, 17, 3, 4, 32).astype(np.float32))
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cache_offset_requires_lengths():
    q, k, v = _inputs(1, 1, 1, 4, 32)
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_attention(q, k, v, cache_offset=True)


@pytest.mark.parametrize("bad, err, match", [
    # fp16 is a kernel type since the fp16 repair: an fp16 q against a bf16
    # k (mixed types) is what it refuses
    (dict(dtype=torch.float16, k_dtype=torch.bfloat16), TypeError,
     "k dtype"),
    (dict(d=48), ValueError, "head dim"),
    (dict(kv_len_mismatch=True), ValueError, "k/v must be"),
    (dict(strided_d=True), ValueError, "contiguous"),
    (dict(lengths=[5, 5]), ValueError, "lengths"),
    (dict(grad_shape=True), ValueError, "g must be shaped like q"),
    (dict(dtype=torch.float64), TypeError, "float32, bfloat16 or float16"),
], ids=["fp16", "d48", "kv_mismatch", "strided_d", "lengths_shape", "grad",
        "fp64"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, err,
                                                               match):
    """The checks the CUDA path runs before a launch (run here on CPU
    tensors: they read only shapes, strides and dtypes)."""
    d = bad.get("d", 32)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 2, 3, d, dtype=dtype)
    k = torch.zeros(1, 2, 5, d, dtype=bad.get("k_dtype", dtype))
    v = torch.zeros(1, 2, 4 if bad.get("kv_len_mismatch") else 5, d,
                    dtype=dtype)
    if bad.get("strided_d"):
        q = torch.zeros(1, 2, 3, 2 * d)[..., ::2]
    with pytest.raises(err, match=match):
        fa._check_cuda(q, k, v, bad.get("lengths"))
        if bad.get("grad_shape"):          # the backward's extra checks
            rows = torch.zeros(q.shape[:3])
            fa._check_bwd(q, rows, rows, torch.zeros(1, 2, 4, d))


def test_kernel_wrapper_truncates_float_lengths_as_the_plain_version():
    """A float ``valid_length`` (GluonNLP's convention) is taken on the
    card path: ``_check_cuda`` hands the kernel its truncation toward zero
    as int32, which are the keys the plain version masks (run here on CPU
    tensors: the check reads shapes and dtypes only)."""
    q = torch.zeros(4, 2, 3, 32)
    k = v = torch.zeros(4, 2, 12, 32)
    lens = torch.tensor([9.7, 1.0, 12.0, 0.5])
    got = fa._check_cuda(q, k, v, lens)
    assert got.dtype == torch.int32 and got.tolist() == [9, 1, 12, 0]
    keys = fa._valid(q, k, lens, False, False)[:, 0, 0].sum(-1)
    assert keys.tolist() == got.tolist()
    assert fa._check_cuda(q, k, v, [9.7, 1, 12, 0.5]).tolist() == \
        [9, 1, 12, 0]


def _bwd_case(case, dtype, device, seed=0):
    """Inputs of one backward call: q, k, v, lengths, the forward's lse and
    output (from the kernel), a cotangent and delta = sum(g * o)."""
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = (t.to(device, dtype) for t in _inputs(b, h, tq, tk, d, seed))
    lens = None if lengths is None else torch.tensor(lengths)
    out, lse = fa.flash_attention(q, k, v, lens, causal=causal,
                                  cache_offset=cache_offset, return_lse=True)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        b, h, tq, d).astype(np.float32)).to(device, dtype)
    delta = (g.float() * out.float()).sum(-1)
    return (q, k, v, lens, lse, delta, g), dict(causal=causal,
                                                cache_offset=cache_offset)


BWD_ROUTES = ("tc", "f32", "simt")


def _route_counts():
    return {(k, r): getattr(fa, f"flash_bwd_{k}_{r}_launches")
            for k in ("dq", "dkv") for r in BWD_ROUTES}


def _expect_route(before, route):
    """One launch of each backward kernel since ``before``, on ``route``."""
    now = _route_counts()
    for k in ("dq", "dkv"):
        for r in BWD_ROUTES:
            assert now[k, r] == before[k, r] + int(r == route), (k, r, now)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_kernels_match_plain_on_card(cuda_device, case, dtype):
    args, kw = _bwd_case(case, dtype, cuda_device)
    n_dq, n_dkv = fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches
    before = _route_counts()
    got = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == \
        (n_dq + 1, n_dkv + 1)
    q, k, v, _, _, _, g = args
    rule = fa.flash_bwd_route(q, k, v, g)
    assert rule == ("simt" if case[5] not in (64, 128) else
                    "tc" if dtype == torch.bfloat16 else "f32")
    _expect_route(before, rule)
    want = fa.flash_attention_bwd_reference(*args, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == dtype, name
        assert torch.isfinite(x).all(), name
        # relative to max|plain|: the kernels round p and dS to bf16 before
        # their products (as the TPU kernels do), the plain version does not
        tol = TOLS[dtype] * max(1.0, y.float().abs().max().item())
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol,
                                   msg=lambda m: f"{name}: {m}")


def test_backward_kernels_repeat_bit_for_bit(cuda_device):
    """No atomics: the tensor-core route (bf16, D=64) repeats exactly."""
    args, kw = _bwd_case(CASES[5], torch.bfloat16, cuda_device)
    before = _route_counts()
    first = fa.flash_attention_bwd(*args, **kw)
    _expect_route(before, "tc")
    second = fa.flash_attention_bwd(*args, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_backward_simt_route_stays_reachable_in_bf16(cuda_device):
    """``route="simt"`` runs the SIMT kernels on a call the rule sends to
    the tensor cores, and both agree within the bf16 tolerance;
    ``route="tc"`` where the rule says simt raises before a launch."""
    args, kw = _bwd_case(CASES[1], torch.bfloat16, cuda_device)
    before = _route_counts()
    simt = fa.flash_attention_bwd(*args, route="simt", **kw)
    _expect_route(before, "simt")
    before = _route_counts()
    tc = fa.flash_attention_bwd(*args, **kw)
    _expect_route(before, "tc")
    for x, y in zip(tc, simt):
        tol = TOLS[torch.bfloat16] * max(1.0, y.float().abs().max().item())
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol)
    args32, kw32 = _bwd_case(CASES[1], torch.float32, cuda_device)
    before = _route_counts()
    with pytest.raises(ValueError, match="takes 'f32'"):
        fa.flash_bwd_dq(*args32, route="tc", **kw32)
    assert _route_counts() == before


def test_backward_misaligned_bf16_view_takes_simt(cuda_device):
    """A bf16 view whose rows are not 16-byte units goes to the SIMT
    kernels and still matches the plain version."""
    case = ("odd_rows", 2, 2, 40, 40, 64, True, False, None)
    args, kw = _bwd_case(case, torch.bfloat16, cuda_device)
    q, k, v, lens, lse, delta, g = args
    wide = torch.zeros(2, 2, 40, 65, dtype=q.dtype, device=q.device)
    wide[..., :64] = q
    q = wide[..., :64]                     # t-stride 65: not 16-byte rows
    assert fa.flash_bwd_route(q, k, v, g) == "simt"
    before = _route_counts()
    got = fa.flash_attention_bwd(q, k, v, lens, lse, delta, g, **kw)
    _expect_route(before, "simt")
    want = fa.flash_attention_bwd_reference(q, k, v, lens, lse, delta, g,
                                            **kw)
    for x, y in zip(got, want):
        tol = TOLS[torch.bfloat16] * max(1.0, y.float().abs().max().item())
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol)


def test_autograd_through_the_kernels_on_card(cuda_device):
    """The Function on CUDA tensors: torch autograd reaches K5 and K6, and
    the gradients of strided head-split views equal the plain version's
    autograd (TF32 off, fp32)."""
    rs = np.random.RandomState(9)
    base = torch.from_numpy(rs.randn(2, 37, 3, 4, 64).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 4, 37, 64).astype(np.float32))
    grads = []
    for kernel in (True, False):
        qkv = base.to(cuda_device).requires_grad_(True)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        fn = fa.flash_attention if kernel else fa.flash_attention_reference
        n0 = fa.flash_bwd_dq_launches
        before = _route_counts()
        fn(q, k, v, causal=True).backward(g.to(cuda_device))
        assert fa.flash_bwd_dq_launches == n0 + int(kernel)
        if kernel:     # fp32 head-split views: the f32 K5/K6
            _expect_route(before, "f32")
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-4)


def test_autograd_through_the_tc_route_on_card(cuda_device):
    """bf16 head-split views of a fused QKV buffer (t-stride 3*H*D) take
    the tensor-core kernels through autograd (the forward's too, whose lse
    the backward reads), and their gradients match
    the plain version's autograd on the same bf16 inputs within the bf16
    tolerance (relative to max|plain|)."""
    rs = np.random.RandomState(11)
    base = torch.from_numpy(rs.randn(2, 150, 3, 4, 64).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 4, 150, 64).astype(np.float32))
    g = g.to(cuda_device, torch.bfloat16)
    grads = []
    for kernel in (True, False):
        qkv = base.to(cuda_device, torch.bfloat16).requires_grad_(True)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        fn = fa.flash_attention if kernel else fa.flash_attention_reference
        before = _route_counts()
        before_fwd = _fwd_route_counts()
        fn(q, k, v, causal=True).backward(g)
        if kernel:     # tc K4 -> tc K5/K6
            _expect_route(before, "tc")
            _expect_fwd_route(before_fwd, "tc")
        grads.append(qkv.grad.float())
    tol = TOLS[torch.bfloat16] * max(1.0, grads[1].abs().max().item())
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=tol)


# the f32 routes' cases, (name, b, h, tq, tk, d, causal, cache_offset,
# lengths): causal, lengths with a length-0 entry, cache offset, Tq > Tk,
# D=128 (the GPT's head-split views are their own test below)
F32_CASES = [
    ("causal_T200", 2, 3, 200, 200, 64, True, False, None),
    ("lengths_len0", 3, 2, 70, 130, 64, False, False, [130, 33, 0]),
    ("cache_offset_T5", 3, 2, 5, 140, 64, True, True, [140, 70, 5]),
    ("tq_gt_tk_causal", 2, 2, 150, 40, 64, True, False, None),
    ("causal_d128_T320", 2, 3, 320, 320, 128, True, False, None),
    ("lengths_d128", 2, 2, 66, 100, 128, False, False, [100, 1]),
]


def _held(got, want, valid):
    """dq, dk, dv within 1e-4 of max|plain|, no NaN, exactly 0 where no
    pair reaches."""
    dead_rows, dead_keys = ~valid.any(3), ~valid.any(2)
    for name, x, y, dead in zip(("dq", "dk", "dv"), got, want,
                                (dead_rows, dead_keys, dead_keys)):
        assert not torch.isnan(x).any(), name
        tol = TOLS[torch.float32] * max(1.0, y.abs().max().item())
        torch.testing.assert_close(x, y, rtol=0, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
        mask = dead.unsqueeze(-1).expand_as(x)
        assert (x[mask] == 0).all(), name


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_f32_route_matches_plain_on_card(cuda_device, case):
    """fp32 aligned operands take the f32 kernels, held to 1e-4 of
    max|plain| (the order of fp32 sums), and so does the SIMT route on the
    same inputs."""
    args, kw = _bwd_case(case, torch.float32, cuda_device, seed=4)
    q, k, v, lens, _, _, g = args
    assert fa.flash_bwd_route(q, k, v, g) == "f32"
    want = fa.flash_attention_bwd_reference(*args, **kw)
    valid = fa._valid(q, k, lens, kw["causal"], kw["cache_offset"])
    valid = valid.expand(q.shape[0], 1, q.shape[2], k.shape[2])
    for route in ("f32", "simt"):
        before = _route_counts()
        got = fa.flash_attention_bwd(*args, route=route, **kw)
        torch.cuda.synchronize()
        _expect_route(before, route)
        _held(got, want, valid)


def test_f32_route_on_the_gpt_views_on_card(cuda_device):
    """The fp32 GPT's operands: q, k, v head-split views of one fused
    (B, T, 3, H, D) projection (t-stride 3*H*D floats), the cotangent a
    head-merge view; the f32 kernels take them and match the plain
    version."""
    rs = np.random.RandomState(21)
    b, t, h, d = 2, 150, 12, 64
    qkv = torch.from_numpy(rs.randn(b, t, 3, h, d).astype(np.float32))
    q, k, v = (x.transpose(1, 2) for x in qkv.to(cuda_device).unbind(2))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    g = fa._like_out(q)
    g.copy_(torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32)))
    delta = (g * out).sum(-1)
    args = (q, k, v, None, lse, delta, g)
    assert q.stride(2) == 3 * h * d
    assert fa.flash_bwd_route(q, k, v, g) == "f32"
    before = _route_counts()
    got = fa.flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    _expect_route(before, "f32")
    want = fa.flash_attention_bwd_reference(*args, causal=True)
    valid = fa._valid(q, k, None, True, False).expand(b, 1, t, t)
    _held(got, want, valid)


def test_f32_route_repeats_bit_for_bit(cuda_device):
    """No atomics: the f32 kernels repeat exactly (the causal D=64 case
    and the lengths case at D=128)."""
    for case in (F32_CASES[0], F32_CASES[5]):
        args, kw = _bwd_case(case, torch.float32, cuda_device, seed=6)
        before = _route_counts()
        first = fa.flash_attention_bwd(*args, **kw)
        _expect_route(before, "f32")
        second = fa.flash_attention_bwd(*args, **kw)
        for x, y in zip(first, second):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_f32_forward_matches_plain_on_card(cuda_device, case):
    """The f32 forward, named (Tq = 5 is below the rule's crossover), on
    the f32 backward's cases: o within 1e-4, the lse within 1e-4 with the
    -inf rows identical, rows with no key 0; the SIMT kernel on the same
    inputs too."""
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = (t.to(cuda_device) for t in _inputs(b, h, tq, tk, d, seed=8))
    lens = None if lengths is None else torch.tensor(lengths)
    kw = dict(causal=causal, cache_offset=cache_offset, return_lse=True)
    want, want_lse = fa.flash_attention_reference(q, k, v, lens, **kw)
    for route in ("f32", "simt"):
        before = _fwd_route_counts()
        got, got_lse = fa.flash_attention(q, k, v, lens, route=route, **kw)
        torch.cuda.synchronize()
        _expect_fwd_route(before, route)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        assert torch.equal(torch.isneginf(got_lse), torch.isneginf(want_lse))
        fin = torch.isfinite(want_lse)
        torch.testing.assert_close(got_lse[fin], want_lse[fin], rtol=0,
                                   atol=1e-4)
        assert (got[~fin.unsqueeze(-1).expand_as(got)] == 0).all()


def test_f32_forward_on_the_gpt_views_on_card(cuda_device):
    """The fp32 GPT's forward: q, k, v head-split views of one fused
    (B, T, 3, H, D) projection, o into a (B, T, H, D) buffer; the f32
    kernel takes them by the rule and matches the plain version, and
    autograd runs f32 K4 then f32 K5/K6."""
    rs = np.random.RandomState(23)
    b, t, h, d = 2, 150, 12, 64
    base = torch.from_numpy(rs.randn(b, t, 3, h, d).astype(np.float32))
    qkv = base.to(cuda_device).requires_grad_(True)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    assert fa.flash_fwd_route(q, k, v, fa._like_out(q)) == "f32"
    before, before_bwd = _fwd_route_counts(), _route_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    _expect_fwd_route(before, "f32")
    want = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    assert out.transpose(1, 2).is_contiguous()
    out.sum().backward()
    _expect_route(before_bwd, "f32")
