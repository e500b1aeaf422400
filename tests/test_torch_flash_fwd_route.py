"""The flash forward's route rule and its kernels' plans, on the CPU (no
card, no nvcc).

``flash_attention.flash_fwd_route`` sends a forward call to the bf16
tensor-core kernel of ``csrc/flash_fwd_tc.cu`` (``"tc"``), the fp32
register micro-tile kernel of ``csrc/flash_fwd_f32.cu`` (``"f32"``), the
split kernels of ``csrc/flash_fwd_split.cu`` (``"split"``, a decode step:
one query row) or the SIMT kernel of ``csrc/flash_fwd.cu`` (``"simt"``); it
reads only dtypes, shapes, strides and addresses, so it runs here on CPU
tensors. Three plans are mirrored in Python and held against the plain
version:

* the tensor-core kernel's tiles (``key_tiles``, ``Mask::full`` in
  ``csrc/flash_tc.cuh``; the block and warpgroup loops of
  ``flash_fwd_tc_kernel``): every attended pair is visited exactly once,
  a tile that skips the mask holds only attended pairs, and the causal
  grid launches its heaviest blocks first;
* the split kernels (``flash_fwd_split_kernel`` and
  ``flash_fwd_merge_kernel``): per (b*h, chunk) the key groups' online
  softmax over their keys, the groups' merge in order, the chunk's partial
  (m, l, acc), then the merge of the chunks that hold the row's keys, in
  chunk order, in fp32. Equal to ``flash_attention_reference`` to 1e-6,
  with empty chunks, length-0 slots and ``cache_offset``, and to the JAX
  package's ``_flash_fwd`` (Pallas, interpret mode) on the same numpy
  inputs;
* the f32 kernel (``flash_fwd_f32_kernel``), thread by thread: a warp's
  whole rows, the 2 x 8 score micro-tiles read from TMA's swizzled tiles,
  the row max over the 8 lanes of a row, P through the swizzled P tile,
  the P.V micro-tiles and the epilogue. Equal to the JAX package's
  ``_flash_fwd`` (interpret mode) with lengths (a 0 among them),
  ``cache_offset`` and causal masks; its shared loads are one wavefront.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_attention as pa

import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

TILE = 64
LOG2E = 1.4426950408889634


def _zeros(b, h, t, d, dtype=torch.bfloat16):
    return torch.zeros(b, h, t, d, dtype=dtype)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_aligned_training_shapes_take_the_tensor_cores(d):
    q, k, v = (_zeros(2, 3, t, d) for t in (40, 40, 40))
    assert fa.flash_fwd_route(q, k, v) == "tc"
    assert fa.flash_fwd_route(q, k, v, fa._like_out(q)) == "tc"


def test_head_split_views_of_a_fused_projection_take_the_tensor_cores():
    """The GPT's q, k, v: views of one (B, T, 3, H, D) buffer, t-stride
    3*H*D elements, the output a (B, H, T, D) view of (B, T, H, D)."""
    qkv = torch.zeros(2, 256, 3, 12, 64, dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert not q.is_contiguous() and q.stride(2) == 3 * 12 * 64
    assert fa.flash_fwd_route(q, k, v, fa._like_out(q)) == "tc"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq", [2, 16, 256])
def test_fp32_aligned_prompts_and_training_take_the_f32_kernel(d, tq):
    """fp32, D 64 or 128, every operand 16-byte aligned, more than one
    query row (from ``FWD_F32_MIN_TQ``): the register micro-tile kernel."""
    q, k, v = (_zeros(2, 3, t, d, torch.float32) for t in (tq, 300, 300))
    want = "f32" if tq >= fa.FWD_F32_MIN_TQ else "simt"
    assert fa.flash_fwd_route(q, k, v) == want
    assert fa.flash_fwd_route(q, k, v, fa._like_out(q)) == want
    assert "f32" in fa._fwd_routes(q, k, v, None)
    assert "f32" not in fa._fwd_routes(q[:, :, :1], k, v, None)


@pytest.mark.parametrize("b", [1, 8, 64])
def test_the_fp32_crossover_is_in_query_rows_at_every_batch(b):
    """The f32 forward's crossover with SIMT was measured at 33 query rows
    from 12 to 768 heads (``tools/torch_flash_fwd_routes.py``): the rule
    keys on Tq alone, whatever the grid."""
    for tq, want in ((fa.FWD_F32_MIN_TQ - 1, "simt"),
                     (fa.FWD_F32_MIN_TQ, "f32")):
        q, k, v = (_zeros(b, 12, tq, 64, torch.float32) for _ in range(3))
        assert fa.flash_fwd_route(q, k, v) == want
    assert fa.FWD_F32_MIN_TQ == 33


def test_fp32_head_split_views_of_a_fused_projection_take_the_f32_kernel():
    """The fp32 GPT's q, k, v: views of one (B, T, 3, H, D) buffer (rows
    3*H*D floats apart, k and v H*D floats into each row), the output a
    (B, H, T, D) view of (B, T, H, D)."""
    qkv = torch.zeros(2, 256, 3, 12, 64)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert fa.flash_fwd_route(q, k, v, fa._like_out(q)) == "f32"


@pytest.mark.parametrize("case", ["row_stride", "base", "out_base",
                                  "strided_head_dim"])
def test_fp32_misaligned_views_take_the_simt_kernel(case):
    q, k, v = (_zeros(2, 3, t, 64, torch.float32) for t in (16, 70, 70))
    out = fa._like_out(q)
    if case == "row_stride":             # rows of 65 floats
        q = torch.zeros(2, 3, 16, 65)[..., :64]
    elif case == "base":                 # a view 4 bytes into its buffer
        k = torch.zeros(2, 3, 70, 65)[..., 1:]
        assert k.data_ptr() % 16 == 4
    elif case == "out_base":
        out = torch.zeros(2, 16, 3, 65)[..., 1:].transpose(1, 2)
    else:
        v = torch.zeros(2, 3, 70, 128)[..., ::2]
    assert fa.flash_fwd_route(q, k, v, out) == "simt"


@pytest.mark.parametrize("case", ["fp32", "d32", "row_stride", "base",
                                  "v_row_stride", "strided_head_dim",
                                  "mixed_dtype"])
def test_everything_else_takes_the_simt_kernel(case):
    """bf16 and fp32 calls no tensor-core, f32 or split kernel takes: D =
    32 (fp32 at D = 32 here: the f32 kernel takes D 64 and 128),
    misaligned rows, bases and head dims, mixed types."""
    d = 32 if case in ("d32", "fp32") else 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    tq = 2
    q, k, v = (_zeros(2, 3, t, d, dtype) for t in (tq, 70, 70))
    if case == "row_stride":             # rows of 65 bf16: not 16-byte units
        q = torch.zeros(2, 3, tq, 65, dtype=dtype)[..., :64]
    elif case == "base":                 # a view 2 bytes into its buffer
        k = torch.zeros(2, 3, 70, 65, dtype=dtype)[..., 1:]
        assert k.data_ptr() % 16 == 2
    elif case == "v_row_stride":
        v = torch.zeros(2, 3, 70, 72 + 4, dtype=dtype)[..., :64]
    elif case == "strided_head_dim":
        v = torch.zeros(2, 3, 70, 128, dtype=dtype)[..., ::2]
    elif case == "mixed_dtype":
        v = v.float()
    assert fa.flash_fwd_route(q, k, v) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_sized_query_counts_take_the_split_kernels(dtype, d):
    """The serving step: Tq = 1 against a contiguous (S, H, T, D) cache,
    q a view of the fused projection. Two query rows or more (a prompt,
    Tq = 16 against the cache with its offset) take tc, f32 or SIMT."""
    qkv = torch.zeros(8, 1, 3, 12, d, dtype=dtype)
    q = qkv.unbind(2)[0].transpose(1, 2)
    cache = torch.zeros(8, 12, 512, d, dtype=dtype)
    assert fa.flash_fwd_route(q, cache, cache, fa._like_out(q)) == "split"
    for tq in (2, 16):
        want = "simt" if d == 32 else "tc" if dtype == torch.bfloat16 \
            else "f32" if tq >= fa.FWD_F32_MIN_TQ else "simt"
        q = _zeros(8, 12, tq, d, dtype)
        assert fa.flash_fwd_route(q, cache, cache) == want
        assert "split" not in fa._fwd_routes(q, cache, cache, None)


def test_misaligned_decode_takes_the_simt_kernel():
    q = torch.zeros(8, 12, 1, 65)[..., 1:]
    cache = torch.zeros(8, 12, 512, 64)
    assert fa.flash_fwd_route(q, cache, cache) == "simt"


def test_named_routes_only_where_their_kernels_take_the_call():
    """``route="simt"`` takes any call, ``"tc"`` aligned bf16 operands
    with D 64 or 128 (at any Tq: to time one route beside another),
    ``"f32"`` aligned fp32 operands with D 64 or 128 and more than one
    query row, ``"split"`` aligned operands with one query row; a route
    whose kernel cannot take the call raises, on the CPU too, where the
    plain version runs either way."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, t, 64).astype(np.float32))
               for t in (6, 9, 9))
    want = fa.flash_attention_reference(q, k, v, causal=True)
    for route in ("simt", "f32"):
        assert torch.equal(fa.flash_attention(q, k, v, causal=True,
                                              route=route), want)
    rule = fa.flash_fwd_route(q, k, v)      # a 6-row prompt: SIMT
    assert rule == ("f32" if 6 >= fa.FWD_F32_MIN_TQ else "simt")
    for route in ("split", "tc"):
        with pytest.raises(ValueError, match=f"route '{route}'.*takes "
                                             f"'{rule}'"):
            fa.flash_attention(q, k, v, causal=True, route=route)
    for route in ("simt", "split"):
        fa.flash_attention(q[:, :, :1], k, v, causal=True, route=route)
    with pytest.raises(ValueError, match="route 'f32'.*takes 'split'"):
        fa.flash_attention(q[:, :, :1], k, v, causal=True, route="f32")
    bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
    for route in ("simt", "tc"):
        fa.flash_attention(bq, bk, bv, causal=True, route=route)
    with pytest.raises(ValueError, match="route 'split'.*takes 'tc'"):
        fa.flash_attention(bq, bk, bv, causal=True, route="split")
    for route in ("simt", "split", "tc"):
        fa.flash_attention(bq[:, :, :1], bk, bv, causal=True, route=route)
    with pytest.raises(ValueError, match="route 'f32'.*takes 'tc'"):
        fa.flash_attention(bq, bk, bv, causal=True, route="f32")
    odd = torch.zeros(1, 2, 6, 65, dtype=torch.bfloat16)[..., :64]
    for route in ("split", "tc", "f32"):
        with pytest.raises(ValueError, match="takes 'simt'"):
            fa.flash_attention(odd, bk, bv, route=route)
    with pytest.raises(ValueError, match="route 'cuda'"):
        fa.flash_attention(bq, bk, bv, route="cuda")
    # and through autograd
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="route 'tc'"):
        fa.flash_attention(qg, k, v, route="tc")


# ---------------------------------------------------------------------------
# the tensor-core kernel's tile plan, mirrored
# ---------------------------------------------------------------------------
def _mask(tq, tk, causal, cache_offset, klen):
    """``make_mask``: (kmax, diag)."""
    klen = tk if klen is None else klen
    return min(tk, klen), (klen - tq if cache_offset else tk - tq)


def _kend(q0, tq, kmax, diag, causal):
    """``Mask::kend``: one past the last key rows [q0, q0 + 64) attend."""
    return min(kmax, min(q0 + TILE, tq) - 1 + diag + 1) if causal else kmax


def _key_tiles(q0, tq, kmax, diag, causal):
    kend = _kend(q0, tq, kmax, diag, causal)
    return -(-kend // TILE) if kend > 0 else 0


def _full(q0, k0, tq, kmax, diag, causal):
    """``Mask::full``: every pair of the 64 x 64 tile is attended."""
    return q0 + TILE <= tq and k0 + TILE <= kmax and \
        (not causal or k0 + TILE - 1 <= q0 + diag)


def tc_plan(tq, tk, causal, cache_offset=False, klen=None):
    """The blocks of the tensor-core forward in launch order: (query
    start, [(key tile start, full)])."""
    kmax, diag = _mask(tq, tk, causal, cache_offset, klen)
    ny = -(-tq // TILE)
    blocks = []
    for by in range(ny):
        q0 = (ny - 1 - by) * TILE
        ntiles = _key_tiles(q0, tq, kmax, diag, causal)
        blocks.append((q0, [(j * TILE, _full(q0, j * TILE, tq, kmax, diag,
                                             causal))
                            for j in range(ntiles)]))
    return blocks


def _check_tc_plan(b, tq, tk, causal, cache_offset, lengths):
    q = torch.zeros(b, 1, tq, 1)
    k = torch.zeros(b, 1, tk, 1)
    lens = None if lengths is None else torch.tensor(lengths)
    valid = fa._valid(q, k, lens, causal, cache_offset)
    valid = valid.expand(b, 1, tq, tk)[:, 0].numpy()
    for bi in range(b):
        klen = None if lengths is None else int(lengths[bi])
        v = valid[bi]
        seen = np.zeros(v.shape, dtype=int)
        for q0, tiles in tc_plan(tq, tk, causal, cache_offset, klen):
            for k0, full in tiles:
                assert 0 <= q0 < tq and 0 <= k0 < tk
                block = v[q0:q0 + TILE, k0:k0 + TILE]
                if full:                  # no mask: all pairs attended
                    assert block.shape == (TILE, TILE) and block.all(), \
                        (bi, q0, k0)
                seen[q0:q0 + TILE, k0:k0 + TILE] += 1
        # every attended pair visited exactly once; what is skipped holds
        # none
        assert not (v & (seen == 0)).any(), bi
        assert seen.max() <= 1


def _plan_cases():
    out = [("train_causal_B8_T256", 8, 256, 256, True, False, None),
           ("causal_D128_B2_T512", 2, 512, 512, True, False, None),
           ("tq_gt_tk_causal", 2, 256, 64, True, False, None),
           ("lengths", 4, 128, 384, False, False, [384, 200, 17, 0]),
           ("cache_offset_T16", 4, 16, 512, True, True, [512, 300, 64, 16]),
           ("ragged_tq", 2, 200, 131, True, False, [131, 70])]
    rs = np.random.RandomState(11)
    for i in range(10):
        b = int(rs.randint(1, 4))
        tq, tk = (int(x) for x in rs.randint(1, 300, size=2))
        causal = bool(rs.randint(2))
        cache_offset = causal and bool(rs.randint(2))
        lengths = None
        if cache_offset or rs.randint(2):
            lengths = [int(x) for x in rs.randint(0, tk + 1, size=b)]
            if cache_offset:      # the fill holds the queries
                lengths = [max(x, tq) if x else 0 for x in lengths]
                tk = max(tk, max(lengths))
        out.append((f"random_{i}", b, tq, tk, causal, cache_offset,
                    lengths))
    return out


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_tc_plan_covers_every_pair_once_and_masks_where_it_must(case):
    _, b, tq, tk, causal, cache_offset, lengths = case
    _check_tc_plan(b, tq, tk, causal, cache_offset, lengths)


def test_tc_causal_plan_puts_the_heaviest_blocks_first():
    """The grid launches the last query tiles first: under a causal mask
    they walk the most key tiles."""
    plan = tc_plan(256, 256, True)
    ntiles = [len(t) for _, t in plan]
    assert ntiles == [4, 3, 2, 1]
    assert [q0 for q0, _ in plan] == [192, 128, 64, 0]
    # at the training shape only the diagonal tiles take the mask
    masked = sum(not f for _, t in plan for _, f in t)
    assert masked == 4


def test_tc_plan_of_empty_rows():
    """Tq > Tk causal and a length-0 entry: no tile is walked where no pair
    is attended, so the kernel writes 0 and -inf there."""
    walked = dict(tc_plan(256, 64, True))       # rows < 192 see no key
    assert walked[0] == walked[64] == walked[128] == []
    assert len(walked[192]) == 1
    assert all(t == [] for _, t in tc_plan(19, 56, False, klen=0))


# ---------------------------------------------------------------------------
# the split kernels' plan and merge, mirrored
# ---------------------------------------------------------------------------
def _groups(dtype, d):
    """NG = 128 / G key groups a block, G = D / VEC lanes a key row."""
    vec = 4 if dtype == torch.float32 else 8
    return 128 // (d // vec)


def split_mirror(q, k, v, lengths=None, scale=None, groups=8, sms=132):
    """``flash_fwd_split_kernel`` then ``flash_fwd_merge_kernel`` in plain
    fp32 PyTorch, in the kernels' order, for one query row; returns (out,
    lse). The row attends keys [0, min(Tk, lengths[b])): at Tq = 1 a
    causal bound, bottom-right or at the fill, cuts none of them."""
    b, h, tq, d = q.shape
    assert tq == 1
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    chunk, nchunks = fa.split_plan(b, h, tk, sms)
    ninf = float("-inf")
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m_p = torch.full((b, h, nchunks), ninf)
    l_p = torch.zeros(b, h, nchunks)
    a_p = torch.zeros(b, h, nchunks, d)
    written = torch.zeros(b, nchunks, dtype=torch.bool)
    kends = [tk if lengths is None else min(tk, int(lengths[bi]))
             for bi in range(b)]
    for bi in range(b):
        for c in range(nchunks):
            c0 = c * chunk
            c1 = min(c0 + chunk, kends[bi])
            if c0 >= c1:
                continue          # the block returns
            qs = q[bi, :, 0].float() * sl2                     # (h, d)
            gm, gl, ga = [], [], []
            for g in range(groups):
                keys = list(range(c0 + g, c1, groups))
                if not keys:
                    gm.append(torch.full((h,), ninf))
                    gl.append(torch.zeros(h))
                    ga.append(torch.zeros(h, d))
                    continue
                s = torch.einsum("hd,hkd->hk", qs, k[bi, :, keys].float())
                mx = s.amax(-1)
                p = torch.exp2(s - mx[:, None])
                gm.append(mx)
                gl.append(p.sum(-1))
                ga.append(torch.einsum("hk,hkd->hd", p,
                                       v[bi, :, keys].float()))
            gm, gl, ga = (torch.stack(x) for x in (gm, gl, ga))
            mm = gm.amax(0)
            mu = torch.where(torch.isinf(mm), 0.0, mm)
            w = torch.exp2(gm - mu)                             # (ng, h)
            m_p[bi, :, c] = mm
            l_p[bi, :, c] = (gl * w).sum(0)
            a_p[bi, :, c] = (ga * w[..., None]).sum(0)
            written[bi, c] = True
    out = torch.zeros(b, h, 1, d)
    lse = torch.full((b, h, 1), ninf)
    for bi in range(b):
        e = kends[bi]
        n = min(nchunks, -(-e // chunk)) if e > 0 else 0
        if n == 0:
            continue
        # every chunk the merge reads was written and holds a key
        assert written[bi, :n].all()
        assert torch.isfinite(m_p[bi, :, :n]).all()
        mm = m_p[bi, :, :n].amax(-1)                            # (h,)
        w = torch.exp2(m_p[bi, :, :n] - mm[:, None])
        ll = (l_p[bi, :, :n] * w).sum(-1)
        aa = (a_p[bi, :, :n] * w[..., None]).sum(1)
        out[bi, :, 0] = aa / ll[:, None]
        lse[bi, :, 0] = (mm + torch.log2(ll)) / LOG2E
    return out.to(q.dtype), lse


def _inputs(b, h, tq, tk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, tq, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32))


# (name, b, h, tk, d, causal, cache_offset, lengths, sms): one query row;
# sms sets the plan's SM count
SPLIT_CASES = [
    ("decode_S8_Tk512", 8, 2, 512, 64, True, True,
     [1, 7, 64, 65, 129, 300, 511, 512], 132),
    ("decode_length0_slot", 3, 2, 200, 32, True, True, [0, 200, 63], 132),
    ("lengths_empty_chunks", 3, 2, 384, 128, False, False, [384, 70, 0],
     132),
    ("causal_no_lengths", 2, 2, 300, 64, True, False, None, 132),
    ("long_chunks", 4, 2, 700, 32, True, True, [700, 1, 640, 129], 4),
    ("one_chunk", 2, 2, 60, 64, False, False, None, 132),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_groups", "bf16_groups"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_mirror_matches_the_plain_version(case, dtype):
    """In fp32 whatever the kernel's dtype: ``dtype`` picks the plan's
    group count (the kernel's NG for that type and D)."""
    _, b, h, tk, d, causal, cache_offset, lengths, sms = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, h, 1, tk, d))
    lens = None if lengths is None else torch.tensor(lengths)
    got, got_lse = split_mirror(q, k, v, lens, groups=_groups(dtype, d),
                                sms=sms)
    want, want_lse = fa.flash_attention_reference(
        q, k, v, lens, causal=causal, cache_offset=cache_offset,
        return_lse=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(torch.isinf(got_lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(got_lse[fin], want_lse[fin], rtol=0,
                               atol=1e-6)
    assert not torch.isnan(got).any()


def test_split_plan_fills_the_card_at_the_decode_shape():
    """8 slots x 12 heads, a 512-key cache: 8 chunks of one 64-key tile,
    768 blocks on 132 SMs; a wider batch takes longer chunks, and a short
    cache one chunk."""
    assert fa.split_plan(8, 12, 512) == (64, 8)
    chunk, n = fa.split_plan(64, 12, 512)
    assert chunk % 64 == 0 and chunk > 64
    assert n == -(-512 // chunk) and 64 * 12 * n >= 132
    assert fa.split_plan(8, 12, 40) == (64, 1)
    for b, h, tk in ((1, 1, 1), (3, 5, 1000), (8, 12, 512), (4, 2, 700)):
        chunk, n = fa.split_plan(b, h, tk)
        assert chunk % 64 == 0 and (n - 1) * chunk < tk <= n * chunk
    # a plan of few SMs: chunks of several tiles, as ``long_chunks`` takes
    assert fa.split_plan(4, 2, 700, sms=4) == (192, 4)


@pytest.mark.parametrize("case", SPLIT_CASES[:4],
                         ids=[c[0] for c in SPLIT_CASES[:4]])
def test_split_mirror_matches_the_pallas_kernel(case):
    """The mirror against the JAX package's ``_flash_fwd`` (interpret
    mode) on the same numpy inputs: both fp32, sums in other orders."""
    _, b, h, tk, d, causal, cache_offset, lengths, sms = case
    q, k, v = _inputs(b, h, 1, tk, d, seed=4)
    scale = 1.0 / np.sqrt(d)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want_o, want_lse = pa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), scale, causal, True,
        return_lse=True, cache_offset=cache_offset)
    got_o, got_lse = split_mirror(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if lens is None else torch.from_numpy(lens),
        groups=_groups(torch.float32, d), sms=sms)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=2e-5)
    want_lse = np.asarray(want_lse)
    np.testing.assert_array_equal(np.isinf(got_lse.numpy()),
                                  np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[fin], want_lse[fin],
                               rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the f32 kernel, mirrored thread by thread
# ---------------------------------------------------------------------------
def _bwd_mirror():
    """The swizzle helpers of the fp32 backward's mirror
    (tests/test_torch_flash_bwd_route.py): the same tiles and offsets."""
    path = pathlib.Path(__file__).resolve().parent / \
        "test_torch_flash_bwd_route.py"
    spec = importlib.util.spec_from_file_location("_flash_bwd_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_bm = _bwd_mirror()
F32_THREADS = 256


def _f32_fwd_threads():
    """Per thread (256) of ``flash_fwd_f32_kernel``: lx, its 2 query rows
    ra + 4i (ra = 8 * warp + lane / 8) and its 8 keys lx + 8j of a tile."""
    tid = np.arange(F32_THREADS)
    warp, lane = tid >> 5, tid & 31
    ly, lx = lane >> 3, lane & 7
    ra = (8 * warp + ly)[:, None] + 4 * np.arange(2)
    keys = lx[:, None] + 8 * np.arange(8)
    return lx, ra, keys


def _row_lanes(x):
    """A per-thread (256, ...) value reduced over the 8 lanes of each row
    group (lanes with one lane / 8 in a warp: the kernel's shuffles over
    xor 1, 2, 4), broadcast back: (256, ...) -> the group's values."""
    return x.reshape(8, 4, 8, *x.shape[1:])


def f32_fwd_mirror(q, k, v, lengths, causal, cache_offset):
    """``flash_fwd_f32_kernel`` block by block and thread by thread on
    numpy (B, H, T, D) inputs: (o, lse). TMA zero-fills rows past Tq and
    Tk; every output element is written once."""
    b_, h_, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / np.sqrt(d)
    sl2 = np.float32(scale * np.log2(np.e))
    lx, ra, keys = _f32_fwd_threads()
    o = np.full(q.shape, np.nan, np.float32)
    lse = np.full(q.shape[:3], np.nan, np.float32)
    # the thread's output chunks u: columns 4 * (lx + 8u) .. + 3
    cols = (4 * (lx[:, None] + 8 * np.arange(d // 32)))[:, :, None] \
        + np.arange(4)
    cols = cols.reshape(F32_THREADS, d // 8)
    t = np.arange(TILE)[None, :, None]
    u = np.arange(d // 32)[None, None, :]
    v_off = (t * 128 + ((lx[:, None, None] ^ (t & 7)) << 4)
             + u * _bm.BOX) // 4                    # V's chunk lx of box u
    with np.errstate(over="ignore", invalid="ignore"):
        for b in range(b_):
            klen = None if lengths is None else int(lengths[b])
            kmax, diag = _mask(tq, tk, causal, cache_offset, klen)
            for h in range(h_):
                qb, kb, vb = q[b, h], k[b, h], v[b, h]
                for q0, tiles in tc_plan(tq, tk, causal, cache_offset,
                                         klen):
                    qa = _bm._gather_rows(_bm._load_tile(qb, q0, tq, d), ra,
                                          d)
                    rows = q0 + ra
                    acc = np.zeros((F32_THREADS, 2, d // 8), np.float64)
                    mrow = np.full((F32_THREADS, 2), -np.inf)
                    lrow = np.zeros((F32_THREADS, 2))
                    for j0, full in tiles:
                        kt = _bm._load_tile(kb, j0, tk, d)
                        vt = _bm._load_tile(vb, j0, tk, d)
                        s = np.einsum("tid,tjd->tij", qa,
                                      _bm._gather_rows(kt, keys, d)) * sl2
                        if not full:
                            s = np.where(_bm._ok(rows[:, :, None],
                                                 j0 + keys[:, None, :], tq,
                                                 kmax, diag, causal), s,
                                         -np.inf)
                        mx = _row_lanes(s.max(axis=2)).max(axis=2,
                                                           keepdims=True)
                        mx = np.broadcast_to(mx, (8, 4, 8, 2)).reshape(
                            F32_THREADS, 2)
                        mnew = np.maximum(mrow, mx)
                        muse = np.where(mnew == -np.inf, 0.0, mnew)
                        alpha = np.exp2(mrow - muse)
                        p = np.exp2(s - muse[:, :, None])
                        mrow = mnew
                        lrow = lrow * alpha + p.sum(axis=2)
                        pt = _store_p(p, ra, keys)
                        x = _bm._gather_rows(pt, ra, TILE)  # (256, 2, 64)
                        vv = vt[v_off[..., None] + np.arange(4)].reshape(
                            F32_THREADS, TILE, d // 8)
                        acc = acc * alpha[:, :, None] + x @ vv
                    l = np.broadcast_to(_row_lanes(lrow).sum(
                        axis=2, keepdims=True), (8, 4, 8, 2)).reshape(
                        F32_THREADS, 2)
                    inv = np.where(l > 0, 1.0 / np.where(l > 0, l, 1.0), 0.0)
                    out = acc * inv[:, :, None]
                    r = np.broadcast_to(rows[:, :, None], out.shape)
                    c = np.broadcast_to(cols[:, None, :], out.shape)
                    flat = r * d + c
                    assert np.unique(flat).size == flat.size == TILE * d
                    keep = r < tq
                    o[b, h][r[keep], c[keep]] = out[keep]
                    lv = np.where(l > 0, (mrow + np.log2(np.where(
                        l > 0, l, 1.0))) * np.log(2.0), -np.inf)
                    first = (lx == 0)[:, None] & (rows < tq)
                    lse[b, h][rows[first]] = lv[first]
    return o, lse


def _store_p(p, ra, keys):
    """``st1`` of every thread's 2 x 8 P values into the swizzled 64 x 64
    P tile; each word is written exactly once."""
    tile = np.full(TILE * TILE, np.nan, np.float32)
    col = np.broadcast_to(keys[:, None, :], p.shape)
    row = np.broadcast_to(ra[:, :, None], p.shape)
    word = (_bm._chunk_off(_bm._row_key(row), col >> 2) + (col & 3) * 4) // 4
    assert np.unique(word).size == word.size == tile.size
    tile[word] = p
    return tile


# (name, b, tq, tk, d, causal, cache_offset, lengths)
F32_FWD_CASES = [
    ("causal_T130_D64", 1, 130, 130, 64, True, False, None),
    ("lengths_zero_T70x100_D64", 3, 70, 100, 64, False, False, [100, 33, 0]),
    ("cache_offset_T16x140_D128", 2, 16, 140, 128, True, True, [140, 70]),
    ("tq_gt_tk_causal_T150x40_D64", 1, 150, 40, 64, True, False, None),
    ("noncausal_T100x200_D128", 1, 100, 200, 128, False, False, None),
    ("causal_lengths_T96_D64", 2, 96, 96, 64, True, False, [96, 0]),
    ("causal_T256_D64", 1, 256, 256, 64, True, False, None),
]


@pytest.mark.parametrize("case", F32_FWD_CASES,
                         ids=[c[0] for c in F32_FWD_CASES])
def test_f32_fwd_mirror_matches_the_pallas_kernel(case):
    """The mirror against the JAX package's ``_flash_fwd`` (interpret
    mode) and the plain version on the same numpy inputs: o and the lse
    within 2e-5 (fp32 both, the sums in other orders), the -inf rows
    identical, rows with no key 0."""
    _, b, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = _inputs(b, 2, tq, tk, d, seed=5)
    scale = 1.0 / np.sqrt(d)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want_o, want_lse = pa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), scale, causal, True,
        return_lse=True, cache_offset=cache_offset)
    got_o, got_lse = f32_fwd_mirror(q, k, v, lengths, causal, cache_offset)
    assert not np.isnan(got_o).any() and not np.isnan(got_lse).any()
    want_o, want_lse = np.asarray(want_o), np.asarray(want_lse)
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(np.isinf(got_lse), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse[fin], want_lse[fin], rtol=1e-5,
                               atol=2e-5)
    assert (got_o[np.isinf(got_lse)] == 0).all()
    plain_o, plain_lse = fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if lens is None else torch.from_numpy(lens), causal=causal,
        cache_offset=cache_offset, return_lse=True)
    np.testing.assert_allclose(got_o, plain_o.numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_f32_fwd_loads_are_one_wavefront(d):
    """Each float4 load of a warp in ``flash_fwd_f32_kernel`` (Q rows and
    K rows of S = Q.K^T, P rows and V chunks of P.V) touches distinct bank
    quads: one wavefront, broadcast over the lanes that share an address.
    A load reads 4 distinct Q (or P) rows and 8 distinct K rows or V
    chunks; the immediate forms (``RowOffs``) land on the swizzle."""
    lx, ra, keys = _f32_fwd_threads()
    for w in range(8):
        lanes = slice(32 * w, 32 * w + 32)
        for c in range(max(d, TILE) // 4):
            for i in range(2):
                off = _bm._chunk_off(_bm._row_key(ra[lanes, i]), c)
                assert _bm._wavefronts(off) == 1 and np.unique(off).size == 4
                assert (_bm._step4(ra[lanes, 0], i, c) == off).all()
            if c < d // 4:
                for j in range(8):
                    off = _bm._chunk_off(_bm._row_key(keys[lanes, j]), c)
                    assert _bm._wavefronts(off) == 1 \
                        and np.unique(off).size == 8
                    assert (_bm._step8(keys[lanes, 0], j, c) == off).all()
        for t in range(TILE):
            for u in range(d // 32):
                off = t * 128 + ((lx[lanes] ^ (t & 7)) << 4) + u * _bm.BOX
                assert _bm._wavefronts(off) == 1 and np.unique(off).size == 8
