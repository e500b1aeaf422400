"""The flash backward's route rule and the kernels' plans, on the CPU (no
card, no nvcc).

``flash_attention.flash_bwd_route`` sends a backward call to the bf16
tensor-core kernels of ``csrc/flash_bwd_tc.cu``, the fp32 kernels of
``csrc/flash_bwd_f32.cu`` or the SIMT kernels of ``csrc/flash_bwd.cu``;
it reads only dtypes, shapes, strides and addresses, so it runs here on
CPU tensors. The tile plan below mirrors the loops of the tensor-core and
the fp32 kernels, which walk the same tiles (``key_tiles``, ``dkv_tiles``
and ``Mask::full`` in ``csrc/flash_tc.cuh``), and is held against the
dense mask of the plain version (``flash_attention._valid``): every
attended pair is visited by both kernels, no tile a kernel skips holds
one, and no tile that skips the mask holds a pair that is not attended.
The accumulator-to-A fragment map of ``hopper.cuh`` (``pack_a``) covers a
64 x 64 tile exactly once. The fp32 kernels' swizzled tiles and register
micro-tiles are mirrored in numpy, thread by thread, and run end to end
against the plain version; their shared-memory loads are checked for
bank conflicts.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import flash_attention as fa

ROOT = pathlib.Path(__file__).resolve().parent.parent
TILE = 64


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zeros(b, h, t, d, dtype=torch.bfloat16):
    return torch.zeros(b, h, t, d, dtype=dtype)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_aligned_operands_take_the_tensor_cores(d):
    q, k, v, g = (_zeros(2, 3, t, d) for t in (5, 7, 7, 5))
    assert fa.flash_bwd_route(q, k, v, g) == "tc"
    outs = (fa._like_out(k), fa._like_out(v))
    assert fa.flash_bwd_route(q, k, v, g, outs) == "tc"


def test_head_split_views_of_a_fused_projection_take_the_tensor_cores():
    """The GPT's q, k, v: views of one (B, T, 3, H, D) buffer, t-stride
    3*H*D elements; the head merge of the output is a view too."""
    qkv = torch.zeros(2, 37, 3, 4, 64, dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert not q.is_contiguous() and q.stride(2) == 3 * 4 * 64
    g = fa._like_out(q)
    assert fa.flash_bwd_route(q, k, v, g) == "tc"


@pytest.mark.parametrize("case", ["fp32", "d32", "row_stride", "base",
                                  "g_row_stride", "strided_head_dim",
                                  "mixed_dtype"])
def test_everything_else_takes_the_simt_kernels(case):
    d = 32 if case == "d32" else 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v, g = (_zeros(2, 3, t, d, dtype) for t in (5, 7, 7, 5))
    if case == "fp32":                   # rows of 66 floats: 264 bytes
        q = torch.zeros(2, 3, 5, 66, dtype=dtype)[..., :64]
    elif case == "row_stride":           # rows of 65 bf16: not 16-byte units
        q = torch.zeros(2, 3, 5, 65, dtype=dtype)[..., :64]
    elif case == "base":                 # a view 2 bytes into its buffer
        k = torch.zeros(2, 3, 7, 65, dtype=dtype)[..., 1:]
        assert k.data_ptr() % 16 == 2
    elif case == "g_row_stride":
        g = torch.zeros(2, 3, 5, 72 + 4, dtype=dtype)[..., :64]
    elif case == "strided_head_dim":
        v = torch.zeros(2, 3, 7, 128, dtype=dtype)[..., ::2]
    elif case == "mixed_dtype":
        g = g.float()
    assert fa.flash_bwd_route(q, k, v, g) == "simt"


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_aligned_operands_take_the_f32_kernels(d):
    q, k, v, g = (_zeros(2, 3, t, d, torch.float32) for t in (5, 7, 7, 5))
    assert fa.flash_bwd_route(q, k, v, g) == "f32"
    outs = (fa._like_out(k), fa._like_out(v))
    assert fa.flash_bwd_route(q, k, v, g, outs) == "f32"
    assert fa.flash_bwd_route(q, k, v, g, (fa._like_out(q),)) == "f32"


def test_fp32_head_split_views_of_a_fused_projection_take_the_f32_kernels():
    """The fp32 GPT's q, k, v: views of one (B, T, 3, H, D) buffer,
    t-stride 3*H*D = 2304 floats at the model's widths; the outputs are
    the head-merge views of ``_like_out``."""
    qkv = torch.zeros(2, 37, 3, 12, 64)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert q.stride(2) == 2304 and not q.is_contiguous()
    g = fa._like_out(q)
    outs = (fa._like_out(k), fa._like_out(v))
    assert fa.flash_bwd_route(q, k, v, g, outs) == "f32"
    assert fa.flash_bwd_route(q, k, v, g, (fa._like_out(q),)) == "f32"


@pytest.mark.parametrize("case", ["d32", "row_stride", "base", "out_base",
                                  "g_head_stride", "mixed_dtype"])
def test_fp32_misaligned_views_and_d32_take_the_simt_kernels(case):
    d = 32 if case == "d32" else 64
    q, k, v, g = (_zeros(2, 3, t, d, torch.float32) for t in (5, 7, 7, 5))
    outs = ()
    if case == "row_stride":             # rows of 65 floats
        k = torch.zeros(2, 3, 7, 65)[..., :64]
    elif case == "base":                 # a view 4 bytes into its buffer
        v = torch.zeros(2, 3, 7, 65)[..., 1:]
        assert v.data_ptr() % 16 == 4
    elif case == "out_base":
        outs = (torch.zeros(2 * 3 * 7 * 64 + 2)[2:].view(2, 3, 7, 64),)
    elif case == "g_head_stride":        # heads 5*64 + 2 floats apart
        g = torch.zeros(2, 3 * 322)[:, :3 * 322].as_strided(
            (2, 3, 5, 64), (3 * 322, 322, 64, 1))
    elif case == "mixed_dtype":
        g = g.to(torch.bfloat16)
    assert fa.flash_bwd_route(q, k, v, g, outs) == "simt"


def test_dims_of_size_one_have_no_stride_to_hold_to():
    """Tq = 1 (a decode-sized backward) and B = H = 1: whatever strides
    those dims carry, the operands stay on the tensor cores."""
    base = torch.zeros(1, 1, 3, 64, dtype=torch.bfloat16)
    q = base[:, :, :1].as_strided((1, 1, 1, 64), (7, 5, 3, 1))
    k = v = torch.zeros(1, 1, 9, 64, dtype=torch.bfloat16)
    assert fa.flash_bwd_route(q, k, v, q) == "tc"


def test_named_routes_simt_anywhere_tc_only_where_the_rule_sends_it():
    """``route="simt"`` is taken for any call (bf16 and fp32 timed on the
    SIMT kernels), ``route="tc"`` raises where the rule says f32; on the
    CPU the plain version runs either way."""
    rs = np.random.RandomState(0)
    b, h, t, d = 1, 2, 6, 64
    q, k, v, g = (torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32))
                  for _ in range(4))
    lse = torch.zeros(b, h, t)
    delta = torch.zeros(b, h, t)
    args = (q, k, v, None, lse, delta, g)
    want = fa.flash_attention_bwd_reference(*args, causal=True)
    for x, y in zip(fa.flash_attention_bwd(*args, causal=True,
                                           route="simt"), want):
        assert torch.equal(x, y)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_attention_bwd):
        with pytest.raises(ValueError, match="takes 'f32'"):
            fn(*args, causal=True, route="tc")
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    bargs = (*bf, None, lse, delta, g.to(torch.bfloat16))
    fa.flash_bwd_dq(*bargs, route="tc")
    fa.flash_bwd_dkv(*bargs, route="simt")
    with pytest.raises(ValueError, match="route 'cuda'"):
        fa.flash_bwd_dq(*bargs, route="cuda")


def test_named_route_f32_only_where_the_rule_sends_it():
    """``route="f32"`` is taken for aligned fp32 at D 64 or 128 and raises,
    on the CPU too, for bf16 (the rule says tc), D = 32 and a misaligned
    fp32 view (simt); ``route="simt"`` is taken for each of them."""
    rs = np.random.RandomState(1)

    def case(d, dtype=torch.float32, t=6):
        q, k, v, g = (torch.from_numpy(rs.randn(1, 2, t, d).astype(
            np.float32)).to(dtype) for _ in range(4))
        return (q, k, v, None, torch.zeros(1, 2, t), torch.zeros(1, 2, t), g)

    args = case(64)
    want = fa.flash_attention_bwd_reference(*args, causal=True)
    for route in ("f32", "simt", None):
        for x, y in zip(fa.flash_attention_bwd(*args, causal=True,
                                               route=route), want):
            assert torch.equal(x, y)
    fa.flash_bwd_dkv(*case(128), route="f32")
    odd = list(case(64))
    odd[1] = torch.zeros(1, 2, 6, 66)[..., :64]
    for bad, rule in ((case(64, torch.bfloat16), "tc"), (case(32), "simt"),
                      (tuple(odd), "simt")):
        for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            with pytest.raises(ValueError, match=f"takes '{rule}'"):
                fn(*bad, route="f32")
            fn(*bad, route="simt")


# ---------------------------------------------------------------------------
# the tensor-core kernels' tile plan, mirrored
# ---------------------------------------------------------------------------
def _mask(tq, tk, causal, cache_offset, klen):
    """``make_mask``: (kmax, diag)."""
    klen = tk if klen is None else klen
    return min(tk, klen), (klen - tq if cache_offset else tk - tq)


def _full(q0, k0, tq, kmax, diag, causal):
    """``Mask::full``: every pair of the 64 x 64 tile is attended."""
    return q0 + TILE <= tq and k0 + TILE <= kmax and \
        (not causal or k0 + TILE - 1 <= q0 + diag)


def dq_plan(tq, tk, causal, cache_offset=False, klen=None):
    """{query tile start: [(key tile start, full)]} of the dq kernel."""
    kmax, diag = _mask(tq, tk, causal, cache_offset, klen)
    plan = {}
    for q0 in range(0, tq, TILE):
        kend = kmax
        if causal:
            kend = min(kend, min(q0 + TILE, tq) - 1 + diag + 1)
        n = -(-kend // TILE) if kend > 0 else 0
        plan[q0] = [(j * TILE, _full(q0, j * TILE, tq, kmax, diag, causal))
                    for j in range(n)]
    return plan


def dkv_plan(tq, tk, causal, cache_offset=False, klen=None):
    """{key tile start: [(query tile start, full)]} of the dk/dv kernel."""
    kmax, diag = _mask(tq, tk, causal, cache_offset, klen)
    plan = {}
    for j0 in range(0, tk, TILE):
        ib = 0
        if causal:
            first = j0 - diag
            # C's integer division of a positive int: floor
            ib = (first // TILE) * TILE if first > 0 else 0
        i_end = tq if j0 < kmax else 0
        n = -(-(i_end - ib) // TILE) if i_end > ib else 0
        plan[j0] = [(ib + i * TILE,
                     _full(ib + i * TILE, j0, tq, kmax, diag, causal))
                    for i in range(n)]
    return plan


def _check_plan(b, tq, tk, causal, cache_offset, lengths):
    q = torch.zeros(b, 1, tq, 1)
    k = torch.zeros(b, 1, tk, 1)
    lens = None if lengths is None else torch.tensor(lengths)
    valid = fa._valid(q, k, lens, causal, cache_offset)
    valid = valid.expand(b, 1, tq, tk)[:, 0].numpy()
    for bi in range(b):
        klen = None if lengths is None else int(lengths[bi])
        v = valid[bi]
        for plan, rows_are_queries in (
                (dq_plan(tq, tk, causal, cache_offset, klen), True),
                (dkv_plan(tq, tk, causal, cache_offset, klen), False)):
            seen = np.zeros_like(v)
            for r0, tiles in plan.items():
                for c0, full in tiles:
                    q0, k0 = (r0, c0) if rows_are_queries else (c0, r0)
                    # a visited tile lies in the grid: its rows start in it
                    assert 0 <= q0 < max(tq, 1) + TILE and 0 <= k0 < tk
                    block = v[q0:q0 + TILE, k0:k0 + TILE]
                    if full:              # no mask: all pairs attended
                        assert block.shape == (TILE, TILE) and block.all(), \
                            (bi, q0, k0)
                    seen[q0:q0 + TILE, k0:k0 + TILE] = True
                # no tile visited twice by one block
                assert len({c for c, _ in tiles}) == len(tiles)
            # every attended pair visited; what is skipped holds none
            assert not (v & ~seen).any(), (bi, rows_are_queries)


# the kernel phase's backward cases (chip_smoke.BWD_CASES), the card
# tests' CASES and a few seeded random shapes
def _cases():
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_for_plan")
    kt = _load(ROOT / "tests" / "test_torch_flash_kernel.py",
               "flash_kernel_cases_for_plan")
    # a case's lengths named "bert" are drawn from the script's seed
    out = [(c[0], c[1], c[2], c[3], c[5], c[6],
            [int(x) for x in cs.bert_lengths(0, c[1], c[3])]
            if isinstance(c[7], str) else c[7]) for c in cs.BWD_CASES]
    out += [(c[0], c[1], c[3], c[4], c[6], c[7], c[8]) for c in kt.CASES]
    rs = np.random.RandomState(7)
    for i in range(12):
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


CASES = _cases()


def test_plan_cases_cover_the_kernel_phase_and_card_cases():
    names = {c[0] for c in CASES}
    assert {"train_causal_B8_T256", "causal_D128_B2_T512",
            "tq_gt_tk_causal_B2_T256x64", "decode_S8_Tk512",
            "masked_rows"} <= names
    assert len(CASES) >= 5 + 8 + 12


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_plan_covers_every_pair_and_masks_where_it_must(case):
    _, b, tq, tk, causal, cache_offset, lengths = case
    _check_plan(b, tq, tk, causal, cache_offset, lengths)


def test_causal_plan_puts_the_heaviest_blocks_first():
    """The grids launch dq's last query tiles and dk/dv's first key tiles
    first: those walk the most tiles under a causal mask."""
    dq = dq_plan(256, 256, True)
    dkv = dkv_plan(256, 256, True)
    launch_dq = [dq[q0] for q0 in sorted(dq, reverse=True)]
    launch_dkv = [dkv[j0] for j0 in sorted(dkv)]
    assert [len(t) for t in launch_dq] == [4, 3, 2, 1]
    assert [len(t) for t in launch_dkv] == [4, 3, 2, 1]
    # at the training shape only the diagonal tiles take the mask
    assert sum(not f for t in dq.values() for _, f in t) == 4
    assert sum(not f for t in dkv.values() for _, f in t) == 4


def test_plan_of_empty_rows_and_keys():
    """A length-0 entry and Tq > Tk causal: no tile is walked where no
    pair is attended, so the kernels write 0 there."""
    assert all(not t for t in dkv_plan(19, 56, False, klen=0).values())
    assert all(not t for t in dq_plan(19, 56, False, klen=0).values())
    dq = dq_plan(256, 64, True)                # rows < 192 see no key
    assert dq[0] == dq[64] == dq[128] == [] and len(dq[192]) == 1


# ---------------------------------------------------------------------------
# the accumulator-to-A fragment map
# ---------------------------------------------------------------------------
def _acc_pos(warp, lane, i):
    """Row and column of accumulator element d[i] of an m64 wgmma."""
    j, h, c = i // 4, (i // 2) % 2, i % 2
    return 16 * warp + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + c


def _a_pos(warp, lane, s, reg, half):
    """Row and column of the bf16 `half` of register `reg` of wgmma's
    register A fragment of k-step s (PTX's m64k16 A layout)."""
    row = 16 * warp + lane // 4 + 8 * (reg % 2)
    col = 16 * s + 2 * (lane % 4) + half + 8 * (reg // 2)
    return row, col


def test_accumulator_to_a_fragment_map_covers_a_tile_once():
    """pack_a<S> takes (d[8S + 2q], d[8S + 2q + 1]) into register q: each
    such pair sits where A's fragment wants it, and the 4 k-steps of 128
    threads cover the 64 x 64 tile exactly once."""
    hits = np.zeros((64, 64), dtype=int)
    for warp in range(4):
        for lane in range(32):
            for s in range(4):
                for reg in range(4):
                    for half in range(2):
                        i = 8 * s + 2 * reg + half
                        pos = _acc_pos(warp, lane, i)
                        assert pos == _a_pos(warp, lane, s, reg, half)
                        hits[pos] += 1
    assert (hits == 1).all()


# ---------------------------------------------------------------------------
# the fp32 kernels' swizzled tiles and register micro-tiles, mirrored
# ---------------------------------------------------------------------------
BOX = TILE * 128                  # bytes of a box: 64 rows of 32 floats
THREADS = 256


def _row_key(r):
    return r * 128 + ((r & 7) << 4)


def _chunk_off(key, c):
    """``chunk_off``: byte offset of the 16-byte chunk c of the row whose
    swizzle key is ``key``."""
    return (key ^ ((c & 7) << 4)) + (c >> 3) * BOX


def _threads():
    """Per thread (256): wc, lx, the A rows ra + 4i and B rows rb + 8j of
    its micro-tile (``flash_bwd_f32.cu``)."""
    tid = np.arange(THREADS)
    warp, lane = tid >> 5, tid & 31
    wr, wc, ly, lx = warp >> 1, warp & 1, lane >> 3, lane & 7
    ra = (16 * wr + ly)[:, None] + 4 * np.arange(4)
    rb = (32 * wc + lx)[:, None] + 8 * np.arange(4)
    return wc, lx, ra, rb


def _load_tile(x, r0, limit, d):
    """A stage's tile (``tma_tile``): rows [r0, r0 + 64) of x (T, d) into
    a swizzled tile (flat float32 words), rows at or past ``limit`` zero; a
    word no chunk covers stays NaN."""
    tile = np.full(TILE * d, np.nan, np.float32)
    r = np.arange(TILE)[:, None]
    c = np.arange(d // 4)[None, :]
    words = (_chunk_off(_row_key(r), c) // 4)[..., None] + np.arange(4)
    rows = np.zeros((TILE, d), np.float32)
    n = max(0, min(limit, x.shape[0]) - r0)
    rows[:min(n, TILE)] = x[r0:r0 + min(n, TILE)]
    tile[words] = rows.reshape(TILE, d // 4, 4)
    assert not np.isnan(tile).any()
    return tile


def _gather_rows(tile, rows, d):
    """The values a thread reads of ``rows`` (threads, n) chunk by chunk
    through ``ld4(tile, chunk_off(row_key(row), c))``: (threads, n, d)."""
    c = np.arange(d // 4)
    off = _chunk_off(_row_key(rows)[..., None], c) // 4
    return tile[off[..., None] + np.arange(4)].reshape(*rows.shape, d)


def _gather_b(tile, wc, lx, d):
    """The B operand a thread reads in ``products``: row t of the tile at
    the byte offset t * 128 + ((lx ^ t % 8) << 4) + box0 + u boxes, u <
    d / 64, box0 = (d / 64) * wc boxes: (threads, 64, d / 16)."""
    t = np.arange(TILE)[None, :, None]
    u = np.arange(d // 64)[None, None, :]
    off = (t * 128 + ((lx[:, None, None] ^ (t & 7)) << 4)
           + ((d // 64) * wc[:, None, None] + u) * BOX) // 4
    return tile[off[..., None] + np.arange(4)].reshape(THREADS, TILE,
                                                      d // 16)


def _store_scores(x, ra, rb):
    """``st1`` of every thread's 4 x 4 micro-tile into a swizzled 64 x 64
    tile; each word is written exactly once."""
    tile = np.full(TILE * TILE, np.nan, np.float32)
    col = np.broadcast_to(rb[:, None, :], x.shape)
    row = np.broadcast_to(ra[:, :, None], x.shape)
    word = (_chunk_off(_row_key(row), col >> 2) + (col & 3) * 4) // 4
    assert np.unique(word).size == word.size == tile.size
    tile[word] = x
    return tile


def _store_rows(out, acc, r0, ra, wc, lx, d):
    """``store_rows``: acc (threads, 4, d / 16) to rows r0 + ra of out;
    chunk u of a thread lands at column 4 * (cb + 8u), cb = (d / 8) * wc +
    lx; each element of the tile's rows is written exactly once."""
    cb = (d // 8) * wc + lx
    cols = 4 * (cb[:, None] + 8 * np.arange(d // 64))[:, :, None] \
        + np.arange(4)                               # (threads, u, 4)
    rows = np.broadcast_to(r0 + ra[:, :, None, None], (THREADS, 4,
                                                       d // 64, 4))
    cols = np.broadcast_to(cols[:, None], rows.shape)
    vals = acc.reshape(THREADS, 4, d // 64, 4)
    flat = rows * d + cols
    assert np.unique(flat).size == flat.size == TILE * d
    keep = rows < out.shape[0]
    out[rows[keep], cols[keep]] = vals[keep]


def _lse_log2(l):
    with np.errstate(invalid="ignore"):
        return np.where(np.isfinite(l), l * np.log2(np.e), np.inf)


def _ok(query, key, tq, kmax, diag, causal):
    return (query < tq) & (key < kmax) & \
        ((not causal) | (key <= query + diag))


def _emulate(q, k, v, g, lse, delta, lengths, causal, cache_offset):
    """Both fp32 kernels, block by block and thread by thread, on numpy
    copies of one call's (B, H, T, D) inputs: (dq, dk, dv). TMA zero-fills
    every tile's rows past its sequence's end (Tq or Tk)."""
    b_, h_, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / np.sqrt(d)
    sl2 = np.float32(scale * np.log2(np.e))
    wc, lx, ra, rb = _threads()
    dq = np.full(q.shape, np.nan, np.float32)
    dk = np.full(k.shape, np.nan, np.float32)
    dv = np.full(k.shape, np.nan, np.float32)
    with np.errstate(over="ignore"):
        for b in range(b_):
            klen = None if lengths is None else int(lengths[b])
            kmax, diag = _mask(tq, tk, causal, cache_offset, klen)
            for h in range(h_):
                qb, kb, vb, gb = q[b, h], k[b, h], v[b, h], g[b, h]
                lb = np.concatenate([lse[b, h], np.zeros(TILE)])
                db = np.concatenate([delta[b, h], np.zeros(TILE)])
                # K5: one block per 64 queries
                for q0, tiles in dq_plan(tq, tk, causal, cache_offset,
                                         klen).items():
                    qa = _gather_rows(_load_tile(qb, q0, tq, d), ra, d)
                    ga = _gather_rows(_load_tile(gb, q0, tq, d), ra, d)
                    rows = q0 + ra
                    l2 = np.where(rows < tq, _lse_log2(lb[rows]), np.inf)
                    dl = np.where(rows < tq, db[rows], 0.0)
                    acc = np.zeros((THREADS, 4, d // 16))
                    for j0, full in tiles:
                        kt = _load_tile(kb, j0, tk, d)
                        vt = _load_tile(vb, j0, tk, d)
                        s = np.einsum("tid,tjd->tij", qa,
                                      _gather_rows(kt, rb, d))
                        dp = np.einsum("tid,tjd->tij", ga,
                                       _gather_rows(vt, rb, d))
                        p = np.exp2(s * sl2 - l2[:, :, None])
                        if not full:
                            p = np.where(_ok(rows[:, :, None],
                                             j0 + rb[:, None, :], tq, kmax,
                                             diag, causal), p, 0.0)
                        ds = p * (dp - dl[:, :, None]) * scale
                        dss = _store_scores(ds, ra, rb)
                        acc += _gather_rows(dss, ra, TILE) @ \
                            _gather_b(kt, wc, lx, d)
                    _store_rows(dq[b, h, q0:], acc, 0, ra, wc, lx, d)
                # K6: one block per 64 keys
                for j0, tiles in dkv_plan(tq, tk, causal, cache_offset,
                                          klen).items():
                    ka = _gather_rows(_load_tile(kb, j0, tk, d), ra, d)
                    va = _gather_rows(_load_tile(vb, j0, tk, d), ra, d)
                    dka = np.zeros((THREADS, 4, d // 16))
                    dva = np.zeros((THREADS, 4, d // 16))
                    for i0, full in tiles:
                        qt = _load_tile(qb, i0, tq, d)
                        gt = _load_tile(gb, i0, tq, d)
                        cols = i0 + rb          # the thread's queries
                        st_l = np.where(cols < tq, lb[cols], 0.0)
                        st_d = np.where(cols < tq, db[cols], 0.0)
                        s = np.einsum("tid,tjd->tij", ka,
                                      _gather_rows(qt, rb, d))
                        dp = np.einsum("tid,tjd->tij", va,
                                       _gather_rows(gt, rb, d))
                        p = np.exp2(s * sl2 - _lse_log2(st_l)[:, None, :])
                        if not full:
                            p = np.where(_ok(cols[:, None, :],
                                             j0 + ra[:, :, None], tq, kmax,
                                             diag, causal), p, 0.0)
                        ds = p * (dp - st_d[:, None, :]) * scale
                        pts = _store_scores(p, ra, rb)
                        dts = _store_scores(ds, ra, rb)
                        dva += _gather_rows(pts, ra, TILE) @ \
                            _gather_b(gt, wc, lx, d)
                        dka += _gather_rows(dts, ra, TILE) @ \
                            _gather_b(qt, wc, lx, d)
                    _store_rows(dk[b, h, j0:], dka, 0, ra, wc, lx, d)
                    _store_rows(dv[b, h, j0:], dva, 0, ra, wc, lx, d)
    return dq, dk, dv


# (name, b, tq, tk, d, causal, cache_offset, lengths)
F32_CASES = [
    ("causal_T130_D64", 1, 130, 130, 64, True, False, None),
    ("lengths_zero_T70x100_D64", 3, 70, 100, 64, False, False, [100, 33, 0]),
    ("cache_offset_T5x140_D128", 2, 5, 140, 128, True, True, [140, 70]),
    ("tq_gt_tk_causal_T150x40_D64", 1, 150, 40, 64, True, False, None),
    ("causal_T64_D128", 1, 64, 64, 128, True, False, None),
    ("noncausal_T100x200_D128", 1, 100, 200, 128, False, False, None),
    ("causal_lengths_T96_D128", 2, 96, 96, 128, True, False, [96, 40]),
    ("decode_cache_offset_T1x130_D64", 2, 1, 130, 64, True, True, [130, 1]),
    ("causal_T256_D64", 1, 256, 256, 64, True, False, None),
    ("causal_lengths_tq_lt_tk_T40x150_D64", 2, 40, 150, 64, True, False,
     [150, 65]),
]


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_f32_kernels_mirrored_match_the_plain_version(case):
    """Every thread's micro-tile, the swizzled loads and stores, the
    uniform masked/unmasked branch, lse_log2 and the row statistics as the
    kernels read them: the mirror's dq, dk, dv equal the plain version's
    within 1e-5 of max|plain| (fp64 sums here), every output element is
    written once, rows and keys no pair reaches are exactly 0."""
    _, b, tq, tk, d, causal, cache_offset, lengths = case
    rs = np.random.RandomState(3)
    q, g = (rs.randn(b, 2, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, 2, tk, d).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    lens = None if lengths is None else torch.tensor(lengths)
    kw = dict(causal=causal, cache_offset=cache_offset)
    out, lse = fa.flash_attention_reference(*t[:3], lens, return_lse=True,
                                            **kw)
    delta = (t[3] * out).sum(-1)
    want = fa.flash_attention_bwd_reference(*t[:3], lens, lse, delta, t[3],
                                            **kw)
    got = _emulate(q, k, v, g, lse.numpy(), delta.numpy(), lengths, causal,
                   cache_offset)
    valid = fa._valid(t[0], t[1], lens, causal, cache_offset)
    valid = valid.expand(b, 1, tq, tk).numpy()
    dead_rows, dead_keys = ~valid.any(3), ~valid.any(2)
    for name, x, y, dead in zip(("dq", "dk", "dv"), got, want,
                                (dead_rows, dead_keys, dead_keys)):
        y = y.numpy()
        assert not np.isnan(x).any(), name
        tol = 1e-5 * max(1.0, np.abs(y).max())
        assert np.abs(x - y).max() <= tol, (name, np.abs(x - y).max())
        assert (x[np.broadcast_to(dead[..., None], x.shape)] == 0).all()


def _wavefronts(offsets):
    """Shared-memory wavefronts of one warp's 16-byte loads at byte
    ``offsets`` (32): distinct chunks grouped by the 128-byte bank row
    they fall on; the most chunks sharing one bank quad."""
    chunks = np.unique(np.asarray(offsets) // 16)
    return np.bincount(chunks % 8).max()


@pytest.mark.parametrize("d", [64, 128])
def test_f32_micro_tile_loads_are_one_wavefront(d):
    """Each float4 load of a warp (the A rows and B rows of ``scores``, the
    A rows and B chunks of ``products``) touches distinct bank quads, so it
    is one wavefront, broadcast over the lanes that share an address; the
    4 x 8 lanes read 4 and 8 distinct chunks."""
    wc, lx, ra, rb = _threads()
    for w in range(8):
        lanes = slice(32 * w, 32 * w + 32)
        for c in range(d // 4):
            for rows in (ra, rb):
                for i in range(4):
                    off = _chunk_off(_row_key(rows[lanes, i]), c)
                    assert _wavefronts(off) == 1
            assert np.unique(_chunk_off(_row_key(ra[lanes, 0]), c)).size \
                == 4
            assert np.unique(_chunk_off(_row_key(rb[lanes, 0]), c)).size \
                == 8
        for t in range(TILE):
            for u in range(d // 64):
                off = t * 128 + ((lx[lanes] ^ (t & 7)) << 4) \
                    + ((d // 64) * wc[lanes] + u) * BOX
                assert _wavefronts(off) == 1 and np.unique(off).size == 8


def _step4(r0, i, c):
    """``RowOffs::step4``: chunk c of row r0 + 4i from row r0's offsets."""
    x = r0 * 128 + (((r0 & 7) ^ (c & 7)) << 4)
    flip = (-64 if c & 4 else 64) if i & 1 else 0
    return x + 512 * i + flip + (c >> 3) * BOX


def _step8(r0, j, c):
    """``RowOffs::step8``: chunk c of row r0 + 8j."""
    return r0 * 128 + (((r0 & 7) ^ (c & 7)) << 4) + 1024 * j \
        + (c >> 3) * BOX


def test_f32_row_offsets_equal_the_swizzle():
    """The kernels' immediate-offset forms of a thread's rows (``RowOffs``
    for rows ra + 4i and rb + 8j, and ``products``' B rows at t * 128 +
    xl[t % 8]) land on the same bytes as ``chunk_off(row_key(r), c)``, at
    every chunk of a 128-wide tile."""
    wc, lx, ra, rb = _threads()
    for c in range(32):
        for i in range(4):
            assert (_step4(ra[:, 0], i, c) ==
                    _chunk_off(_row_key(ra[:, i]), c)).all()
            assert (_step8(rb[:, 0], i, c) ==
                    _chunk_off(_row_key(rb[:, i]), c)).all()
    for d in (64, 128):
        for t in range(TILE):
            for u in range(d // 64):
                xl = ((lx ^ (t & 7)) << 4) + (d // 64) * wc * BOX
                cb = (d // 8) * wc + lx + 8 * u
                assert (t * 128 + xl + u * BOX ==
                        _chunk_off(_row_key(t), cb)).all()
