"""The flash backward's route rule and the tensor-core kernels' plan, on
the CPU (no card, no nvcc).

``flash_attention.flash_bwd_route`` sends a backward call to the bf16
tensor-core kernels of ``csrc/flash_bwd_tc.cu`` or to the SIMT kernels of
``csrc/flash_bwd.cu``; it reads only dtypes, shapes, strides and
addresses, so it runs here on CPU tensors. The tile plan below mirrors
the tensor-core kernels' loops (``dq_tiles``, ``dkv_tiles`` and
``Mask::full`` in ``csrc/flash_bwd_tc.cu``) and is held against the dense
mask of the plain version (``flash_attention._valid``): every attended
pair is visited by both kernels, no tile a kernel skips holds one, and
no tile that skips the mask holds a pair that is not attended. The
accumulator-to-A fragment map of ``hopper.cuh`` (``pack_a``) covers a
64 x 64 tile exactly once.
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
    if case == "row_stride":             # rows of 65 bf16: not 16-byte units
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


def test_dims_of_size_one_have_no_stride_to_hold_to():
    """Tq = 1 (a decode-sized backward) and B = H = 1: whatever strides
    those dims carry, the operands stay on the tensor cores."""
    base = torch.zeros(1, 1, 3, 64, dtype=torch.bfloat16)
    q = base[:, :, :1].as_strided((1, 1, 1, 64), (7, 5, 3, 1))
    k = v = torch.zeros(1, 1, 9, 64, dtype=torch.bfloat16)
    assert fa.flash_bwd_route(q, k, v, q) == "tc"


def test_named_routes_simt_anywhere_tc_only_where_the_rule_sends_it():
    """``route="simt"`` is taken for any call (bf16 timed on the SIMT
    kernels), ``route="tc"`` raises where the rule says simt; on the CPU
    the plain version runs either way."""
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
        with pytest.raises(ValueError, match="takes 'simt'"):
            fn(*args, causal=True, route="tc")
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    bargs = (*bf, None, lse, delta, g.to(torch.bfloat16))
    fa.flash_bwd_dq(*bargs, route="tc")
    fa.flash_bwd_dkv(*bargs, route="simt")
    with pytest.raises(ValueError, match="route 'cuda'"):
        fa.flash_bwd_dq(*bargs, route="cuda")


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
    out = [(c[0], c[1], c[2], c[3], c[5], c[6], c[7]) for c in cs.BWD_CASES]
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
