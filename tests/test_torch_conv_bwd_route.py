"""Which kernels a fused conv takes on the card, and the grid and scratch
each route sizes, checked on the CPU.

``fused_conv.conv_route`` sends bf16 with both widths multiples of 8 to
the tensor-core K1/K2/K3 (``csrc/fused_conv_tc.cu``,
``csrc/conv_bwd_tc.cu``), fp32 with both widths multiples of 4 to the
register micro-tile kernels of ``csrc/fused_conv_f32.cu`` and
``csrc/conv_bwd_f32.cu`` (``"f32"``), and everything else to the SIMT
kernels (``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``). The f32 K1, K2
and K3 are mirrored here block by block in numpy (their pixel boxes,
TMA's zero fill, the fold or the prologue and its zeroing, the micro-tile
product, the epilogue, the ranges and the ordered sums) against the plain
versions, their boxes are held to cover every pixel once at every
``chip_smoke.CONV_CASES`` shape and all 52 of ResNet-50, K3's ranges to
fill the card with whole boxes, and their shared loads and stores to
their fewest wavefronts.
The rule, the pixel boxes of the tensor-core kernels, their column blocks,
their splits of K and their scratch are plain Python, so they are held
here at all 52 conv shapes of ResNet-50; the kernels themselves run in
``tests/test_torch_fused_conv_kernel.py`` on the card. This file imports
nothing of JAX.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import fused_conv as fc

SMS = 132  # streaming multiprocessors of an H100


@pytest.fixture(scope="module")
def resnet50_convs():
    """(h, w, ci, co, k, stride, pad) of the 52 fused convs of
    ``fused_resnet50_v1`` at 224x224 (the stem's output is 56x56), read
    off the model's own bottlenecks."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedBottleneckV1, fused_resnet50_v1)

    net = fused_resnet50_v1()
    convs, h = [], 56
    for blk in net.modules():
        if not isinstance(blk, FusedBottleneckV1):
            continue
        s = blk._stride
        w1, w2, w3 = (tuple(getattr(blk, f"conv{i}_weight").shape)
                      for i in (1, 2, 3))
        convs += [(h, h, w1[2], w1[3], 1, 1, 0),
                  (h, h, w2[2], w2[3], 3, s, 1),
                  (h // s, h // s, w3[2], w3[3], 1, 1, 0)]
        if blk.bnd is not None:
            wd = tuple(blk.convd_weight.shape)
            convs.append((h, h, wd[2], wd[3], 1, s, 0))
        h //= s
    assert len(convs) == 52
    return convs


def _out(h, k, stride, pad):
    return (h + 2 * pad - k) // stride + 1


def test_fp32_takes_the_simt_kernels_at_every_width():
    """fp32 takes the SIMT K1, K2 and K3 at every width that is no whole
    number of 16-byte rows (Ci or Co not a multiple of 4), and the f32
    kernels at every other width (with aligned operands, below)."""
    for ci in (3, 8, 20, 24, 64, 2048, 6, 66):
        for co in (8, 40, 64, 1000, 10, 1001):
            want = "f32" if ci % 4 == 0 and co % 4 == 0 else "simt"
            assert fc.conv_route(torch.float32, ci, co) == want
            for kernel in ("fused_conv", "conv_bwd_dx", "conv_bwd_dw"):
                assert fc.conv_route(torch.float32, ci, co, kernel) == want


@pytest.mark.parametrize("ci, co", [(20, 72), (64, 12), (7, 8), (8, 100)])
def test_ragged_bf16_widths_take_the_simt_kernels(ci, co):
    """A width that is no whole number of 16-byte rows cannot be a TMA
    tensor: SIMT, as in ``test_torch_fused_conv_kernel``'s
    ``3x3_pro_ragged`` (Ci=20)."""
    assert fc.conv_route(torch.bfloat16, ci, co) == "simt"


def test_bf16_resnet50_convs_take_the_tensor_cores(resnet50_convs):
    for _, _, ci, co, *_ in resnet50_convs:
        assert fc.conv_route(torch.bfloat16, ci, co) == "tc"
        assert fc.conv_route(torch.float32, ci, co) == "f32"
    # chip_smoke's off-path 5x5 case (widths 24 and 40) too
    assert fc.conv_route(torch.bfloat16, 24, 40) == "tc"


def test_a_named_route_is_checked_against_the_rule():
    """``route="simt"`` takes any call (chip_smoke times the SIMT kernels in
    bf16 with it); ``"tc"`` only what the rule sends there (fp32 with
    16-byte rows: ``"f32"``); the check
    runs before the CPU's plain version, for the forward as for the
    backward."""
    x = torch.zeros(1, 4, 4, 20)
    w = torch.zeros(1, 1, 20, 8)
    y = dy = torch.zeros(1, 4, 4, 8)
    ds = dss = torch.zeros(8)
    fc.fused_conv(x, w, relu=False, route="simt")
    with pytest.raises(ValueError, match="takes 'f32'"):
        fc.fused_conv(x, w, relu=False, route="tc")
    with pytest.raises(ValueError, match="route 'fast'"):
        fc.fused_conv(x.bfloat16(), w.bfloat16(), relu=False, route="fast")
    for t, rule in ((fc.conv_bwd_dx, "f32"), (fc.conv_bwd_dw, "f32")):
        t(x, w, None, None, y, dy, ds, dss, relu=False, route="simt")
        with pytest.raises(ValueError, match=f"takes '{rule}'"):
            t(x, w, None, None, y, dy, ds, dss, relu=False, route="tc")
        with pytest.raises(ValueError, match="route 'fast'"):
            t(x.bfloat16(), w.bfloat16(), None, None, y.bfloat16(),
              dy.bfloat16(), ds, dss, relu=False, route="fast")


def test_cpu_bf16_takes_the_plain_versions_and_counts_no_launch():
    counters = ("conv_bwd_dx_launches", "conv_bwd_dw_launches",
                "conv_bwd_dx_tc_launches", "conv_bwd_dw_tc_launches",
                "conv_bwd_dx_simt_launches", "conv_bwd_dw_simt_launches",
                "fused_conv_launches", "fused_conv_tc_launches",
                "fused_conv_simt_launches")
    before = [getattr(fc, c) for c in counters]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 6, 6, 16, generator=g).bfloat16()
    w = torch.randn(3, 3, 16, 8, generator=g).bfloat16()
    y, _, _ = fc.fused_conv_reference(x, w, stride=1, pad=1)
    dy = torch.randn(y.shape, generator=g).bfloat16()
    ds, dss = torch.zeros(8), torch.zeros(8)
    got = fc.conv_bwd_dw(x, w, None, None, y, dy, ds, dss, 1, 1, False)
    want = fc.conv_bwd_dw_reference(x, w, None, None, y, dy, ds, dss, 1, 1,
                                    False)
    assert torch.equal(got, want)
    for g, r in zip(fc.fused_conv(x, w, stride=1, pad=1),
                    fc.fused_conv_reference(x, w, stride=1, pad=1)):
        assert torch.equal(g, r)
    assert [getattr(fc, c) for c in counters] == before


@pytest.mark.parametrize("kw, stride, wo, res, want", [
    (3, 1, 56, False, 3),    # a row of taps shares one box of x
    (3, 1, 62, False, 3),    # 62 + 2 columns: the widest that fits 64
    (3, 1, 63, False, 1),
    (3, 2, 28, False, 1),    # stride 2: the taps' pixels do not overlap
    (3, 1, 14, True, 1),     # a residual: one tap per block
    (1, 1, 56, False, 1),
    (5, 1, 15, False, 1),
])
def test_weight_gradient_takes_a_row_of_taps_where_one_box_serves_it(
        kw, stride, wo, res, want):
    assert fc.dw_tc_taps(kw, stride, wo, res) == want
    if want == 3:
        bw, bh, bn = fc.dw_tc_box(4, 9, wo, kw, 3)
        assert bw == wo + 2 and bw * bh <= 64 and bn == 1
    # the input gradient: the same rule on the input's width, any residual
    # (it joins in the epilogue, not in the product)
    assert fc.dx_tc_taps(kw, stride, wo) == (want if not res else 3)
    if fc.dx_tc_taps(kw, stride, wo) == 3:
        bw, bh, bn = fc.dx_tc_box(4, 9, wo, kw, stride, 3)
        assert bw == wo + 2 and bw * bh <= 64 and bn == 1
        assert fc.dx_tc_cols(4, 9, wo, 512, stride, 3) == 64


@pytest.mark.parametrize("n, h, w, want", [
    (32, 56, 56, (56, 1, 1)),    # one row of the width
    (32, 28, 28, (28, 2, 1)),
    (32, 14, 14, (14, 4, 1)),
    (32, 7, 7, (7, 7, 1)),       # one whole image
    (4, 3, 5, (5, 3, 4)),        # whole images
    (2, 9, 100, (64, 1, 1)),     # wider than a block: part of a row
])
def test_tensor_core_box_is_whole_rows_then_whole_images(n, h, w, want):
    bw, bh, bn = fc.tc_box(n, h, w)
    assert (bw, bh, bn) == want and bw * bh * bn <= 64


@pytest.mark.parametrize("batch", [8, 32, 128])
def test_tensor_core_grids_fill_the_card_with_whole_steps(resnet50_convs,
                                                          batch):
    """At every ResNet-50 shape: K3's splits are whole boxes, none empty,
    at least 4 boxes each where there are that many, and its grid fills
    the 132 SMs without a second short wave of its two blocks per SM
    (when the tiles allow); K2's grid fills the card and takes 128 input
    channels a block only where that still leaves 264 blocks."""
    for h, w, ci, co, k, s, p in resnet50_convs:
        ho, wo = _out(h, k, s, p), _out(w, k, s, p)
        taps = fc.dw_tc_taps(k, s, wo, False)
        assert taps == (3 if k == 3 and s == 1 else 1)
        tiles = k * (k // taps) * -(-ci // 64) * -(-co // 64)
        boxes = fc._boxes(batch, ho, wo, fc.dw_tc_box(batch, ho, wo, k, taps))
        splits = fc.dw_splits(batch, ho, wo, ci, co, k, k, "tc", taps)
        per = -(-boxes // splits)
        assert 1 <= splits <= boxes and (splits - 1) * per < boxes
        assert per >= min(4, boxes)
        blocks = tiles * splits
        if tiles <= 264:
            assert blocks <= 264
        if batch >= 32:
            assert blocks >= SMS, (h, ci, co, k, s, blocks)
        dtaps = fc.dx_tc_taps(k, s, w)
        assert dtaps == (3 if k == 3 and s == 1 else 1)
        cols = fc.dx_tc_cols(batch, h, w, ci, s, dtaps)
        hq, wq = -(-h // s), -(-w // s)
        dx_boxes = s * s * fc._boxes(
            batch, hq, wq, fc.dx_tc_box(batch, h, w, k, s, dtaps))
        assert cols in (64, 128) and (cols == 64 or dtaps == 1)
        if cols == 128:
            assert ci > 64 and dx_boxes * -(-ci // 128) >= 264
        if batch >= 32:
            assert dx_boxes * -(-ci // cols) >= SMS


def test_tensor_core_scratch_holds_every_partial():
    """K2's partial sums: 3 planes of (stride^2 x boxes of the widest
    phase) rows of Ci; K3's: one fp32 dW plane per split (the sizes
    ``conv_bwd_dx``/``conv_bwd_dw`` allocate)."""
    n, h, w, ci, s = 32, 56, 56, 128, 2
    hq, wq = -(-h // s), -(-w // s)
    bw, bh, bn = fc.tc_box(n, hq, wq)
    rows = s * s * fc._boxes(n, hq, wq)
    assert (bw, bh, bn) == (28, 2, 1) and rows == 4 * 32 * 14
    # every block of every phase owns one row: the grid is boxes x phases
    assert rows == s * s * -(-wq // bw) * -(-hq // bh) * -(-n // bn)
    # K3 at 3x3 64->64 56x56, a tap per block: 9 tiles, 29 splits of 62
    # boxes (1792); a row of 3 taps per block: 3 tiles of 58-pixel boxes
    # (a 56-pixel output row and the 2 columns past it), 86 splits of 21
    assert fc.dw_splits(32, 56, 56, 64, 64, 3, 3, "tc") == 29
    assert fc._boxes(32, 56, 56) == 1792
    assert fc.dw_tc_box(32, 56, 56, 3, 3) == (58, 1, 1)
    assert fc.dw_splits(32, 56, 56, 64, 64, 3, 3, "tc", 3) == 86


def test_per_channel_operands_reach_the_kernels_16_byte_aligned():
    """The tensor-core kernels read a, b, ar, br, ds and dss 8 channels (32
    bytes) a load: ``_vec`` passes an aligned fp32 vector through as it is
    and copies a view that starts off a 16-byte boundary."""
    cpu = torch.device("cpu")
    v = torch.arange(16.0)
    assert fc._vec("a", v, 16, cpu) is v
    view = torch.arange(17.0)[1:]
    assert view.data_ptr() % 16 != 0
    got = fc._vec("a", view, 16, cpu)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    got = fc._vec("a", torch.arange(8, dtype=torch.float64), 8, cpu)
    assert got.dtype == torch.float32 and got.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match=r"must be \(8,\)"):
        fc._vec("a", v, 8, cpu)


# ---------------------------------------------------------------------------
# K1: the tensor-core forward's geometry
# ---------------------------------------------------------------------------
def _fwd_plan(n, h, w, ci, co, k, s, p, res=False):
    """(taps, box, cols, splits, boxes, steps) as ``fused_conv`` plans a
    tensor-core launch."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    taps = fc.dw_tc_taps(k, s, wo, res)
    box = fc.dw_tc_box(n, ho, wo, k, taps)
    cols = fc.fwd_tc_cols(co, taps)
    splits = fc.fwd_tc_splits(n, ho, wo, ci, co, k, k, taps, cols)
    steps = k * (k // taps) * -(-ci // 64)
    return taps, box, cols, splits, fc._boxes(n, ho, wo, box), steps


def test_forward_takes_bf16_resnet50_convs_to_the_tensor_cores(
        resnet50_convs):
    """K1 follows the same rule as K2/K3: every ResNet-50 conv in bf16 on
    the tensor cores, in fp32 on the f32 kernel; ragged bf16 on SIMT."""
    for _, _, ci, co, *_ in resnet50_convs:
        assert fc._pick_route(torch.bfloat16, ci, co, None) == "tc"
        assert fc._pick_route(torch.float32, ci, co, None) == "f32"
    assert fc._pick_route(torch.bfloat16, 20, 72, None) == "simt"


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 16, 32, 128])
def test_forward_grid_fills_the_card_with_whole_steps(resnet50_convs,
                                                      batch):
    """At every ResNet-50 shape: a row of 3 taps exactly at 3x3 stride 1
    (columns of 64 there), 128 output columns a block at every other
    shape wider than 64; boxes of at most 64 pixels; K cut into ranges of
    whole steps, none empty, at least 4 steps each, only at a deep K (32
    steps) on a grid that busies at most half the SMs (never at B=32 or
    128); and at
    B=32 and 128 one wave of blocks at least: a block on 95% of the SMs or
    more (the 7x7 convs with 128 columns at B=32 run 128 blocks, one per
    SM, on 132)."""
    for h, w, ci, co, k, s, p in resnet50_convs:
        taps, box, cols, splits, boxes, steps = _fwd_plan(
            batch, h, w, ci, co, k, s, p)
        assert taps == (3 if k == 3 and s == 1 else 1)
        assert cols == (64 if taps == 3 or co <= 64 else 128)
        bw, bh, bn = box
        assert bw * bh * bn <= 64
        blocks = boxes * -(-co // cols)
        per = -(-steps // splits)
        assert 1 <= splits <= steps and (splits - 1) * per < steps
        if splits > 1:
            assert per >= 4 and steps >= 32 and blocks <= SMS // 2
            assert blocks * splits <= 264
        if batch >= 32:
            assert splits == 1 and blocks >= 0.95 * SMS, \
                (h, ci, co, k, s, blocks)


@pytest.mark.parametrize("n, h, w, k, s, p", [
    (32, 56, 56, 3, 1, 1),       # 58-pixel boxes: one output row + 2
    (32, 28, 28, 3, 1, 1),       # 30 x 2
    (32, 14, 14, 3, 1, 1),       # 16 x 4
    (32, 7, 7, 3, 1, 1),         # 9 x 7
    (2, 9, 11, 3, 1, 1),         # 13 x 4, the last box of a image short
    (4, 56, 56, 3, 2, 1),        # stride 2: a tap a step, 28 x 2
    (3, 9, 11, 1, 2, 0),         # whole images: 6 x 5 x 2
])
def test_forward_boxes_cover_every_output_pixel_once(n, h, w, k, s, p):
    """The rows of every box, read as the kernel reads them (row r is
    column r % bw, row (r // bw) % bh, image r // (bw * bh) of the box),
    hold every output pixel exactly once; the widened columns of a row of
    taps (bw = Wo + 2) and the rows past the extent count as no pixel."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    taps, (bw, bh, bn), _, _, boxes, _ = _fwd_plan(n, h, w, 8, 8, k, s, p)
    tw, th = -(-wo // bw), -(-ho // bh)
    assert boxes == tw * th * -(-n // bn)
    seen, widened = [], 0
    for box in range(boxes):
        wo0, ho0 = (box % tw) * bw, ((box // tw) % th) * bh
        n0 = (box // (tw * th)) * bn
        for r in range(bw * bh * bn):
            j, i, m = r % bw, (r // bw) % bh, r // (bw * bh)
            if wo0 + j >= wo:
                widened += 1
                continue
            if ho0 + i < ho and n0 + m < n:
                seen.append((n0 + m, ho0 + i, wo0 + j))
    assert len(seen) == len(set(seen)) == n * ho * wo
    if taps == 3:
        assert bw == wo + 2 and widened >= 2 * n * ho


def test_forward_scratch_holds_every_partial():
    """K1's scratch, as ``fused_conv`` allocates it: the partial sums and
    sums of squares, one row of Co per box (the grid's first dimension);
    with a split, one fp32 plane of 64 rows by Co per box and range."""
    n, ci, co = 8, 2048, 512
    taps, box, cols, splits, boxes, steps = _fwd_plan(n, 7, 7, ci, co, 1, 1,
                                                      0, res=True)
    assert (taps, box, cols) == (1, (7, 7, 1), 128)
    assert (boxes, steps, splits) == (8, 32, 8)     # 32 blocks: split
    part = 2 * boxes * co
    part_y = splits * boxes * 64 * co
    # the last row the kernel writes: sum of squares, last box, last column
    assert (boxes + boxes - 1) * co + co - 1 == part - 1
    # the last plane element: last range, last box, row 63, last column
    assert (((splits - 1) * boxes + boxes - 1) * 64 + 63) * co + co - 1 \
        == part_y - 1
    # 3x3 512->512 at 7x7, B=8: a row of taps (9-pixel boxes, 63 rows),
    # 64 columns, 8 x 8 blocks, but 24 steps only: no split (it measured
    # no faster)
    assert _fwd_plan(8, 7, 7, 512, 512, 3, 1, 1)[:4] == (3, (9, 7, 1), 64, 1)
    # the same conv at B=32 fills the card (256 blocks): no split
    assert _fwd_plan(32, 7, 7, 512, 512, 3, 1, 1)[3] == 1


# ---------------------------------------------------------------------------
# the fp32 K2 on the FP32 pipes (csrc/conv_bwd_f32.cu)
# ---------------------------------------------------------------------------
def test_fp32_input_gradient_takes_the_f32_kernel_where_rows_are_16_bytes(
        resnet50_convs):
    """K2 in fp32 with Ci and Co multiples of 4 takes ``"f32"``, and K1
    and K3 with it at the same widths; ragged widths stay on SIMT, bf16 on
    the tensor cores: every ResNet-50 conv and chip_smoke's 5x5 case (24
    -> 40)."""
    for _, _, ci, co, *_ in resnet50_convs + [(0, 0, 24, 40)]:
        assert fc.conv_route(torch.float32, ci, co, "conv_bwd_dx") == "f32"
        assert fc.conv_route(torch.bfloat16, ci, co, "conv_bwd_dx") == "tc"
        assert fc.conv_route(torch.float32, ci, co, "fused_conv") == "f32"
        assert fc.conv_route(torch.float32, ci, co, "conv_bwd_dw") == "f32"
    for ci, co in ((20, 74), (6, 8), (3, 64), (64, 10)):
        assert fc.conv_route(torch.float32, ci, co, "conv_bwd_dx") == "simt"


def test_fp32_input_gradient_with_a_misaligned_operand_takes_simt():
    """The f32 rule holds every operand the kernel takes to a 16-byte base
    (the C entries refuse any other): a view 4 bytes into its buffer sends
    fp32 K2, and K1 and K3 alike, to SIMT, and a named ``"f32"`` route
    raises for it; aligned operands, or none given, keep ``"f32"``."""
    buf = torch.zeros(1 + 4 * 4 * 8)
    off = buf[1:].view(1, 4, 4, 8)
    assert off.data_ptr() % 16 == 4
    ok = torch.zeros(1, 4, 4, 8)
    for kernel in ("conv_bwd_dx", "fused_conv", "conv_bwd_dw"):
        assert fc.conv_route(torch.float32, 8, 8, kernel) == "f32"
        assert fc.conv_route(torch.float32, 8, 8, kernel,
                             (ok, None, ok)) == "f32"
        assert fc.conv_route(torch.float32, 8, 8, kernel,
                             (ok, None, off)) == "simt"
        assert fc._pick_route(torch.float32, 8, 8, None, kernel,
                              (off,)) == "simt"
        assert fc._pick_route(torch.float32, 8, 8, "simt", kernel,
                              (off,)) == "simt"
        with pytest.raises(ValueError,
                           match="16-byte boundary.*takes 'simt'"):
            fc._pick_route(torch.float32, 8, 8, "f32", kernel, (off,))


def test_a_named_f32_route_only_where_the_rule_sends_it():
    """``route="f32"`` takes fp32 K1, K2 and K3 calls with 16-byte rows
    (on the CPU the plain version runs either way), and raises for bf16
    and ragged widths; ``"simt"`` still takes every call."""
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 12)
    y = dy = torch.zeros(1, 4, 4, 12)
    ds = dss = torch.zeros(12)
    args = (x, w, None, None, y, dy, ds, dss, 1, 1, False)
    want = fc.conv_bwd_dx_reference(*args)
    for route in ("f32", "simt", None):
        assert torch.equal(fc.conv_bwd_dx(*args, route=route)[0], want[0])
    with pytest.raises(ValueError, match="takes 'f32'"):
        fc.conv_bwd_dx(*args, route="tc")
    want_dw = fc.conv_bwd_dw_reference(*args)
    want_y = fc.fused_conv_reference(x, w, stride=1, pad=1, relu=False)[0]
    for route in ("f32", "simt", None):
        assert torch.equal(fc.conv_bwd_dw(*args, route=route), want_dw)
        assert torch.equal(fc.fused_conv(x, w, stride=1, pad=1, relu=False,
                                         route=route)[0], want_y)
    with pytest.raises(ValueError, match="takes 'f32'"):
        fc.conv_bwd_dw(*args, route="tc")
    with pytest.raises(ValueError, match="takes 'f32'"):
        fc.fused_conv(x, w, stride=1, pad=1, relu=False, route="tc")
    xr = torch.zeros(1, 4, 4, 6)
    for t in (fc.conv_bwd_dx, fc.conv_bwd_dw):
        with pytest.raises(ValueError, match="route 'f32'.*takes 'simt'"):
            t(xr, torch.zeros(3, 3, 6, 12), None, None, y, dy, ds, dss, 1, 1,
              False, route="f32")
    with pytest.raises(ValueError, match="route 'f32'.*takes 'simt'"):
        fc.fused_conv(xr, torch.zeros(3, 3, 6, 12), stride=1, pad=1,
                      relu=False, route="f32")
    for t in (fc.conv_bwd_dx, fc.conv_bwd_dw):
        with pytest.raises(ValueError, match="route 'f32'.*takes 'simt'"):
            t(x.bfloat16(), w.bfloat16(), None, None, y.bfloat16(),
              dy.bfloat16(), ds, dss, 1, 1, False, route="f32")


F32_BLOCK = 64   # pixels and input channels of a block
F32_DEPTH = 32   # output channels of a step


def _fold_np(dy, y, ds, dss):
    """``fold_cotangent`` in fp32: (dy + ds) + (2 * y) * dss, no fma."""
    f = np.float32
    return ((dy.astype(f) + ds.astype(f)).astype(f)
            + ((f(2) * y.astype(f)).astype(f) * dss.astype(f)).astype(f)
            ).astype(f)


def dx_f32_mirror(x, w, a, b, y, dy, ds, dss, stride, pad, relu, r=None,
                  ar=None, br=None, g=None, zero_fill=True):
    """``conv_bwd_dx_f32_kernel`` and its column sums on numpy inputs
    (NHWC, HWIO), block by block: the phase's pixel boxes
    (``fc.dx_tc_box`` for one tap), per 32 channels of Co the tap's dy and
    y boxes with TMA's zero fill outside the tensor, the fold (rows
    outside the tensor or the box and channels past Co written as 0,
    unless ``zero_fill`` is False), the w box (64 rows of the flattened
    (tap, ci) rows, zero past their end), the block's product, the
    epilogue with the prologue's mask, and the partial sums of each block
    added in block order. Returns (dx, da, db, dr, dar, written):
    ``written`` counts the stores to each element of dx."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    ho, wo = dy.shape[1:3]
    s = stride
    pro = a is not None or r is not None
    bw, bh, bn = fc.dx_tc_box(n, h, wd, kw, s, 1)
    ew, eh = -(-wd // s), -(-h // s)
    tw, th, tn = -(-ew // bw), -(-eh // bh), -(-n // bn)
    wflat = w.reshape(kh * kw * ci, co)
    dx = np.full(x.shape, np.nan, np.float32)
    dr = np.full(x.shape, np.nan, np.float32) if r is not None else None
    written = np.zeros(x.shape, int)
    parts = []
    rows = np.arange(F32_BLOCK)
    jj, ii, nn = rows % bw, (rows // bw) % bh, rows // (bw * bh)
    av = a if a is not None else np.ones(ci, np.float32)
    bv = b if a is not None else np.zeros(ci, np.float32)
    for ph in range(s * s):
        ry, rx = ph // s, ph % s
        ky0, kx0 = (ry + pad) % s, (rx + pad) % s
        kys = range(ky0, kh, s)
        kxs = range(kx0, kw, s)
        hq = -(-(h - ry) // s) if ry < h else 0
        wq = -(-(wd - rx) // s) if rx < wd else 0
        for blk in range(tw * th * tn):
            wb, hb, nb = blk % tw, (blk // tw) % th, blk // (tw * th)
            i0, j0, n0 = hb * bh, wb * bw, nb * bn
            pn, pi, pj = n0 + nn, i0 + ii, j0 + jj
            row_ok = (rows < bw * bh * bn) & (pn < n)
            sums = np.zeros((3, ci))
            for c0blk in range(0, ci, F32_BLOCK):
                acc = np.zeros((F32_BLOCK, F32_BLOCK), np.float64)
                for ky in kys:
                    for kx in kxs:
                        oy, ox = (ry + pad - ky) // s, (rx + pad - kx) // s
                        oh, ow = pi + oy, pj + ox
                        inside = (pn < n) & (oh >= 0) & (oh < ho) & \
                            (ow >= 0) & (ow < wo) & (rows < bw * bh * bn)
                        for c0 in range(0, co, F32_DEPTH):
                            cols = c0 + np.arange(F32_DEPTH)
                            cin = cols < co
                            dyt = np.zeros((F32_BLOCK, F32_DEPTH), np.float32)
                            yt = np.zeros_like(dyt)
                            sel = np.ix_(inside, cin)
                            idx = (pn[inside], oh[inside], ow[inside])
                            dyt[sel] = dy[idx][:, cols[cin]]
                            yt[sel] = y[idx][:, cols[cin]]
                            dsv = np.zeros(F32_DEPTH, np.float32)
                            dssv = np.zeros(F32_DEPTH, np.float32)
                            dsv[cin], dssv[cin] = ds[cols[cin]], \
                                dss[cols[cin]]
                            at = _fold_np(dyt, yt, dsv, dssv)
                            if zero_fill:
                                at[~inside] = 0.0
                                at[:, ~cin] = 0.0
                            wrow = (ky * kw + kx) * ci + c0blk + rows
                            bt = np.zeros((F32_BLOCK, F32_DEPTH), np.float32)
                            win = wrow < kh * kw * ci
                            bt[np.ix_(win, cin)] = \
                                wflat[wrow[win]][:, cols[cin]]
                            acc += at.astype(np.float64) @ bt.T
                # epilogue
                ok = row_ok & (pi < hq) & (pj < wq)
                chans = c0blk + np.arange(F32_BLOCK)
                cok = chans < ci
                hh, ww = ry + s * pi[ok], rx + s * pj[ok]
                v = acc[np.ix_(ok, cok)].astype(np.float32)
                pix = (pn[ok], hh, ww)
                cc = chans[cok]
                if g is not None:
                    v = (v + g[pix][:, cc]).astype(np.float32)
                np.add.at(written, (pix[0][:, None], pix[1][:, None],
                                    pix[2][:, None], cc[None, :]), 1)
                if not pro:
                    dx[pix[0][:, None], pix[1][:, None], pix[2][:, None],
                       cc] = v
                    continue
                xv = x[pix][:, cc]
                lin = (xv * av[cc]).astype(np.float32) + bv[cc]
                rv = np.zeros_like(xv)
                if r is not None:
                    rv = r[pix][:, cc]
                    lin = (lin.astype(np.float32)
                           + (rv * ar[cc]).astype(np.float32)).astype(
                        np.float32) + br[cc]
                d = np.where(lin > 0, v, 0.0) if relu else v
                dx[pix[0][:, None], pix[1][:, None], pix[2][:, None], cc] = \
                    d * av[cc]
                if r is not None:
                    dr[pix[0][:, None], pix[1][:, None], pix[2][:, None],
                       cc] = d * ar[cc]
                sums[0, cc] += (d * xv).sum(0)
                sums[1, cc] += d.sum(0)
                sums[2, cc] += (d * rv).sum(0)
            parts.append(sums)
    tot = np.sum(parts, axis=0) if pro else None
    da = tot[0] if a is not None else None
    db = tot[1] if a is not None else None
    dar = tot[2] if r is not None else None
    return dx, da, db, dr, dar, written


# (n, h, w, ci, co, k, stride, pad, kind) at small sizes: the box kinds
# (part of a row, whole rows, whole images), both phases of stride 2, taps
# reaching past the image, a ragged last Co chunk and Ci block
F32_DX_CASES = [
    ("3x3_pro_rows", 2, 9, 11, 8, 12, 3, 1, 1, "pro"),
    ("3x3_s2_pro_odd", 2, 9, 7, 16, 8, 3, 2, 1, "pro"),
    ("1x1_s2_plain", 3, 6, 6, 4, 36, 1, 2, 0, "plain"),
    ("5x5_s2_res_emit", 2, 15, 15, 24, 40, 5, 2, 2, "res"),
    ("3x3_res_wide", 1, 3, 70, 68, 8, 3, 1, 1, "res"),
    ("1x1_images", 5, 3, 4, 72, 4, 1, 1, 0, "pro"),
]


def _np_case(case, seed=0):
    _, n, h, w, ci, co, k, stride, pad, kind = case
    rs = np.random.RandomState(seed)
    ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
    f = np.float32
    t = dict(x=rs.randn(n, h, w, ci).astype(f),
             w=(rs.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(f),
             y=rs.randn(n, ho, wo, co).astype(f),
             dy=rs.randn(n, ho, wo, co).astype(f),
             ds=(rs.randn(co) * 0.1).astype(f),
             dss=(rs.randn(co) * 0.01).astype(f))
    if kind != "plain":
        t.update(a=(rs.rand(ci) + 0.5).astype(f),
                 b=(rs.randn(ci) * 0.5).astype(f))
    if kind == "res":
        t.update(r=rs.randn(n, h, w, ci).astype(f),
                 ar=(rs.rand(ci) + 0.5).astype(f),
                 br=(rs.randn(ci) * 0.5).astype(f),
                 g=rs.randn(n, h, w, ci).astype(f))
    return t


def _mirror_and_plain(case, zero_fill=True):
    _, n, h, w, ci, co, k, stride, pad, kind = case
    t = _np_case(case)
    kw = {key: t.get(key) for key in ("r", "ar", "br", "g")}
    got = dx_f32_mirror(t["x"], t["w"], t.get("a"), t.get("b"), t["y"],
                        t["dy"], t["ds"], t["dss"], stride, pad, True,
                        zero_fill=zero_fill, **kw)
    tt = {key: torch.from_numpy(v) for key, v in t.items()}
    want = fc.conv_bwd_dx_reference(
        tt["x"], tt["w"], tt.get("a"), tt.get("b"), tt["y"], tt["dy"],
        tt["ds"], tt["dss"], stride, pad, True,
        **{key: tt.get(key) for key in ("r", "ar", "br", "g")})
    return got, want, kind


@pytest.mark.parametrize("case", F32_DX_CASES, ids=[c[0] for c in F32_DX_CASES])
def test_f32_dx_mirror_matches_the_plain_version(case):
    """The mirrored kernel writes every dx element exactly once and equals
    ``conv_bwd_dx_reference`` within 1e-5 of max(1, max|plain|) (fp32
    sums in another order), the sums within 1e-5 relative L2."""
    (dx, da, db, dr, dar, written), want, kind = _mirror_and_plain(case)
    assert (written == 1).all()
    names = ("dx", "da", "db", "dr", "dar")
    for name, got, ref in zip(names, (dx, da, db, dr, dar), want + (None,)
                              * (5 - len(want))):
        if ref is None:
            assert got is None, name
            continue
        ref = ref.numpy().astype(np.float64)
        assert not np.isnan(got).any(), name
        err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
        assert err <= 1e-5, (name, err)
        if ref.ndim == 1:
            l2 = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert l2 <= 1e-5, (name, l2)


@pytest.mark.parametrize("case", [F32_DX_CASES[0], F32_DX_CASES[3]],
                         ids=[F32_DX_CASES[0][0], F32_DX_CASES[3][0]])
def test_f32_dx_fold_must_zero_what_tma_zero_fills(case):
    """TMA fills rows outside dy (the conv's padding), rows past the box's
    pixels and channels past Co with zeros, and the fold of a zero is ds:
    without the kernel's zeroing after the fold the mirror leaves the
    plain version."""
    (dx, *_), want, _ = _mirror_and_plain(case, zero_fill=False)
    ref = want[0].numpy()
    assert np.abs(dx - ref).max() > 1e-2


def _dx_f32_coverage(n, h, w, stride):
    """How many times the f32 K2's blocks write each input pixel: per
    phase, its boxes' rows read as the kernel reads them."""
    bw, bh, bn = fc.dx_tc_box(n, h, w, 1, stride, 1)
    assert bw * bh * bn <= F32_BLOCK
    ew, eh = -(-w // stride), -(-h // stride)
    tw, th, tn = -(-ew // bw), -(-eh // bh), -(-n // bn)
    count = np.zeros((n, h, w), int)
    rows = np.arange(bw * bh * bn)
    jj, ii, nn = rows % bw, (rows // bw) % bh, rows // (bw * bh)
    for ph in range(stride * stride):
        ry, rx = ph // stride, ph % stride
        hq = -(-(h - ry) // stride) if ry < h else 0
        wq = -(-(w - rx) // stride) if rx < w else 0
        blk = np.arange(tw * th * tn)
        i0 = ((blk // tw) % th) * bh
        j0 = (blk % tw) * bw
        n0 = (blk // (tw * th)) * bn
        pn, pi, pj = (n0[:, None] + nn, i0[:, None] + ii, j0[:, None] + jj)
        ok = (pn < n) & (pi < hq) & (pj < wq)
        np.add.at(count, (pn[ok], ry + stride * pi[ok], rx + stride * pj[ok]),
                  1)
    return count


def test_f32_dx_boxes_cover_every_pixel_once(resnet50_convs):
    """Per stride phase and box, the rows the f32 K2 stores (the box's
    pixels inside the phase) hold every input pixel exactly once, at
    ResNet-50's 52 conv shapes (B=32) and chip_smoke's conv cases."""
    import chip_smoke as cs

    shapes = {(32, h, w, s) for h, w, _, _, _, s, _ in resnet50_convs}
    shapes |= {(c[1], c[2], c[3], c[7]) for c in cs.CONV_CASES}
    for n, h, w, s in sorted(shapes):
        assert (_dx_f32_coverage(n, h, w, s) == 1).all(), (n, h, w, s)


def test_f32_dx_shared_memory_patterns():
    """The product's loads are flash_bwd_f32.cu's scores (4 A rows and 4 B
    rows of one 128-byte box, each load one wavefront; held in
    tests/test_torch_flash_bwd_route.py). The fold: thread tid takes
    chunk position tid % 8 of rows tid / 8 and tid / 8 + 32, both of one
    r % 8 and so one logical chunk (4 channels), the 256 threads every
    (row, chunk) of the 64 x 32 tile once, a warp's loads 4 rows x 8
    positions: 4 wavefronts, the least for 512 bytes. The epilogue's
    staging stores (row stride 72 floats) fall on 32 distinct banks."""
    tid = np.arange(256)
    fr, fp = tid >> 3, tid & 7
    seen = set()
    for k in range(2):
        row = fr + 32 * k
        logical = fp ^ (row & 7)
        assert (logical == (fp ^ (fr & 7))).all()
        seen |= set(zip(row.tolist(), logical.tolist()))
    assert len(seen) == 64 * 8
    for wp in range(8):
        lanes = slice(32 * wp, 32 * wp + 32)
        off = fr[lanes] * 128 + fp[lanes] * 16
        assert np.bincount((off // 16) % 8).max() == 4
    warp, lane = tid >> 5, tid & 31
    wr, wc, ly, lx = warp >> 1, warp & 1, lane >> 3, lane & 7
    ra, rb = 16 * wr + ly, 32 * wc + lx
    for i in range(4):
        for j in range(4):
            word = (ra + 4 * i) * 72 + rb + 8 * j
            for wp in range(8):
                banks = word[32 * wp:32 * wp + 32] % 32
                assert np.unique(banks).size == 32


def test_f32_dx_scratch_holds_every_partial(resnet50_convs):
    """The scratch ``conv_bwd_dx`` allocates for the f32 route: one row of
    Ci per (phase, box), three planes."""
    for h, w, ci, co, k, s, p in resnet50_convs:
        box = fc.dx_tc_box(32, h, w, k, s, 1)
        boxes = fc._boxes(32, -(-h // s), -(-w // s), box)
        ew, eh = -(-w // s), -(-h // s)
        assert boxes == -(-ew // box[0]) * -(-eh // box[1]) * \
            -(-32 // box[2])


# ---------------------------------------------------------------------------
# the fp32 K1 and K3 on the FP32 pipes (csrc/fused_conv_f32.cu,
# csrc/conv_bwd_f32.cu's conv_bwd_dw_f32_kernel)
# ---------------------------------------------------------------------------
def _tma_box(t, n0, h_idx, w_idx, c0, nn, rows_ok):
    """A 4-D TMA box of 32-channel chunks as the kernel receives it: rows
    whose pixel (n0 + nn, h_idx, w_idx) lies inside ``t`` (N, H, W, C)
    hold its channels c0 .. c0 + 63, zero past C (TMA's zero fill), zero
    outside the tensor; rows past the box (``~rows_ok``) are never written
    by TMA and hold stale values (NaN here)."""
    n, h, w, c = t.shape
    tile = np.zeros((F32_BLOCK, F32_BLOCK), np.float32)
    tile[~rows_ok] = np.nan
    pn = n0 + nn
    inside = rows_ok & (pn < n) & (h_idx >= 0) & (h_idx < h) & \
        (w_idx >= 0) & (w_idx < w)
    cols = c0 + np.arange(F32_BLOCK)
    cin = cols < c
    tile[np.ix_(inside, cin)] = \
        t[pn[inside], h_idx[inside], w_idx[inside]][:, cols[cin]]
    return tile, inside, cin


def _prologue_np(xt, rt, a, b, ar, br, cols, relu):
    """x_pro of a tile's channels ``cols`` (valid ones) in fp32, rounded as
    ``prologue_lin``: ((x*a) + b), then (+ r*ar), then + br."""
    f = np.float32
    av = a[cols] if a is not None else np.ones(cols.size, f)
    bv = b[cols] if a is not None else np.zeros(cols.size, f)
    lin = ((xt * av).astype(f) + bv).astype(f)
    if rt is not None:
        lin = ((lin + (rt * ar[cols]).astype(f)).astype(f)
               + br[cols]).astype(f)
    return np.where(lin > 0, lin, f(0)) if relu else lin


def _tile_sums(y):
    """The per-channel sum and sum of squares of y (rows x channels) as
    ``tile_stats_kernel`` and the SIMT K1's epilogue take them, then
    ``column_sum``: 64-row tiles, 4 rows a thread of 16 x 16, the 16
    thread rows in order; then each of 32 thread rows adds every 32nd
    tile, and the 32 in order. All fp32."""
    f = np.float32
    m, co = y.shape
    tiles = -(-m // F32_BLOCK)
    part = np.zeros((2, tiles, co), f)
    for t in range(tiles):
        red = np.zeros((2, 16, co), f)
        for ty in range(16):
            rows = [t * F32_BLOCK + ty * 4 + i for i in range(4)]
            for row in (row for row in rows if row < m):
                red[0, ty] = (red[0, ty] + y[row]).astype(f)
                red[1, ty] = (red[1, ty] + (y[row] * y[row]).astype(f)
                              ).astype(f)
        for k in range(16):
            part[:, t] = (part[:, t] + red[:, k]).astype(f)
    out = np.zeros((2, co), f)
    for ty in range(32):
        acc = np.zeros((2, co), f)
        for t in range(ty, tiles, 32):
            acc = (acc + part[:, t]).astype(f)
        out = (out + acc).astype(f)
    return out[0], out[1]


def fwd_f32_mirror(x, w, a, b, stride, pad, relu, r=None, ar=None, br=None,
                   emit=False, zero_fill=True):
    """``fused_conv_f32_kernel`` and its column sums on numpy inputs (NHWC,
    HWIO), block by block: the output boxes of ``fc.tc_box``, per tap and
    64 channels of Ci the shifted (strided) x box and the r box as TMA
    brings them, the prologue in place (taps outside x and channels past
    Ci written as 0, unless ``zero_fill`` is False; no rewrite for a plain
    conv), the w box (64 rows of the flattened (tap, ci) rows, zero past
    their end and past Co), the block's product, the epilogue's valid
    rows, and the sums of y in the SIMT kernel's order (``_tile_sums``).
    Returns (y, s, ss, xp, written, emitted): ``written`` and ``emitted``
    count the stores to each element of y and xp."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    ho, wo = _out(h, kh, stride, pad), _out(wd, kw, stride, pad)
    s = stride
    pro = a is not None or r is not None
    bw, bh, bn = fc.tc_box(n, ho, wo)
    tw, th, tn = -(-wo // bw), -(-ho // bh), -(-n // bn)
    rows = np.arange(F32_BLOCK)
    jj, ii, nn = rows % bw, (rows // bw) % bh, rows // (bw * bh)
    rows_ok = rows < bw * bh * bn
    wflat = w.reshape(kh * kw * ci, co)
    emit_rows = emit and kh == kw == 1 and s == 1 and pad == 0
    y = np.full((n, ho, wo, co), np.nan, np.float32)
    xp = np.full(x.shape, np.nan, np.float32) if emit else None
    written = np.zeros(y.shape, int)
    emitted = np.zeros(x.shape, int)
    for blk in range(tw * th * tn):
        wo0, ho0 = (blk % tw) * bw, ((blk // tw) % th) * bh
        n0 = (blk // (tw * th)) * bn
        pn, po, pw = n0 + nn, ho0 + ii, wo0 + jj
        ok = rows_ok & (pn < n) & (po < ho) & (pw < wo)
        for co0 in range(0, co, F32_BLOCK):
            acc = np.zeros((F32_BLOCK, F32_BLOCK), np.float64)
            for tap in range(kh * kw):
                ky, kx = divmod(tap, kw)
                hi, wi = po * s - pad + ky, pw * s - pad + kx
                for c0 in range(0, ci, F32_BLOCK):
                    at, xin, cin = _tma_box(x, n0, hi, wi, c0, nn, rows_ok)
                    if pro:
                        rt = _tma_box(r, n0, hi, wi, c0, nn, rows_ok)[0] \
                            if r is not None else None
                        chans = np.minimum(c0 + np.arange(F32_BLOCK),
                                           ci - 1)
                        v = _prologue_np(at, rt, a, b, ar, br, chans, relu)
                        if zero_fill:
                            v[~xin] = 0.0
                            v[:, ~cin] = 0.0
                        else:   # only the channels past Ci: b is not read
                            v[:, ~cin] = 0.0
                        v[~rows_ok] = 0.0
                        at = v.astype(np.float32)
                        if emit_rows and co0 == 0:
                            sel = np.ix_(xin & ok, cin)
                            pix = (pn[xin & ok], hi[xin & ok], wi[xin & ok])
                            cc = (c0 + np.arange(F32_BLOCK))[cin]
                            xp[pix[0][:, None], pix[1][:, None],
                               pix[2][:, None], cc] = at[sel]
                            np.add.at(emitted, (pix[0][:, None],
                                                pix[1][:, None],
                                                pix[2][:, None],
                                                cc[None, :]), 1)
                    wrow = tap * ci + c0 + rows
                    bt = np.zeros((F32_BLOCK, F32_BLOCK), np.float32)
                    cols = co0 + np.arange(F32_BLOCK)
                    win, con = wrow < kh * kw * ci, cols < co
                    bt[np.ix_(win, con)] = wflat[wrow[win]][:, cols[con]]
                    with np.errstate(invalid="ignore"):
                        acc += at.astype(np.float64) @ bt
            cols = co0 + np.arange(F32_BLOCK)
            con = cols < co
            v = acc[np.ix_(ok, con)].astype(np.float32)
            y[pn[ok][:, None], po[ok][:, None], pw[ok][:, None],
              cols[con]] = v
            np.add.at(written, (pn[ok][:, None], po[ok][:, None],
                                pw[ok][:, None], cols[con][None, :]), 1)
    s, ss = _tile_sums(y.reshape(-1, co))
    if emit and not emit_rows:      # join_emit_kernel
        chans = np.arange(ci)
        xp = _prologue_np(x, r, a, b, ar, br, chans, relu)
        emitted[:] = 1
    return y, s, ss, xp, written, emitted


def dw_f32_mirror(x, w, a, b, y, dy, ds, dss, stride, pad, relu, r=None,
                  ar=None, br=None, zero_fill=True):
    """``conv_bwd_dw_f32_kernel`` and its split sum on numpy inputs: per
    (taps, 64 input channels, 64 output channels) tile and range of
    ``fc.dw_splits(..., "f32", taps)`` whole output boxes
    (``fc.dw_tc_box``; a row of 3 taps at stride 1, ``fc.dw_tc_taps``),
    per box the x box shifted (strided) by the first tap and the dy, y
    (and r) boxes as TMA brings them; the rewrite in place (dy_t, and
    x_pro with a prologue), writing 0 to rows past the box, to pixels
    outside the output (the widened columns of a row of taps among them)
    or whose tap lies outside x, and to channels past Ci or Co (unless
    ``zero_fill`` is False: then only rows past the box and channels past
    the widths); per tap t the product x_pro^T . dy_t shifted down t rows
    (zero rows before the box); each range's fp32 plane, then the planes
    added in order. Returns (dw, splits, taps)."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    ho, wo = dy.shape[1:3]
    s = stride
    pro = a is not None or r is not None
    taps = fc.dw_tc_taps(kw, s, wo, r is not None)
    bw, bh, bn = fc.dw_tc_box(n, ho, wo, kw, taps)
    tw, th, tn = -(-wo // bw), -(-ho // bh), -(-n // bn)
    total = tw * th * tn
    splits = fc.dw_splits(n, ho, wo, ci, co, kh, kw, "f32", taps)
    per = -(-total // splits)
    rows = np.arange(F32_BLOCK)
    jj, ii, nn = rows % bw, (rows // bw) % bh, rows // (bw * bh)
    rows_ok = rows < bw * bh * bn
    planes = np.zeros((splits, kh * kw, ci, co), np.float32)
    for z in range(splits):
        for group in range(kh * kw // taps):
            ky, kx = divmod(group * taps, kw)
            for ci0 in range(0, ci, F32_BLOCK):
                for co0 in range(0, co, F32_BLOCK):
                    acc = np.zeros((taps, F32_BLOCK, F32_BLOCK), np.float64)
                    for c in range(z * per, min(z * per + per, total)):
                        wo0, ho0 = (c % tw) * bw, ((c // tw) % th) * bh
                        n0 = (c // (tw * th)) * bn
                        pn, po, pw = n0 + nn, ho0 + ii, wo0 + jj
                        pix = rows_ok & (pn < n) & (po < ho) & (pw < wo)
                        hi, wi = po * s - pad + ky, pw * s - pad + kx
                        xt, xin, cin = _tma_box(x, n0, hi, wi, ci0, nn,
                                                rows_ok)
                        dt, _, con = _tma_box(dy, n0, po, pw, co0, nn,
                                              rows_ok)
                        yt = _tma_box(y, n0, po, pw, co0, nn, rows_ok)[0]
                        cols = np.minimum(co0 + np.arange(F32_BLOCK), co - 1)
                        d = _fold_np(dt, yt, ds[cols], dss[cols])
                        if zero_fill:
                            d[~pix] = 0.0
                        d[:, ~con] = 0.0
                        d[~rows_ok] = 0.0
                        if pro:
                            rt = _tma_box(r, n0, hi, wi, ci0, nn, rows_ok)[0] \
                                if r is not None else None
                            chans = np.minimum(ci0 + np.arange(F32_BLOCK),
                                               ci - 1)
                            xt = _prologue_np(xt, rt, a, b, ar, br, chans,
                                              relu)
                            if zero_fill:
                                xt[~xin] = 0.0
                            xt[:, ~cin] = 0.0
                        xt[~rows_ok] = 0.0
                        for t in range(taps):   # dy's row p - t
                            dt_ = np.zeros_like(d)
                            dt_[t:] = d[:F32_BLOCK - t]
                            acc[t] += xt.astype(np.float64).T @ dt_
                    cis = ci0 + np.arange(F32_BLOCK)
                    cos = co0 + np.arange(F32_BLOCK)
                    for t in range(taps):
                        planes[z, ky * kw + kx + t][np.ix_(
                            cis[cis < ci], cos[cos < co])] = \
                            acc[t][np.ix_(cis < ci, cos < co)]
    dw = np.zeros((kh * kw, ci, co), np.float32)
    for z in range(splits):
        dw = (dw + planes[z]).astype(np.float32)
    return dw.reshape(kh, kw, ci, co), splits, taps


# (n, h, w, ci, co, k, stride, pad, kind) at small sizes: the box kinds
# (part of a row, whole rows, whole images), stride 2 with odd sizes, taps
# reaching past the image, Co = 40 with a box partly past it, Ci past 64,
# 7x7 boxes of 49 rows, a 1x1 stride-2 plain conv
F32_FWD_DW_CASES = [
    ("3x3_pro_rows", 2, 9, 11, 8, 12, 3, 1, 1, "pro"),
    ("3x3_s2_pro_odd", 2, 9, 7, 16, 8, 3, 2, 1, "pro"),
    ("1x1_s2_plain", 3, 6, 6, 4, 36, 1, 2, 0, "plain"),
    ("5x5_s2_res_emit", 2, 15, 15, 24, 40, 5, 2, 2, "res"),
    ("3x3_res_wide", 1, 3, 70, 68, 8, 3, 1, 1, "res"),
    ("1x1_join_emit_images", 5, 3, 4, 72, 4, 1, 1, 0, "res"),
    ("3x3_7x7_boxes_plain", 2, 7, 7, 8, 68, 3, 1, 1, "plain"),
]


def _f32_mirrors(case, zero_fill=True):
    _, n, h, w, ci, co, k, stride, pad, kind = case
    t = _np_case(case)
    res = kind == "res"
    rkw = {key: t.get(key) for key in ("r", "ar", "br")}
    fwd = fwd_f32_mirror(t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                         True, emit=res, zero_fill=zero_fill, **rkw)
    dw = dw_f32_mirror(t["x"], t["w"], t.get("a"), t.get("b"), t["y"],
                       t["dy"], t["ds"], t["dss"], stride, pad, True,
                       zero_fill=zero_fill, **rkw)
    tt = {key: torch.from_numpy(v) for key, v in t.items()}
    trkw = {key: tt.get(key) for key in ("r", "ar", "br")}
    want_f = fc.fused_conv_reference(tt["x"], tt["w"], tt.get("a"),
                                     tt.get("b"), stride, pad, True,
                                     emit=res, **trkw)
    want_dw = fc.conv_bwd_dw_reference(tt["x"], tt["w"], tt.get("a"),
                                       tt.get("b"), tt["y"], tt["dy"],
                                       tt["ds"], tt["dss"], stride, pad,
                                       True, **trkw)
    return fwd, dw, want_f, want_dw


def _rel_err(got, ref):
    ref = ref.numpy().astype(np.float64) if isinstance(ref, torch.Tensor) \
        else ref.astype(np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("case", F32_FWD_DW_CASES,
                         ids=[c[0] for c in F32_FWD_DW_CASES])
def test_f32_fwd_and_dw_mirrors_match_the_plain_version(case):
    """The mirrored f32 K1 writes every y element exactly once (and, when
    it emits, every xp element once) and equals ``fused_conv_reference``
    within 1e-5 of max(1, max|plain|), its sums within 1e-5 relative L2;
    the mirrored f32 K3, its ranges of whole boxes summed in order, equals
    ``conv_bwd_dw_reference`` within 1e-5 (fp32 sums in another order)."""
    (y, s, ss, xp, written, emitted), (dw, splits, taps), want_f, want_dw = \
        _f32_mirrors(case)
    assert (written == 1).all()
    assert not np.isnan(y).any()
    assert _rel_err(y, want_f[0]) <= 1e-5
    for got, ref in ((s, want_f[1]), (ss, want_f[2])):
        ref = ref.numpy().astype(np.float64)
        assert _rel_err(got, ref) <= 1e-5
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5
    if case[-1] == "res":
        assert (emitted == 1).all()
        assert np.array_equal(xp, want_f[3].numpy())
    assert splits >= 1 and not np.isnan(dw).any()
    assert taps == (3 if case[6] == 3 and case[7] == 1 and case[-1] != "res"
                    else 1)
    assert _rel_err(dw, want_dw) <= 1e-5


@pytest.mark.parametrize("case", [F32_FWD_DW_CASES[0], F32_FWD_DW_CASES[3]],
                         ids=[F32_FWD_DW_CASES[0][0], F32_FWD_DW_CASES[3][0]])
def test_f32_fwd_and_dw_must_zero_what_tma_zero_fills(case):
    """TMA fills the taps outside x (the padding) and the dy pixels
    outside the output with zeros; the prologue of a zero is relu(b) and
    the fold of a zero is ds. Without the kernels' zeroing after the
    rewrite both mirrors leave the plain versions."""
    (y, *_), (dw, *_), want_f, want_dw = _f32_mirrors(case, zero_fill=False)
    assert _rel_err(y, want_f[0]) > 1e-2
    assert _rel_err(dw, want_dw) > 1e-2


def test_f32_forward_boxes_cover_every_output_pixel_once(resnet50_convs):
    """The rows of every f32 K1 box (``fc.tc_box`` over the output), read
    as the kernel reads them, hold every output pixel exactly once, at the
    52 ResNet-50 convs at every batch bucket the ModelServer captures
    (1-32) and chip_smoke's conv cases; the f32 K3 walks the same
    boxes."""
    import chip_smoke as cs

    shapes = {(n, _out(h, k, s, p), _out(w, k, s, p))
              for h, w, _, _, k, s, p in resnet50_convs
              for n in cs.SERVER_BUCKETS}
    shapes |= {(c[1], _out(c[2], c[6], c[7], c[8]),
                _out(c[3], c[6], c[7], c[8]))
               for c in cs.CONV_CASES + cs.SERVING_CONV_CASES}
    for n, ho, wo in sorted(shapes):
        bw, bh, bn = fc.tc_box(n, ho, wo)
        assert bw * bh * bn <= F32_BLOCK
        tw, th, tn = -(-wo // bw), -(-ho // bh), -(-n // bn)
        count = np.zeros((n, ho, wo), int)
        rows = np.arange(bw * bh * bn)
        jj, ii, nn = rows % bw, (rows // bw) % bh, rows // (bw * bh)
        blk = np.arange(tw * th * tn)
        pw = (blk % tw)[:, None] * bw + jj
        po = ((blk // tw) % th)[:, None] * bh + ii
        pn = (blk // (tw * th))[:, None] * bn + nn
        ok = (pn < n) & (po < ho) & (pw < wo)
        np.add.at(count, (pn[ok], po[ok], pw[ok]), 1)
        assert (count == 1).all(), (n, ho, wo)


@pytest.mark.parametrize("batch", [8, 32, 128])
def test_f32_weight_gradient_splits_fill_the_card_with_whole_boxes(
        resnet50_convs, batch):
    """At every ResNet-50 shape the f32 K3 takes a row of 3 taps a block
    exactly at 3x3 stride 1, its ranges are whole boxes, none empty, at
    least 4 boxes each where there are that many; its grid (tiles x
    ranges) stays within one wave of two blocks an SM where the tiles
    allow, except where the tiles alone would leave one block on most SMs
    (132 < tiles < 264: the 144 tiles of 3x3/2 256->256 and the 192 row
    tiles of 3x3 512->512), which take about four blocks an SM; at B=32
    and 128 it busies every SM. The head case (3x3 64->64 at 56^2, B=32):
    3 row tiles x 86 ranges of 21 boxes (58-pixel rows); one tap a block
    would be 9 tiles x 29 ranges of 62."""
    for h, w, ci, co, k, s, p in resnet50_convs:
        ho, wo = _out(h, k, s, p), _out(w, k, s, p)
        taps = fc.dw_tc_taps(k, s, wo, False)
        assert taps == (3 if k == 3 and s == 1 else 1)
        tiles = k * (k // taps) * -(-ci // 64) * -(-co // 64)
        boxes = fc._boxes(batch, ho, wo, fc.dw_tc_box(batch, ho, wo, k, taps))
        splits = fc.dw_splits(batch, ho, wo, ci, co, k, k, "f32", taps)
        per = -(-boxes // splits)
        assert 1 <= splits <= boxes and (splits - 1) * per < boxes
        assert per >= min(4, boxes)
        if 132 < tiles < 264:
            assert splits == min(-(-528 // tiles), boxes // 4)
        elif tiles <= 264:
            assert tiles * splits <= 264
        if batch >= 32:
            assert tiles * splits >= SMS, (h, ci, co, k, s)
    assert fc.dw_splits(32, 56, 56, 64, 64, 3, 3, "f32", 3) == 86
    assert fc.dw_splits(32, 56, 56, 64, 64, 3, 3, "f32") == 29
    assert -(-fc._boxes(32, 56, 56) // 29) == 62
    assert fc.dw_splits(32, 14, 14, 256, 256, 3, 3, "f32") == 4
    assert fc.dw_splits(32, 14, 14, 256, 256, 3, 3, "tc") == 1


def test_f32_fwd_and_dw_shared_memory_patterns():
    """Each warp-wide 16-byte load of the f32 K1 and K3 products is one
    wavefront under the 128-byte swizzle (chunk c of row r at r * 128 +
    ((c ^ r % 8) << 4)): its lanes read at most 8 distinct 16-byte chunks,
    each in a bank quad of its own. K1: A rows ra + 4i (ra = 16 * (warp /
    2) + lane / 8) at one chunk, 4 chunks; B row t at chunk lane % 8, 8
    chunks (tools/torch_lds_wavefronts.py's a_rows and b_rows). K3: per
    pixel row p the x chunk lane % 8 of box warp % 2 (8 chunks) and the dy
    chunk of cy = 4 * (warp / 2) + lane / 8 (4 chunks). The rewrites take
    K2's pattern (held above); K1's epilogue stores its 4 x 4 tile as
    float4 rows of a 72-float stage: a quarter warp on 32 distinct
    banks."""
    lane = np.arange(32)

    def quads_ok(addr):
        uniq = np.unique(addr)
        return uniq.size <= 8 and np.unique((uniq // 16) % 8).size == \
            uniq.size and (uniq % 16 == 0).all()

    def sw(r, c):   # byte offset of chunk c of row r of a 2-box tile
        return (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r % 8)) << 4)

    for warp in range(8):
        wr, wc = warp >> 1, warp & 1
        ra = 16 * wr + (lane >> 3)
        for c in range(16):
            for i in range(4):
                assert quads_ok(sw(ra + 4 * i, np.full(32, c)))
        for t in range(64):
            assert quads_ok(wc * 8192 + sw(np.full(32, t), lane & 7))
        xb, cy = warp & 1, 4 * (warp >> 1) + (lane >> 3)
        for p in range(64):
            assert quads_ok(sw(np.full(32, p), 8 * xb + (lane & 7)))
            assert quads_ok(sw(np.full(32, p), cy))
        for i in range(4):
            word = (ra + 4 * i) * 72 + 32 * wc + 4 * (lane & 7)
            for q in range(4):
                banks = (word[8 * q:8 * q + 8, None] + np.arange(4)) % 32
                assert np.unique(banks).size == 32
