"""Which kernels a fused conv takes on the card, and the grid and scratch
each route sizes, checked on the CPU.

``fused_conv.conv_route`` sends bf16 with both widths multiples of 8 to
the tensor-core K1/K2/K3 (``csrc/fused_conv_tc.cu``,
``csrc/conv_bwd_tc.cu``) and everything else to the SIMT kernels
(``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``): one rule for all three.
The rule, the pixel boxes of the tensor-core kernels, their column blocks,
their splits of K and their scratch are plain Python, so they are held
here at all 52 conv shapes of ResNet-50; the kernels themselves run in
``tests/test_torch_fused_conv_kernel.py`` on the card. This file imports
nothing of JAX.
"""

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
    for ci in (3, 8, 20, 24, 64, 2048):
        for co in (8, 40, 64, 1000):
            assert fc.conv_route(torch.float32, ci, co) == "simt"


@pytest.mark.parametrize("ci, co", [(20, 72), (64, 12), (7, 8), (8, 100)])
def test_ragged_bf16_widths_take_the_simt_kernels(ci, co):
    """A width that is no whole number of 16-byte rows cannot be a TMA
    tensor: SIMT, as in ``test_torch_fused_conv_kernel``'s
    ``3x3_pro_ragged`` (Ci=20)."""
    assert fc.conv_route(torch.bfloat16, ci, co) == "simt"


def test_bf16_resnet50_convs_take_the_tensor_cores(resnet50_convs):
    for _, _, ci, co, *_ in resnet50_convs:
        assert fc.conv_route(torch.bfloat16, ci, co) == "tc"
        assert fc.conv_route(torch.float32, ci, co) == "simt"
    # chip_smoke's off-path 5x5 case (widths 24 and 40) too
    assert fc.conv_route(torch.bfloat16, 24, 40) == "tc"


def test_a_named_route_is_checked_against_the_rule():
    """``route="simt"`` takes any call (chip_smoke times the SIMT kernels in
    bf16 with it); ``"tc"`` only what the rule sends there; the check
    runs before the CPU's plain version, for the forward as for the
    backward."""
    x = torch.zeros(1, 4, 4, 20)
    w = torch.zeros(1, 1, 20, 8)
    y = dy = torch.zeros(1, 4, 4, 8)
    ds = dss = torch.zeros(8)
    fc.fused_conv(x, w, relu=False, route="simt")
    with pytest.raises(ValueError, match="takes 'simt'"):
        fc.fused_conv(x, w, relu=False, route="tc")
    with pytest.raises(ValueError, match="route 'fast'"):
        fc.fused_conv(x.bfloat16(), w.bfloat16(), relu=False, route="fast")
    for t in (fc.conv_bwd_dx, fc.conv_bwd_dw):
        t(x, w, None, None, y, dy, ds, dss, relu=False, route="simt")
        with pytest.raises(ValueError, match="takes 'simt'"):
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
    the tensor cores, in fp32 on the SIMT kernel; ragged bf16 on SIMT."""
    for _, _, ci, co, *_ in resnet50_convs:
        assert fc._pick_route(torch.bfloat16, ci, co, None) == "tc"
        assert fc._pick_route(torch.float32, ci, co, None) == "simt"
    assert fc._pick_route(torch.bfloat16, 20, 72, None) == "simt"


@pytest.mark.parametrize("batch", [8, 32, 128])
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
