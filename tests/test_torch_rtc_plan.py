"""The launch plans of two ``mx.rtc`` kernels, held on the CPU.

``softmax_ce_fwd_plan`` says whether a row of logits is held in shared
memory (``csrc/rtc/softmax_ce.cu``, the resident branch: one read, one
write) or streamed (two reads, one write), with the threads and the bytes
of shared memory of the launch; ``scale_plan`` and ``saxpy_plan`` give
``scale`` and ``saxpy`` one tile of 1024 floats a block. ``saxpy``'s
split of its elements (a scalar head, 16-byte quads, a scalar tail when
its three pointers share an alignment phase; four floats a thread
``blockDim.x`` apart when they do not) is mirrored here in Python and
checked to cover every element once at every combination of the three
phases. The resident branch's layout (element i of a
row at shared float ``phase + i``, the aligned middle in bulk copies of
16-byte quads, the partial quads at the ends by threads 0-7) is mirrored
here in Python and checked to cover every float it reads and writes at
every alignment phase. The kernels themselves run on the card
(``tests/test_torch_rtc.py``).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import rtc
from incubator_mxnet_tpu_torch.ops import rtc_kernels

#: an H100's opt-in limit of shared memory a block (bytes)
H100_SMEM = 232_448
#: softmax_ce.cu's ROW_CHUNKS: bulk copies a resident row
CHUNKS = 8


@pytest.mark.parametrize("phase", range(4))
def test_a_gpt2_row_is_resident_at_every_phase(phase):
    plan = rtc_kernels.softmax_ce_fwd_plan(50257, H100_SMEM)
    assert plan.resident and plan.threads == 1024
    assert rtc_kernels._ROW_STATIC + plan.shared_bytes <= H100_SMEM
    # the row at this phase: its quads fit in what the plan asks
    quads = (phase + 50257 + 3) // 4
    assert 16 * quads <= plan.shared_bytes


def test_rows_past_the_limit_stream():
    limit = (H100_SMEM - rtc_kernels._ROW_STATIC) // 16 * 4 - 3
    assert limit == 58061
    assert rtc_kernels.softmax_ce_fwd_plan(limit, H100_SMEM).resident
    for row in (limit + 1, 100003, 2**31 - 1):
        plan = rtc_kernels.softmax_ce_fwd_plan(row, H100_SMEM)
        assert not plan.resident
        assert plan.shared_bytes == 0      # the kernel's static memory only
        assert plan.threads % 32 == 0 and plan.threads <= 1024


@pytest.mark.parametrize("row", [0, 1, 2, 3, 4, 5, 7, 8, 100, 4099, 32769,
                                 50257, 58061, 58062, 100003])
@pytest.mark.parametrize("limit", [48 * 1024, 101_376, H100_SMEM])
def test_the_plan_never_asks_past_the_limit(row, limit):
    plan = rtc_kernels.softmax_ce_fwd_plan(row, limit)
    assert rtc_kernels._ROW_STATIC + plan.shared_bytes <= limit
    assert plan.shared_bytes % 16 == 0
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    need = 16 * ((row + 6) // 4)
    # resident exactly when the row fits at its worst phase beside the
    # static shared memory; the kernel compares the row's bytes with the
    # dynamic shared memory it was given
    assert plan.resident == (rtc_kernels._ROW_STATIC + need <= limit)
    assert (need <= plan.shared_bytes) == plan.resident


def test_small_rows_take_a_warp_or_a_few():
    for row, threads in ((1, 32), (7, 32), (125, 32), (126, 64),
                         (4099, 1024)):
        plan = rtc_kernels.softmax_ce_fwd_plan(row, H100_SMEM)
        assert plan.resident and plan.threads == threads, row


def _resident_layout(phase, n):
    """softmax_ce.cu's resident row, mirrored: the shared floats each bulk
    copy and each of threads 0-7 fills, and the global floats each
    writes back (16-byte stores over the full quads)."""
    nq, q0, q1 = (phase + n + 3) // 4, int(phase > 0), (phase + n) // 4
    copies = []
    for c in range(CHUNKS):
        lo, hi = max(nq * c // CHUNKS, q0), min(nq * (c + 1) // CHUNKS, q1)
        if hi > lo:
            copies.append((4 * lo, 4 * lo - phase, 4 * (hi - lo)))
    slots = []
    for t in range(8):
        if t >= 4 and nq <= 1:
            continue
        q = 0 if t < 4 else nq - 1
        if not q0 <= q < q1:
            slots.append(4 * q + (t & 3))
    return nq, copies, slots


@pytest.mark.parametrize("phase", range(4))
def test_the_resident_layout_covers_each_row_once(phase):
    for n in list(range(0, 70)) + [4099, 50257, 58061]:
        nq, copies, slots = _resident_layout(phase, n)
        filled = list(slots)
        for dst, src, floats in copies:
            assert dst % 4 == 0 and (phase + src) % 4 == 0   # 16 bytes
            assert 0 <= src and src + floats <= n
            assert dst - phase == src             # element i at phase + i
            filled += range(dst, dst + floats)
        # every quad the max and sum passes read is filled, once, and
        # nothing past the row's planned bytes (an empty row pads quad 0)
        assert len(set(filled)) == len(filled)
        assert set(range(4 * nq)) <= set(filled), (phase, n)
        assert max(filled, default=0) < 4 * ((n + 6) // 4)
        # every element of the row is written back, once: full quads by
        # 16-byte stores, the rest by the slots' threads
        written = [4 * q + k - phase for q in range(int(phase > 0),
                                                    (phase + n) // 4)
                   for k in range(4)]
        written += [j - phase for j in slots if 0 <= j - phase < n]
        assert sorted(written) == list(range(n)), (phase, n)
        assert 16 * nq <= \
            rtc_kernels.softmax_ce_fwd_plan(n, H100_SMEM).shared_bytes


def test_scale_takes_one_tile_of_1024_floats_a_block():
    assert rtc_kernels.scale_plan(163_037_184) == ((159_216, 1, 1),
                                                   (256, 1, 1))
    for n, blocks in ((0, 1), (1, 1), (1024, 1), (1025, 2), (4099, 5),
                      (2**31 - 1, 2**21)):
        assert rtc_kernels.scale_plan(n)[0] == (blocks, 1, 1), n
    # a block's tile: a 16-byte quad a thread, or four floats a thread
    src = (rtc_kernels.RTC_SRC / "scale.cu").read_text()
    assert "const long long tile = 4ll * blockDim.x;" in src


def test_the_kernel_constants_match_the_plan():
    """The plan's static shared memory is the kernel's: 32 float
    reduction slots and ROW_CHUNKS 8-byte mbarriers."""
    src = (rtc_kernels.RTC_SRC / "softmax_ce.cu").read_text()
    assert f"#define ROW_CHUNKS {CHUNKS}" in src
    assert "__shared__ float slots[32];" in src
    assert "__shared__ unsigned long long bars[ROW_CHUNKS];" in src
    assert src.count("__shared__") == 3          # and the dynamic row
    assert rtc_kernels._ROW_STATIC == 32 * 4 + CHUNKS * 8


@pytest.mark.parametrize("shape", [(3, 7), (2, 4099), (1, 58046)])
@pytest.mark.parametrize("req", ["write", "add"])
def test_cpu_wrappers_take_the_plain_versions(shape, req):
    """On the CPU, the wrappers take the plain versions whatever the plan
    would be on a card; nothing is launched and no card is asked."""
    rs = np.random.RandomState(shape[1])
    x = mx.nd.array((4 * rs.randn(*shape)).astype(np.float32), ctx=mx.cpu())
    y = mx.nd.array(rs.rand(*shape).astype(np.float32), ctx=mx.cpu())
    y0 = y.as_torch().clone()
    before = dict(rtc.launches)
    rtc_kernels.softmax_ce_fwd(x, y, req)
    want = torch.softmax(x.as_torch(), -1)
    if req == "add":
        want = y0 + want
    torch.testing.assert_close(y.as_torch(), want, rtol=1e-6, atol=0)
    view = mx.nd.NDArray(x.as_torch().reshape(-1)[1:])
    assert torch.equal(rtc_kernels.scale(view, 0.5).as_torch(),
                       view.as_torch() * 0.5)
    assert dict(rtc.launches) == before


def test_saxpy_takes_one_tile_of_1024_floats_a_block():
    assert rtc_kernels.saxpy_plan(163_037_184) == ((159_216, 1, 1),
                                                   (256, 1, 1))
    for n in (0, 1, 3, 1024, 1025, 4099, 2**31 - 1):
        (blocks, _, _), (threads, _, _) = rtc_kernels.saxpy_plan(n)
        assert (blocks, threads) == ((max(1, -(-n // 1024))), 256), n
        assert blocks * 4 * threads >= n             # the tiles cover n
    src = (rtc_kernels.RTC_SRC / "saxpy.cu").read_text()
    assert "const long long tile = 4ll * blockDim.x;" in src
    assert rtc_kernels.KERNELS["saxpy"].options == ("--fmad=false",)


def _saxpy_elements(phases, n, grid, block):
    """``csrc/rtc/saxpy.cu``'s elements, mirrored: the element indices each
    thread of a ``grid`` x ``block`` launch writes (with the inputs it
    reads at the same index) for a, b and out at the given float
    alignment phases (0-3: the pointer's offset in floats from a 16-byte
    boundary)."""
    threads = grid * block
    written = []
    if len(set(phases)) != 1:                   # four floats a thread
        tile = 4 * block
        for bx in range(grid):
            for t in range(block):
                base = bx * tile
                while base < n:
                    written += [base + k * block + t for k in range(4)
                                if base + k * block + t < n]
                    base += grid * tile
        return written
    pa = 4 * phases[0]                          # bytes past the boundary
    head = min(n, ((16 - pa) & 15) >> 2)
    n4 = (n - head) >> 2
    for tid in range(threads):
        written += [head + 4 * i + k for i in range(tid, n4, threads)
                    for k in range(4)]
        written += list(range(tid, head, threads))
        written += list(range(head + 4 * n4 + tid, n, threads))
    # every quad starts on a 16-byte boundary of each pointer
    assert all((phases[0] + head + 4 * i) % 4 == 0 for i in range(n4))
    return written


@pytest.mark.parametrize("pa", range(4))
@pytest.mark.parametrize("pb", range(4))
@pytest.mark.parametrize("po", range(4))
def test_saxpy_split_covers_every_element_once(pa, pb, po):
    """At every combination of the three pointers' phases, for n below 4
    and around the quads, on the plan's grid and on smaller ones: each
    element is written once, by one thread, and nothing past n."""
    for n in (0, 1, 2, 3, 4, 5, 7, 8, 9, 1023, 1024, 1025, 4099):
        grids = {rtc_kernels.saxpy_plan(n)[0][0], 1, 2}
        for grid in grids:
            for block in (256, 32, 1):
                got = _saxpy_elements((pa, pb, po), n, grid, block)
                assert sorted(got) == list(range(n)), (n, grid, block)
