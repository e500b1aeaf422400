"""``mx.rtc``: CUDA kernels compiled at run time with NVRTC (the port of
the JAX package's Pallas ``rtc`` surface).

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX (``python -m pytest --noconftest tests/test_torch_rtc.py``; the
repo's conftest imports JAX). Here, without a card: the signature parser,
the argument checks, the refusals (a CPU context or array, the Pallas
stubs, a missing NVRTC: nothing falls back), the cubin cache, and the CPU
path of the kernels' wrappers. On the card (the tests skip without one,
decided in a fixture): the five kernels of ``csrc/rtc/`` built and
launched at small and odd shapes against their plain versions (the
forward's rows resident in shared memory and streamed, on views at every
alignment phase, by ``req``; ``scale`` and ``saxpy`` on views at every
phase and on small grids), the
softmax cross-entropy custom op forward and backward, MXNet's ``axpy``
example, an opt-in to over 48 KB of dynamic shared memory, capture in a
CUDA graph, and a compile error carrying NVRTC's log.

Tolerances on the card: ``scale``, ``saxpy`` (built with ``--fmad=false``),
``first_row`` and ``softmax_ce_bwd`` bit for bit (the same roundings as the
plain versions); ``softmax_ce_fwd`` 1e-5 of each probability, relative (a
sum of exponentials taken in another order; most probabilities are far
below any absolute bound worth holding).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import rtc
from incubator_mxnet_tpu_torch.ops import _nvrtc, rtc_kernels

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: an rtc kernel has no CPU mode")
    torch.zeros(1, device="cuda:0")          # torch owns the context
    return mx.gpu(0)


# ---------------------------------------------------------------------------
# signatures and argument checks
# ---------------------------------------------------------------------------
def test_signature_parser():
    args = rtc.parse_signature("const float *x, float* y,float alpha, int n,"
                               " const int64_t   * idx, __half h")
    assert [(a.ctype, a.is_const, a.is_pointer, a.name) for a in args] == [
        ("float", True, True, "x"), ("float", False, True, "y"),
        ("float", False, False, "alpha"), ("int", False, False, "n"),
        ("int64_t", True, True, "idx"), ("__half", False, False, "h")]
    unnamed = rtc.parse_signature("const double *, int8_t")
    assert [(a.ctype, a.is_pointer, a.name) for a in unnamed] == [
        ("double", True, "arg0"), ("int8_t", False, "arg1")]


@pytest.mark.parametrize("bad", ["const", "float **x", "unsigned int n",
                                 "float x y", "", "float *x,"])
def test_signature_parser_refuses_malformed_arguments(bad):
    with pytest.raises(ValueError, match="invalid argument"):
        rtc.parse_signature(bad)


@pytest.mark.parametrize("bad", ["long n", "float4 *v", "const size_t *n"])
def test_signature_parser_refuses_unknown_types(bad):
    with pytest.raises(TypeError, match="unsupported kernel argument type"):
        rtc.parse_signature(bad)


def _kernel(signature="const float *x, float *y, float alpha, int n"):
    return rtc.CudaKernel(None, "k", "k", rtc.parse_signature(signature))


def test_launch_checks_arguments_against_the_signature():
    x = mx.nd.zeros((4,), ctx=mx.cpu())
    y = mx.nd.zeros((4,), ctx=mx.cpu())
    k, g = _kernel(), ((1, 1, 1), (4, 1, 1))
    with pytest.raises(TypeError, match="expects 4 arguments but got 3"):
        k.launch([x, y, 1.0], mx.gpu(0), *g)
    with pytest.raises(TypeError, match="must be an NDArray"):
        k.launch([x.asnumpy(), y, 1.0, 4], mx.gpu(0), *g)
    ints = mx.nd.zeros((4,), ctx=mx.cpu(), dtype="int32")
    with pytest.raises(TypeError, match=r"int32, the signature says float\*"):
        k.launch([x, ints, 1.0, 4], mx.gpu(0), *g)
    with pytest.raises(TypeError, match="must be a number"):
        k.launch([x, y, "1.0", 4], mx.gpu(0), *g)
    with pytest.raises(TypeError, match="the signature says int"):
        k.launch([x, y, 1.0, 4.5], mx.gpu(0), *g)
    with pytest.raises(ValueError, match="tuples of 3"):
        k.launch([x, y, 1.0, 4], mx.gpu(0), (1, 1), (4, 1, 1))


def test_a_cpu_context_or_array_raises():
    x = mx.nd.zeros((4,), ctx=mx.cpu())
    k = _kernel()
    with pytest.raises(ValueError, match="needs a gpu context"):
        k.launch([x, x, 1.0, 4], mx.cpu(), (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match=r"is on cpu\(0\), the launch on "
                                          r"cuda:0"):
        k.launch([x, x, 1.0, 4], mx.gpu(0), (1, 1, 1), (4, 1, 1))


def test_scalars_convert_to_the_signature_types():
    k = _kernel("float a, int n, __half h, __nv_bfloat16 b, int64_t big, "
                "uint8_t u")
    vals = k._values([2, 7.0, 1.5, -2.0, 2 ** 40, 255], torch.device("cuda"))
    assert vals[0].value == 2.0 and vals[1].value == 7
    assert vals[2].value == 0x3E00 and vals[3].value == 0xC000
    assert vals[4].value == 2 ** 40 and vals[5].value == 255
    with pytest.raises(TypeError, match="must be a number"):
        k._values([True, 1, 1.0, 1.0, 1, 1], torch.device("cuda"))


def test_pallas_module_raises_and_points_to_cuda_module():
    for cls in (rtc.PallasModule, rtc.PallasKernel):
        with pytest.raises(RuntimeError, match="CudaModule"):
            cls()
        with pytest.raises(RuntimeError, match="only on a TPU"):
            cls(lambda x_ref, o_ref: None, out_like=0)


# ---------------------------------------------------------------------------
# the compiler, its cache, and no fallback
# ---------------------------------------------------------------------------
def test_a_missing_nvrtc_raises_and_names_where_it_looked(tmp_path,
                                                          monkeypatch):
    empty = tmp_path / "cuda"
    monkeypatch.setattr(_nvrtc, "_nvrtc", None)
    monkeypatch.setattr(_nvrtc, "CACHE_DIR", tmp_path / "rtc")
    monkeypatch.setattr(_nvrtc, "nvrtc_search_dirs",
                        lambda: [empty / "lib64", empty / "nvrtc"])
    src = 'extern "C" __global__ void k(float *y) { y[0] = 1.f; }'
    with pytest.raises(RuntimeError, match="libnvrtc not found") as err:
        rtc.CudaModule(src)
    assert str(empty / "lib64") in str(err.value)
    assert str(empty / "nvrtc") in str(err.value)
    assert not (tmp_path / "rtc").exists()


def test_default_search_covers_the_three_places(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/toolkits/cuda-12")
    dirs = [str(d) for d in _nvrtc.nvrtc_search_dirs()]
    assert dirs[0] == "/toolkits/cuda-12/lib64"
    assert dirs[1].endswith("nvidia/cuda_nvrtc/lib")
    assert dirs[2] == "/usr/local/cuda/lib64"


def test_the_cache_key_covers_source_options_and_exports():
    key = _nvrtc.cache_key("src", ("--a",), ("k<float>",))
    assert len(key) == 64
    assert key == _nvrtc.cache_key("src", ("--a",), ("k<float>",))
    assert key != _nvrtc.cache_key("src2", ("--a",), ("k<float>",))
    assert key != _nvrtc.cache_key("src", ("--b",), ("k<float>",))
    assert key != _nvrtc.cache_key("src", ("--a",), ())
    assert _nvrtc.CACHE_DIR == ROOT / "build" / "rtc"
    assert "--gpu-architecture=sm_90a" in _nvrtc.default_options()


def test_a_cached_cubin_loads_without_nvrtc(tmp_path, monkeypatch):
    monkeypatch.setattr(_nvrtc, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(_nvrtc, "nvrtc", lambda: pytest.fail("compiled"))
    src, exports = "template <class T> __global__ void k(T *y) {}", \
        ("k<float>",)
    key = _nvrtc.cache_key(src, _nvrtc.default_options(), exports)
    (tmp_path / f"{key}.cubin").write_bytes(b"\x7fELF-cubin")
    (tmp_path / f"{key}.json").write_text('{"k<float>": "_Z1kIfEvPT_"}')
    mod = rtc.CudaModule(src, exports=exports)
    k = mod.get_kernel("k<float>", "float *y")
    assert k._symbol == "_Z1kIfEvPT_" and k.name == "k<float>"
    assert mod.get_kernel("plain_c", "float *y")._symbol == "plain_c"


def test_nothing_loads_at_import():
    code = ("import incubator_mxnet_tpu_torch as mx\n"
            "from incubator_mxnet_tpu_torch.ops import _nvrtc, rtc_kernels\n"
            "print(_nvrtc._nvrtc, _nvrtc._libcuda, rtc_kernels._modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None None {}"


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(5, 9).astype(np.float32), ctx=mx.cpu())
    b = mx.nd.array(rs.randn(5, 9).astype(np.float32), ctx=mx.cpu())
    before = dict(rtc.launches)
    np.testing.assert_array_equal(rtc_kernels.scale(x, 2.5).asnumpy(),
                                  x.asnumpy() * np.float32(2.5))
    np.testing.assert_array_equal(rtc_kernels.saxpy(x, b, -0.5).asnumpy(),
                                  x.asnumpy() * np.float32(-0.5)
                                  + b.asnumpy())
    np.testing.assert_array_equal(rtc_kernels.first_row(x).asnumpy(),
                                  x.asnumpy()[0])
    y = mx.nd.zeros((5, 9), ctx=mx.cpu())
    rtc_kernels.softmax_ce_fwd(x, y)
    e = np.exp(x.asnumpy() - x.asnumpy().max(1, keepdims=True))
    np.testing.assert_allclose(y.asnumpy(), e / e.sum(1, keepdims=True),
                               rtol=1e-6, atol=1e-7)
    dx = mx.nd.zeros((5, 9), ctx=mx.cpu())
    labels = mx.nd.array(np.array([0, 8, 3, 9, -1]), ctx=mx.cpu())
    rtc_kernels.softmax_ce_bwd(labels, y, dx)
    want = y.asnumpy().copy()
    want[[0, 1, 2], [0, 8, 3]] -= 1.0             # 9 and -1: out of range
    np.testing.assert_array_equal(dx.asnumpy(), want)
    assert dict(rtc.launches) == before
    with pytest.raises(ValueError, match="shapes"):
        rtc_kernels.saxpy(x, b.reshape(9, 5), 1.0)


@pytest.mark.parametrize("call", ["fwd_y", "bwd_dx", "bwd_label"])
def test_softmax_ce_wrappers_refuse_mismatched_shapes(call):
    """The kernels index every array by the logits' rows and row length: a
    smaller output or label array raises before any launch."""
    x = mx.nd.zeros((4, 9), ctx=mx.cpu())
    short = mx.nd.zeros((3, 9), ctx=mx.cpu())
    labels = mx.nd.zeros((4,), ctx=mx.cpu(), dtype="int32")
    before = dict(rtc.launches)
    with pytest.raises(ValueError, match="differ|labels"):
        if call == "fwd_y":
            rtc_kernels.softmax_ce_fwd(x, short)
        elif call == "bwd_dx":
            rtc_kernels.softmax_ce_bwd(labels, x, short)
        else:
            rtc_kernels.softmax_ce_bwd(labels[:3], x, x.copy())
    assert dict(rtc.launches) == before


def test_kernel_sources_are_the_five_of_the_slice():
    assert sorted(p.name for p in rtc_kernels.RTC_SRC.glob("*.cu")) == [
        "first_row.cu", "saxpy.cu", "scale.cu", "softmax_ce.cu"]
    assert sorted(rtc_kernels.KERNELS) == [
        "first_row", "saxpy", "scale", "softmax_ce_bwd", "softmax_ce_fwd"]
    for spec in rtc_kernels.KERNELS.values():
        rtc.parse_signature(spec.signature)
        src = (rtc_kernels.RTC_SRC / f"{spec.source}.cu").read_text()
        assert spec.lookup.split("<")[0] in src


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def test_axpy_example_on_card(cuda_ctx):
    source = r"""
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }"""
    module = mx.rtc.CudaModule(source)
    axpy = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=cuda_ctx)
    y = mx.nd.zeros((10,), ctx=cuda_ctx)
    n0 = rtc.launches["axpy"]
    axpy.launch([x, y, 3.0], cuda_ctx, (1, 1, 1), (10, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), np.full(10, 3.0, np.float32))
    assert rtc.launches["axpy"] == n0 + 1


@pytest.mark.parametrize("n", [1, 1000, 262_147])
def test_elementwise_kernels_match_plain_on_card(cuda_ctx, n):
    rs = np.random.RandomState(n)
    x = mx.nd.array(rs.randn(n).astype(np.float32), ctx=cuda_ctx)
    b = mx.nd.array(rs.randn(n).astype(np.float32), ctx=cuda_ctx)
    counts = {k: rtc.launches[k] for k in ("scale", "saxpy")}
    got = rtc_kernels.scale(x, 2.5)
    assert torch.equal(got.as_torch(),
                       rtc_kernels.scale_reference(x.as_torch(), 2.5))
    got = rtc_kernels.saxpy(x, b, 1.7)
    assert torch.equal(got.as_torch(), rtc_kernels.saxpy_reference(
        x.as_torch(), b.as_torch(), 1.7))
    assert {k: rtc.launches[k] - counts[k] for k in counts} == {
        "scale": 1, "saxpy": 1}


def test_first_row_matches_plain_on_card(cuda_ctx):
    x = mx.nd.array(np.random.RandomState(1).randn(37, 1029).astype(
        np.float32), ctx=cuda_ctx)
    assert torch.equal(rtc_kernels.first_row(x).as_torch(),
                       rtc_kernels.first_row_reference(x.as_torch()))


@pytest.mark.parametrize("shape", [(5, 7), (64, 50257), (3, 4099),
                                   (8, 100003)])
def test_softmax_ce_kernels_match_plain_on_card(cuda_ctx, shape):
    rs = np.random.RandomState(shape[1])
    x = mx.nd.array((4 * rs.randn(*shape)).astype(np.float32), ctx=cuda_ctx)
    labels = rs.randint(0, shape[1], (shape[0],)).astype(np.int32)
    labels[0] = -1                                  # out of range: no one
    lab = mx.nd.array(labels, ctx=cuda_ctx)
    y = mx.nd.zeros(shape, ctx=cuda_ctx)
    rtc_kernels.softmax_ce_fwd(x, y)
    want = rtc_kernels.softmax_ce_fwd_reference(x.as_torch())
    torch.testing.assert_close(y.as_torch(), want, rtol=1e-5, atol=0)
    dx = mx.nd.zeros(shape, ctx=cuda_ctx)
    rtc_kernels.softmax_ce_bwd(lab, y, dx)
    assert torch.equal(dx.as_torch(), rtc_kernels.softmax_ce_bwd_reference(
        lab.as_torch(), y.as_torch()))
    rtc_kernels.softmax_ce_bwd(lab, y, dx, "add")
    assert torch.equal(dx.as_torch(), 2 * rtc_kernels.softmax_ce_bwd_reference(
        lab.as_torch(), y.as_torch()))


def _view(buf, offset, shape):
    """An NDArray over ``buf`` from float ``offset`` on: its 16-byte
    alignment phase is ``offset % 4`` when ``buf``'s storage is aligned."""
    n = int(np.prod(shape))
    return mx.nd.NDArray(buf[offset:offset + n].view(shape))


# the longest resident row (58,061 floats within an H100's 232,448 bytes),
# the shortest streamed one, and a row over twice as long
@pytest.mark.parametrize("shape", [(4, 58061), (4, 58062), (8, 100003)])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (2, 1)])
@pytest.mark.parametrize("req", ["write", "add"])
def test_softmax_ce_fwd_rows_at_every_phase_on_card(cuda_ctx, shape, offsets,
                                                    req):
    """Both branches of the forward (the row held in shared memory, or
    streamed: ``softmax_ce_fwd_plan``) on views of x and y at offsets of
    0-3 floats, x and y at one phase (16-byte loads and stores) or at two
    (scalar stores), by ``req``: within 1e-5 of each probability."""
    rs = np.random.RandomState(shape[1] + offsets[0])
    n = shape[0] * shape[1]
    xb = torch.from_numpy((4 * rs.randn(n + 4)).astype(np.float32)).cuda()
    yb = torch.from_numpy(rs.rand(n + 4).astype(np.float32)).cuda()
    x, y = _view(xb, offsets[0], shape), _view(yb, offsets[1], shape)
    yb0 = yb.clone()
    rtc_kernels.softmax_ce_fwd(x, y, req)
    want = rtc_kernels.softmax_ce_fwd_reference(x.as_torch())
    if req == "add":
        want = _view(yb0, offsets[1], shape).as_torch() + want
    torch.testing.assert_close(y.as_torch(), want, rtol=1e-5, atol=0)
    around = [slice(0, offsets[1]), slice(offsets[1] + n, n + 4)]
    assert all(torch.equal(yb[s], yb0[s]) for s in around)
    plan = rtc_kernels.softmax_ce_fwd_plan(
        shape[1], rtc_kernels.smem_optin(xb.device))
    assert plan.resident == (shape[1] <= 58061)


@pytest.mark.parametrize("shape", [(5, 7), (3, 4099), (4, 50257)])
@pytest.mark.parametrize("req", ["write", "add"])
def test_softmax_ce_fwd_streams_with_no_dynamic_shared_memory_on_card(
        cuda_ctx, shape, req):
    """A launch of the kernel itself at ``CudaKernel.launch``'s default
    of no dynamic shared memory takes the streamed branch at any row
    length: its reductions and barriers are static shared memory, which
    is the 192 bytes the plan counts beside a resident row."""
    import ctypes

    rs = np.random.RandomState(shape[1])
    x = mx.nd.array((4 * rs.randn(*shape)).astype(np.float32), ctx=cuda_ctx)
    y0 = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
    y = mx.nd.NDArray(y0.clone())
    k = rtc_kernels.kernel("softmax_ce_fwd")
    k.launch([x, y, shape[1], 2 if req == "add" else 1], cuda_ctx,
             (shape[0], 1, 1), (512, 1, 1))
    want = rtc_kernels.softmax_ce_fwd_reference(x.as_torch())
    if req == "add":
        want = y0 + want
    torch.testing.assert_close(y.as_torch(), want, rtol=1e-5, atol=0)
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuFuncGetAttribute.argtypes = [ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int, ctypes.c_void_p]
    static = ctypes.c_int()
    assert lib.cuFuncGetAttribute(          # CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES
        ctypes.byref(static), 1, k._functions[cuda_ctx.device_id]) == 0
    assert static.value == rtc_kernels._ROW_STATIC


@pytest.mark.parametrize("row", [100, 4099, 100003])
def test_softmax_ce_fwd_keeps_torch_nan_pattern_and_repeats_on_card(
        cuda_ctx, row):
    """Rows of -inf give NaN, rows with some -inf give 0 there, a +inf
    gives NaN, as torch.softmax; a second launch is bit-identical."""
    rs = np.random.RandomState(row)
    x = torch.from_numpy((3 * rs.randn(5, row)).astype(np.float32))
    x[0] = -float("inf")
    x[1, ::3] = -float("inf")
    x[2, :row // 2] = -float("inf")
    x[3, 7] = float("inf")
    xg = mx.nd.array(x.numpy(), ctx=cuda_ctx)
    y = mx.nd.zeros(x.shape, ctx=cuda_ctx)
    rtc_kernels.softmax_ce_fwd(xg, y)
    want = torch.softmax(x, -1)
    got = y.as_torch().cpu()
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got.nan_to_num(), want.nan_to_num(),
                               rtol=1e-5, atol=0)
    again = mx.nd.zeros(x.shape, ctx=cuda_ctx)
    rtc_kernels.softmax_ce_fwd(xg, again)
    assert torch.equal(again.as_torch().nan_to_num(),
                       y.as_torch().nan_to_num())


@pytest.mark.parametrize("n", [1, 3, 4097, 1_000_003])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 0), (2, 3)])
def test_scale_on_views_at_every_phase_on_card(cuda_ctx, n, offsets):
    """``scale`` on views of larger buffers, x and y at one alignment phase
    (a scalar head, 16-byte quads, a scalar tail) or at two (single
    floats), into a view and into a new array: bit for bit ``x *
    factor``, nothing written around the view."""
    rs = np.random.RandomState(n)
    xb = torch.from_numpy(rs.randn(n + 4).astype(np.float32)).cuda()
    yb = torch.full((n + 4,), 7.0, device="cuda")
    x, y = _view(xb, offsets[0], (n,)), _view(yb, offsets[1], (n,))
    n0 = rtc.launches["scale"]
    rtc_kernels.kernel("scale").launch([x, y, -1.75, n], cuda_ctx,
                                       *rtc_kernels.scale_plan(n))
    assert rtc.launches["scale"] == n0 + 1
    want = rtc_kernels.scale_reference(x.as_torch(), -1.75)
    assert torch.equal(y.as_torch(), want)
    outside = torch.cat([yb[:offsets[1]], yb[offsets[1] + n:]])
    assert torch.equal(outside, torch.full_like(outside, 7.0))
    assert torch.equal(rtc_kernels.scale(x, -1.75).as_torch(), want)


# a, b and out: all aligned, all at one phase (1 or 3), and each operand
# alone at offset 1 or 3 with the other two aligned
SAXPY_OFFSETS = [(0, 0, 0), (1, 1, 1), (3, 3, 3), (1, 0, 0), (0, 1, 0),
                 (0, 0, 1), (3, 0, 0), (0, 3, 0), (0, 0, 3), (1, 3, 0)]


@pytest.mark.parametrize("n", [1, 3, 5, 4099, 1_000_003])
@pytest.mark.parametrize("offsets", SAXPY_OFFSETS)
def test_saxpy_on_views_at_every_phase_on_card(cuda_ctx, n, offsets):
    """``saxpy`` on views of larger buffers, a, b and out at one alignment
    phase (a scalar head, 16-byte quads, a scalar tail) or at several
    (single floats): bit for bit ``a * alpha + b`` (two roundings, no
    FMA), into a view and into a new array; nothing written around the
    view."""
    rs = np.random.RandomState(n + 7 * offsets[0] + 3 * offsets[1])
    ab = torch.from_numpy(rs.randn(n + 4).astype(np.float32)).cuda()
    bb = torch.from_numpy(rs.randn(n + 4).astype(np.float32)).cuda()
    ob = torch.full((n + 4,), 7.0, device="cuda")
    a, b, out = (_view(buf, off, (n,))
                 for buf, off in zip((ab, bb, ob), offsets))
    n0 = rtc.launches["saxpy"]
    rtc_kernels.kernel("saxpy").launch([a, b, out, -1.3, n], cuda_ctx,
                                       *rtc_kernels.saxpy_plan(n))
    assert rtc.launches["saxpy"] == n0 + 1
    want = rtc_kernels.saxpy_reference(a.as_torch(), b.as_torch(), -1.3)
    assert torch.equal(out.as_torch(), want)
    outside = torch.cat([ob[:offsets[2]], ob[offsets[2] + n:]])
    assert torch.equal(outside, torch.full_like(outside, 7.0))
    assert torch.equal(rtc_kernels.saxpy(a, b, -1.3).as_torch(), want)
    assert rtc.launches["saxpy"] == n0 + 2


@pytest.mark.parametrize("grid,block", [((1, 1, 1), (1, 1, 1)),
                                        ((3, 1, 1), (32, 1, 1))])
@pytest.mark.parametrize("offsets", [(1, 1, 1), (3, 3, 3), (1, 0, 0)])
def test_saxpy_is_right_on_any_grid_on_card(cuda_ctx, grid, block,
                                            offsets):
    """The kernel itself on grids far smaller than ``saxpy_plan``'s, down
    to one thread: the grid-stride loops cover every element."""
    n = 4099
    rs = np.random.RandomState(offsets[0])
    bufs = [torch.from_numpy(rs.randn(n + 4).astype(np.float32)).cuda()
            for _ in range(2)] + [torch.full((n + 4,), 7.0, device="cuda")]
    a, b, out = (_view(buf, off, (n,)) for buf, off in zip(bufs, offsets))
    rtc_kernels.kernel("saxpy").launch([a, b, out, 0.375, n], cuda_ctx,
                                       grid, block)
    assert torch.equal(out.as_torch(), rtc_kernels.saxpy_reference(
        a.as_torch(), b.as_torch(), 0.375))


@pytest.mark.parametrize("grid,block", [((1, 1, 1), (1, 1, 1)),
                                        ((2, 1, 1), (1, 1, 1)),
                                        ((3, 1, 1), (32, 1, 1))])
@pytest.mark.parametrize("offsets", [(1, 1), (3, 3), (1, 0)])
def test_scale_is_right_on_any_grid_on_card(cuda_ctx, grid, block, offsets):
    """The kernel itself on grids far smaller than ``scale_plan``'s, down
    to one thread: the grid-stride loops cover the head, the quads and the
    tail (or the single floats) whatever the grid."""
    n = 4099
    rs = np.random.RandomState(offsets[0])
    xb = torch.from_numpy(rs.randn(n + 4).astype(np.float32)).cuda()
    yb = torch.full((n + 4,), 7.0, device="cuda")
    x, y = _view(xb, offsets[0], (n,)), _view(yb, offsets[1], (n,))
    rtc_kernels.kernel("scale").launch([x, y, 0.375, n], cuda_ctx, grid,
                                       block)
    assert torch.equal(y.as_torch(),
                       rtc_kernels.scale_reference(x.as_torch(), 0.375))


def test_softmax_ce_custom_op_backward_on_card(cuda_ctx):
    """The backward runs in torch's autograd thread, where the kernel's
    launch must still find torch's context."""
    rs = np.random.RandomState(2)
    logits = (3 * rs.randn(16, 333)).astype(np.float32)
    labels = rs.randint(0, 333, (16,)).astype(np.int32)
    x = mx.nd.array(logits, ctx=cuda_ctx)
    x.attach_grad()
    n0 = {k: rtc.launches[k] for k in ("softmax_ce_fwd<float>",
                                       "softmax_ce_bwd<float>")}
    with mx.autograd.record():
        y = mx.nd.Custom(x, mx.nd.array(labels, ctx=cuda_ctx),
                         op_type="softmax_ce_rtc")
    y.backward()
    want = torch.softmax(torch.from_numpy(logits), -1)
    want[torch.arange(16), torch.from_numpy(labels).long()] -= 1
    np.testing.assert_allclose(x.grad.asnumpy(), want.numpy(), atol=1e-6)
    assert {k: rtc.launches[k] - n0[k] for k in n0} == {
        "softmax_ce_fwd<float>": 1, "softmax_ce_bwd<float>": 1}


def test_large_dynamic_shared_memory_and_graph_capture_on_card(cuda_ctx):
    source = r"""
    extern "C" __global__ void stage(const float *x, float *y, int n) {
        extern __shared__ float buf[];
        for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            y[i] = buf[n - 1 - i];
    }"""
    k = mx.rtc.CudaModule(source).get_kernel(
        "stage", "const float *x, float *y, int n")
    n = 30_000                                   # 120 KB of shared memory
    x = mx.nd.array(np.arange(n, dtype=np.float32), ctx=cuda_ctx)
    y = mx.nd.zeros((n,), ctx=cuda_ctx)
    k.launch([x, y, n], cuda_ctx, (1, 1, 1), (256, 1, 1), shared_mem=4 * n)
    np.testing.assert_array_equal(y.asnumpy(), np.arange(n)[::-1])
    # captured in a CUDA graph and replayed
    z = mx.nd.zeros((n,), ctx=cuda_ctx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        k.launch([y, z, n], cuda_ctx, (1, 1, 1), (256, 1, 1),
                 shared_mem=4 * n)
    graph.replay()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(z.asnumpy(), np.arange(n))


def test_a_compile_error_carries_the_nvrtc_log(cuda_ctx):
    with pytest.raises(RuntimeError, match="NVRTC could not compile") as e:
        mx.rtc.CudaModule('extern "C" __global__ void k() { undeclared; }')
    assert "undeclared" in str(e.value)
