"""Port parity: ``mx.nd``, ``NDArray`` and the registered kernel ops.

Every case feeds the same numpy inputs (drawn from a seed) to the JAX
package's ``mx.nd`` and to the port's, the port on the CPU, and compares
values, dtypes and gradients. Tolerances: 1e-5 relative and 1e-6 absolute
for fp32 values and gradients (both compute in fp32 and differ only in
the order of sums); integer and comparison results exactly.
``mx.nd.flash_attention`` runs the JAX package's XLA reference at these
sizes and the port's plain version of the kernels; ``fused_conv_bn`` runs
the JAX Pallas kernels in interpret mode (as ``tests/test_pallas_conv.py``
does) and the port's plain versions.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ndarray import NDArray

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ints(seed, *shape, lo=-1, hi=5):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.float32)


def _same(got, want, **tol):
    """Port NDArray ``got`` equals JAX NDArray ``want`` in shape, dtype and
    values."""
    want_np = want.asnumpy()
    assert got.shape == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if np.issubdtype(want_np.dtype, np.floating):
        np.testing.assert_allclose(got.asnumpy(), want_np, **(tol or TOL))
    else:
        np.testing.assert_array_equal(got.asnumpy(), want_np)


X34 = _rand(0, 3, 4)
POS34 = _rand(1, 3, 4, lo=0.2, hi=2.0)
# (case id, op name, numpy inputs, kwargs, differentiable)
OPS = [
    ("abs", "abs", [X34], {}, True),
    ("negative", "negative", [X34], {}, True),
    ("sign", "sign", [X34], {}, True),
    ("square", "square", [X34], {}, True),
    ("sqrt", "sqrt", [POS34], {}, True),
    ("exp", "exp", [X34], {}, True),
    ("log", "log", [POS34], {}, True),
    ("tanh", "tanh", [X34], {}, True),
    ("clip", "clip", [X34], dict(a_min=-0.4, a_max=0.5), True),
    ("sum", "sum", [X34], dict(axis=1), True),
    ("sum_all", "sum", [X34], {}, True),
    ("sum_axis", "sum_axis", [X34], dict(axis=0, keepdims=True), True),
    ("sum_exclude", "sum", [_rand(2, 2, 3, 4)], dict(axis=1, exclude=True),
     True),
    ("mean", "mean", [X34], dict(axis=(0, 1), keepdims=True), True),
    ("prod", "prod", [POS34], dict(axis=0), True),
    ("nansum", "nansum", [np.where(X34 > 0.5, np.nan, X34)], dict(axis=1),
     False),
    ("nanprod", "nanprod", [np.where(POS34 > 1.5, np.nan, POS34)],
     dict(axis=0), False),
    ("max", "max", [X34], dict(axis=1), True),
    ("max_axis", "max_axis", [X34], dict(axis=0), True),
    ("min", "min", [X34], dict(axis=1, keepdims=True), True),
    ("min_axis", "min_axis", [X34], {}, True),
    ("argmax", "argmax", [X34], dict(axis=1), False),
    ("argmin", "argmin", [X34], dict(axis=0), False),
    ("norm", "norm", [X34], {}, True),
    ("norm_axis", "norm", [X34], dict(axis=1, keepdims=True), True),
    ("cumsum", "cumsum", [X34], dict(axis=1), True),
    ("logsumexp", "logsumexp", [X34], dict(axis=1), True),
    ("reshape", "reshape", [X34], dict(shape=(4, 3)), True),
    ("transpose", "transpose", [_rand(3, 2, 3, 4)], dict(axes=(2, 0, 1)),
     True),
    ("expand_dims", "expand_dims", [X34], dict(axis=1), True),
    ("squeeze", "squeeze", [_rand(4, 3, 1, 4)], dict(axis=1), True),
    ("broadcast_to", "broadcast_to", [_rand(5, 1, 4)], dict(shape=(3, 4)),
     True),
    ("cast", "cast", [X34 * 4], dict(dtype="int32"), False),
    ("relu", "relu", [X34], {}, True),
    ("sigmoid", "sigmoid", [X34], {}, True),
    ("softmax", "softmax", [X34], dict(axis=-1), True),
    ("log_softmax", "log_softmax", [X34], dict(axis=0), True),
    ("dot", "dot", [X34, _rand(6, 4, 5)], {}, True),
    ("dot_transpose_b", "dot", [X34, _rand(7, 5, 4)],
     dict(transpose_b=True), True),
    ("batch_dot", "batch_dot", [_rand(8, 2, 3, 4), _rand(9, 2, 4, 5)], {},
     True),
    ("take", "take", [_rand(10, 5, 4), np.array([[0, 4, 7], [-2, 1, 1]],
                                                np.float32)], {}, True),
    ("take_axis1", "take", [X34, np.array([3, 0, 0], np.float32)],
     dict(axis=1), True),
    ("pick", "pick", [X34, np.array([0, 3, 1], np.float32)], {}, True),
    ("pick_axis0", "pick", [X34, np.array([2, 0, 1, 1], np.float32)],
     dict(axis=0, keepdims=True), True),
]
for _name in ("elemwise_add", "broadcast_add", "add", "elemwise_sub",
              "broadcast_sub", "subtract", "elemwise_mul", "broadcast_mul",
              "multiply", "broadcast_maximum", "maximum",
              "broadcast_minimum", "minimum", "broadcast_hypot"):
    OPS.append((_name, _name, [X34, _rand(11, 1, 4)], {}, True))
for _name in ("elemwise_div", "broadcast_div", "divide"):
    OPS.append((_name, _name, [X34, POS34], {}, True))
for _name in ("broadcast_power", "power"):
    OPS.append((_name, _name, [POS34, X34], {}, True))
for _name in ("broadcast_mod", "mod"):
    OPS.append((_name, _name, [X34 * 5, _rand(12, 3, 4, lo=0.5, hi=2.0)],
                {}, True))
for _name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    for _prefix in ("", "broadcast_"):
        OPS.append((_prefix + _name, _prefix + _name,
                    [_ints(13, 3, 4), _ints(14, 1, 4)], {}, False))


def _run(pkg_mx, name, arrays, kwargs, grad_w=None):
    """``pkg_mx.nd.<name>`` on ``arrays``; with ``grad_w``, also the
    gradients of ``sum(out * grad_w)`` with respect to the float inputs
    (index inputs of take/pick get none)."""
    xs = [pkg_mx.nd.array(a) for a in arrays]
    n_float = 1 if name in ("take", "pick") else len(xs)
    if grad_w is None:
        return getattr(pkg_mx.nd, name)(*xs, **kwargs), []
    for x in xs[:n_float]:
        x.attach_grad()
    with pkg_mx.autograd.record():
        out = getattr(pkg_mx.nd, name)(*xs, **kwargs)
        head = (out * pkg_mx.nd.array(grad_w)).sum()
    head.backward()
    return out, [x.grad for x in xs[:n_float]]


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_nd_op_matches_jax(case):
    _, name, arrays, kwargs, differentiable = case
    want, _ = _run(jmx, name, arrays, kwargs)
    got, _ = _run(mx, name, arrays, kwargs)
    _same(got, want)
    if differentiable:
        w = _rand(99, *want.shape)
        _, want_grads = _run(jmx, name, arrays, kwargs, w)
        _, got_grads = _run(mx, name, arrays, kwargs, w)
        for g, wg in zip(got_grads, want_grads):
            _same(g, wg)


SCALAR_OPS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_power_scalar",
              "_rpower_scalar", "_mod_scalar", "_rmod_scalar",
              "_maximum_scalar", "_minimum_scalar", "_equal_scalar",
              "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
              "_lesser_scalar", "_lesser_equal_scalar"]


@pytest.mark.parametrize("name", SCALAR_OPS)
def test_scalar_op_matches_jax(name):
    x = _rand(15, 3, 4, lo=1.0, hi=4.0)       # no 0 as an int divisor
    x[0, 0] = 1.5                              # hits the comparisons' tie
    for dtype, scalar in (("float32", 1.5), ("int32", 2)):
        _same(mx.nd.invoke_op(name, mx.nd.array(x, dtype=dtype),
                              scalar=scalar),
              jmx.nd.invoke_op(name, jmx.nd.array(x, dtype=dtype),
                               scalar=scalar))


def test_nd_one_hot_and_fully_connected_match_jax():
    idx = np.array([0, 3, -1, 7, 2], np.float32)       # -1 and 7: off rows
    _same(mx.nd.one_hot(mx.nd.array(idx), 5, on_value=2.0, off_value=-1.0),
          jmx.nd.one_hot(jmx.nd.array(idx), 5, on_value=2.0,
                         off_value=-1.0))
    x, w, b = _rand(20, 2, 3, 4), _rand(21, 5, 12), _rand(22, 5)
    _same(mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w),
                               mx.nd.array(b), num_hidden=5),
          jmx.nd.FullyConnected(jmx.nd.array(x), jmx.nd.array(w),
                                jmx.nd.array(b), num_hidden=5))
    _same(mx.nd.FullyConnected(mx.nd.array(x[:, 0]), mx.nd.array(w[:, :4]),
                               flatten=False),
          jmx.nd.FullyConnected(jmx.nd.array(x[:, 0]),
                                jmx.nd.array(w[:, :4]), flatten=False))


# ---------------------------------------------------------------------------
# NDArray methods and in-place operators: each case runs the same code on
# either package's arrays
# ---------------------------------------------------------------------------
def _setitem(x, nd):
    x[1, ::2] = 7.0
    x[0] = nd.array(np.arange(4, dtype=np.float32))
    return x


def _inplace(x, nd):
    x += 1
    x -= nd.array(_rand(30, 3, 4))
    x *= 2.5
    x /= 4
    return x


METHODS = [
    ("reshape_magic_0", lambda x, nd: x.reshape(0, -1, 2)),
    ("reshape_tuple", lambda x, nd: x.reshape((2, 6))),
    ("T", lambda x, nd: x.T),
    ("swapaxes", lambda x, nd: x.swapaxes(0, 1)),
    ("expand_squeeze", lambda x, nd: x.expand_dims(0).squeeze()),
    ("flatten", lambda x, nd: x.expand_dims(2).flatten()),
    ("broadcast_to", lambda x, nd: x[0:1].broadcast_to((5, 4))),
    ("slice", lambda x, nd: x.slice((1, None), (3, None), (1, 2))),
    ("slice_negative_step", lambda x, nd: x.slice((None, 3), (None, 0),
                                                  (None, -1))),
    ("nd_slice", lambda x, nd: nd.slice(x, begin=(0, 1), end=(2, 3))),
    ("slice_axis", lambda x, nd: x.slice_axis(1, 1, -1)),
    ("nd_slice_axis", lambda x, nd: nd.slice_axis(x, axis=0, begin=1,
                                                  end=None)),
    ("take_wrap", lambda x, nd: x.take(nd.array([5, -1]), mode="wrap")),
    ("getitem_basic", lambda x, nd: x[1:, ::2]),
    ("getitem_int", lambda x, nd: x[2]),
    ("getitem_ndarray", lambda x, nd: x[nd.array([2, 0])]),
    ("setitem", _setitem),
    ("inplace", _inplace),
    ("scalar_reverse", lambda x, nd: (2 - x) * (3 / (x + 2)) + 2 ** x),
    ("mod_scalar", lambda x, nd: (x * 5) % 3 + 7 % (x + 2)),
    ("pow_scalar", lambda x, nd: (x + 2) ** 1.5),
    ("neg_abs", lambda x, nd: abs(-x)),
    ("matmul", lambda x, nd: x @ nd.array(_rand(31, 4, 2))),
    ("compare_scalar", lambda x, nd: (x > 0) + (x <= 0.25) + (x == x)),
    ("compare_array", lambda x, nd: (x < x.T.T * 0.5) * 1.0),
    ("reductions", lambda x, nd: x.sum(axis=0) + x.mean(axis=0)
     + x.max(axis=0) + x.min(axis=0) + x.prod(axis=0)),
    ("arg_reductions", lambda x, nd: x.argmax(axis=1) + x.argmin(axis=1)),
    ("norm", lambda x, nd: x.norm(axis=0)),
    ("elementwise", lambda x, nd: (x.abs().sqrt() + x.square()
                                   + x.exp().log() + x.sigmoid()
                                   + x.tanh() + x.relu() + x.clip(-.2, .3))),
    ("softmaxes", lambda x, nd: x.softmax() + x.log_softmax(axis=0)),
    ("one_hot", lambda x, nd: (x * 3 + 2).one_hot(4)),
    ("astype", lambda x, nd: (x * 10).astype("int32") + 1),
    ("copy", lambda x, nd: x.copy()),
    ("copyto", lambda x, nd: x.copyto(nd.zeros((3, 4)))),
    ("reshape_like", lambda x, nd: x.reshape_like(nd.zeros((4, 3)))),
    ("stop_gradient", lambda x, nd: nd.stop_gradient(x) * 2),
]


@pytest.mark.parametrize("case", METHODS, ids=[c[0] for c in METHODS])
def test_ndarray_method_matches_jax(case):
    _, fn = case
    x = _rand(32, 3, 4)
    _same(fn(mx.nd.array(x), mx.nd), fn(jmx.nd.array(x), jmx.nd))


def test_ndarray_basics():
    a = mx.nd.array([[1.5, 2.0], [3.0, 4.0]])
    assert a.shape == (2, 2) and a.ndim == 2 and a.size == 4
    assert len(a) == 2 and a.ctx == mx.cpu() and a.context == mx.cpu()
    assert a.stype == "default" and str(a.dtype) == "float32"
    assert float(a[0, 0]) == 1.5 and int(a[1, 1]) == 4
    assert a.sum().asscalar() == 10.5 and a[1, 0].item() == 3.0
    assert bool(mx.nd.array([1.0])) and not bool(mx.nd.array([0.0]))
    with pytest.raises(ValueError):
        bool(a)
    with pytest.raises(ValueError):
        a.asscalar()
    np.testing.assert_array_equal(np.asarray(a), a.asnumpy())
    a.wait_to_read()
    mx.nd.waitall()
    assert "NDArray (2, 2) @cpu(0)" in repr(a)
    assert a.as_in_context(mx.cpu()) is a
    assert a.astype("float32", copy=False) is a
    e = mx.nd.eye(3, 4, k=1)
    np.testing.assert_array_equal(e.asnumpy(), np.eye(3, 4, 1))
    np.testing.assert_array_equal(mx.nd.arange(5).asnumpy(),
                                  jmx.nd.arange(5).asnumpy())
    np.testing.assert_array_equal(
        mx.nd.arange(1, 4, 0.5, repeat=2).asnumpy(),
        jmx.nd.arange(1, 4, 0.5, repeat=2).asnumpy())
    for fn in ("zeros", "ones", "empty"):
        got = getattr(mx.nd, fn)((2, 3), dtype="int32")
        want = getattr(jmx.nd, fn)((2, 3), dtype="int32")
        _same(got, want)
    _same(mx.nd.full((2,), 7.5), jmx.nd.full((2,), 7.5))
    _same(mx.nd.ones_like(a), jmx.nd.ones_like(jmx.nd.array(a.asnumpy())))
    with pytest.raises(TypeError, match="mx.nd.array"):
        NDArray(np.zeros(2))


def test_x32_narrowing():
    f64 = np.arange(4, dtype=np.float64)
    i64 = np.arange(4, dtype=np.int64)
    for pkg in (mx, jmx):
        assert str(pkg.nd.array(f64).dtype) == "float32"
        assert str(pkg.nd.array(i64).dtype) == "int32"
        assert str(pkg.nd.array([1, 2]).dtype) == "int32"
        assert str(pkg.nd.array([1.0, 2.0]).dtype) == "float32"
        assert str(pkg.nd.array(f64, dtype="float64").dtype) == "float32"
        assert str(pkg.nd.zeros((2,), dtype="int64").dtype) == "int32"
        assert str(pkg.nd.array(f64).astype("float64").dtype) == "float32"
        ints = pkg.nd.array(i64)
        assert str(ints.sum().dtype) == "int32"        # torch would say int64
        assert str(ints.argmax().dtype) == "float32"
        assert str(ints.mean().dtype) == "float32"
    assert mx.nd.array(i64).as_torch().dtype == torch.int32


def test_views_are_values():
    x = mx.nd.array(_rand(40, 4, 6))
    base = x.asnumpy().copy()
    views = [x.reshape(6, 4), x.T, x[1:3], x[:, ::2], x.slice_axis(1, 0, 3),
             x.expand_dims(0), x.flatten(), x.astype("float32"), x[2]]
    for v in views:
        assert v.as_torch().untyped_storage().data_ptr() != \
            x.as_torch().untyped_storage().data_ptr()
        v[:] = 100.0
        v += 1
    np.testing.assert_array_equal(x.asnumpy(), base)
    # and the other way: writing the base leaves an earlier result alone
    r = x.reshape(24)
    x[0, 0] = -5.0
    assert r.asnumpy()[0] == base[0, 0]
    # the JAX package's documented semantics agree
    jx = jmx.nd.array(base)
    jr = jx.reshape(24)
    jr[:] = 100.0
    np.testing.assert_array_equal(jx.asnumpy(), base)


@pytest.mark.parametrize("dtype,scalar,want", [
    ("bfloat16", 2.0, "bfloat16"), ("float16", 3, "float16"),
    ("int32", 2, "int32"), ("int32", 2.5, "float32"),
    ("float32", 2, "float32")])
def test_scalar_ops_keep_the_array_dtype(dtype, scalar, want):
    """Through the ``_*_scalar`` ops a Python scalar never widens a float
    array (bf16 * 2.0 stays bf16); an int array meets a float scalar as
    float32, as in jnp; comparisons give the array's own dtype."""
    x = np.array([1.0, 2.0, 3.0])
    for pkg in (mx, jmx):
        a = pkg.nd.array(x, dtype=dtype)
        for out in (a + scalar, scalar + a, a - scalar, scalar - a,
                    a * scalar, scalar * a):
            assert str(out.dtype).replace("torch.", "") == want, (pkg, out)
        assert str((a > scalar).dtype).replace("torch.", "") == dtype


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("kind", ["single", "list", "dict"])
def test_save_load_across_packages(tmp_path, direction, kind):
    f = _rand(50, 3, 4)
    i = np.arange(6, dtype=np.int32).reshape(2, 3)
    src, dst = (mx, jmx) if direction == "port_to_jax" else (jmx, mx)
    data = {"single": src.nd.array(f),
            "list": [src.nd.array(f), src.nd.array(i)],
            "dict": {"w": src.nd.array(f), "idx": src.nd.array(i)}}[kind]
    path = str(tmp_path / "params.bin")
    src.nd.save(path, data)
    with open(path, "rb") as fh:
        assert fh.read(8) == b"MXTPU001"
    got = dst.nd.load(path)
    if kind == "single":
        got, data = [got], [data]
    elif kind == "dict":
        assert set(got) == {"w", "idx"}
        got, data = [got["w"], got["idx"]], [data["w"], data["idx"]]
    for g, d in zip(got, data):
        assert str(g.dtype) == str(d.dtype).replace("torch.", "")
        np.testing.assert_array_equal(g.asnumpy(), d.asnumpy())


def test_default_context_is_the_card():
    with mx.gpu(0):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device resolves")
        for make in (lambda: mx.nd.array([1.0]), lambda: mx.nd.zeros((2,)),
                     lambda: mx.nd.ones((2,)), lambda: mx.nd.arange(3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_naive_engine_runs_ops():
    from incubator_mxnet_tpu_torch.config import config

    config.set("MXTPU_ENGINE_TYPE", "naive")
    try:
        x = mx.nd.array(X34)
        np.testing.assert_allclose((x * 2 + 1).asnumpy(), X34 * 2 + 1)
    finally:
        config.unset("MXTPU_ENGINE_TYPE")


def test_bf16_sum_accumulates_in_fp32():
    x = np.full((4096,), 1.0 + 2 ** -7, np.float32)
    got = mx.nd.array(x, dtype="bfloat16").sum()
    want = jmx.nd.array(x, dtype="bfloat16").sum()
    assert str(got.dtype) == "torch.bfloat16"
    assert got.asscalar() == float(np.asarray(want.asnumpy(), np.float32))


# ---------------------------------------------------------------------------
# the registered kernel ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,with_lengths", [(True, False),
                                                 (False, True)],
                         ids=["causal", "lengths"])
def test_nd_flash_attention_matches_jax(causal, with_lengths):
    b, h, t, d = 2, 3, 16, 32
    q, k, v, g = (_rand(60 + i, b, h, t, d) for i in range(4))
    lens = np.array([16, 9], np.int32)
    outs = {}
    for pkg in (jmx, mx):
        arrs = [pkg.nd.array(a) for a in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        kw = dict(causal=causal)
        if with_lengths:
            lens_nd = pkg.nd.array(lens)
            kw["lengths"] = lens_nd._data if pkg is jmx else lens_nd
        with pkg.autograd.record():
            out = pkg.nd.flash_attention(*arrs, **kw)
        out.backward(pkg.nd.array(g))
        outs[pkg] = [out] + [a.grad for a in arrs]
    for got, want in zip(outs[mx], outs[jmx]):
        _same(got, want, rtol=1e-5, atol=1e-5)


def test_invoke_op_fused_conv_bn_matches_jax_interpret():
    rs = np.random.RandomState(70)
    x = rs.randn(2, 6, 6, 8).astype(np.float32)
    w = (rs.randn(3, 3, 8, 16) * 0.3).astype(np.float32)
    a = (rs.rand(8) + 0.5).astype(np.float32)
    bb = (rs.randn(8) * 0.5).astype(np.float32)
    dy = rs.randn(2, 6, 6, 16).astype(np.float32)
    res = {}
    for pkg, extra in ((jmx, dict(interpret=True)), (mx, {})):
        xs = [pkg.nd.array(v) for v in (x, w, a, bb)]
        for t in xs:
            t.attach_grad()
        with pkg.autograd.record():
            y, s, ss = pkg.nd.invoke_op("fused_conv_bn", *xs, stride=1,
                                        pad=1, relu=True, **extra)
        y.backward(pkg.nd.array(dy))
        res[pkg] = [y, s, ss] + [t.grad for t in xs]
    for got, want in zip(res[mx], res[jmx]):
        scale = max(1.0, float(np.abs(want.asnumpy()).max()))
        _same(got, want, rtol=0, atol=1e-5 * scale)
