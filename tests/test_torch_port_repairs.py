"""Port parity: three places where the port refused or differed from what
the JAX package does, each held against the JAX package.

- ``lazy_update``: ``optimizer.create("sgd"/"adam", lazy_update=True)``
  is taken, and with dense gradients a step equals the JAX optimizer's.
- The default initializer: ``initialize()`` with no ``init`` draws
  ``Uniform(0.07)``, a parameter's own ``init`` (the fused ResNet's conv
  weights: ``"xavier"``) wins over the global one, and
  ``initializer.create(None)`` is ``Uniform(0.07)``. RNG draws differ
  between the packages, so the distributions are compared: the bound
  and the variance of each tensor.
- NAG at momentum 0 in ``SPMDTrainer`` runs as plain SGD, as
  ``optax.sgd(lr, momentum=0.0, nesterov=True)`` does.
- A float ``lengths`` (BERT's ``valid_length``) in ``flash_attention`` is
  truncated toward zero to int32, as the reference's ``astype(int32)``:
  the card path took only integers before.
- Reductions: ``sum``/``mean``/``nansum`` over ``axis=()`` return the
  input, and integer sums and products widen as jnp's do.
- Gathers outside ``[0, n)`` (the sparse softmax cross entropy, the
  ``embedding`` op, the ``Embedding`` layer): an index in ``[-n, -1]``
  counts from the end, one outside ``[-n, n)`` reads NaN.
- Negative slice steps in ``NDArray`` indexing, read and written.
- Complex arrays: complex128 narrows to complex64 at creation and on an
  op's result (x32), and complex64 survives ``array``, ``asnumpy``,
  ``asscalar``, ``save``/``load`` and dtype names whole; the port dropped
  the imaginary part, or refused the dtype name.
- ``astype`` from a float to an integer type saturates as ``cast`` does
  (the port wrapped), and a 64-bit integer type narrows first (the port
  saturated in int64, then wrapped into int32).
- Integer ``%``, ``mod``, ``fmod``, ``remainder`` and ``floor_divide`` by
  zero give the JAX package's values (the port raised on the CPU; on the
  card the division gave undefined bits).
- ``backward`` of a head recorded from inputs that carry no gradient
  returns and leaves every gradient as it was (the port raised); one
  computed outside ``record()`` still raises.
- A second ``backward`` through a freed graph raises in MXNet's words,
  naming ``retain_graph=True`` (the JAX package computes the gradient
  again; the port keeps the refusal, which saves holding every graph).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.gluon.model_zoo.vision import fused_resnet as jfr
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, initializer, optimizer, parallel
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import FusedResNetV1

TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# lazy_update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name, hyper", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
])
def test_lazy_update_is_taken_and_a_dense_step_matches_jax(name, hyper):
    rs = np.random.RandomState(0)
    w0 = rs.randn(6, 5).astype(np.float32)
    grads = [rs.randn(6, 5).astype(np.float32) for _ in range(2)]
    jo = jopt.create(name, lazy_update=True, **hyper)
    po = optimizer.create(name, lazy_update=True, **hyper)
    assert po.lazy_update is True
    jw = jmx.nd.array(w0)
    jstate = jo.create_state(0, jw)
    pw = torch.from_numpy(w0.copy())
    pstate = po.create_state(0, pw)
    for g in grads:
        jstate = jo.update(0, jw, jmx.nd.array(g), jstate)
        po.update(0, pw, torch.from_numpy(g.copy()), pstate)
    np.testing.assert_allclose(pw.numpy(), jw.asnumpy(), **TOL)
    # the default is lazy, as in the JAX package
    assert optimizer.create(name).lazy_update is True


# ---------------------------------------------------------------------------
# the default initializer
# ---------------------------------------------------------------------------
def test_create_none_is_uniform_007_as_in_jax():
    want = jinit.create(None)
    got = initializer.create(None)
    assert type(got).__name__ == type(want).__name__ == "Uniform"
    assert got.scale == want.scale == 0.07
    assert isinstance(initializer.create("uniform"), initializer.Uniform)


def _bound_and_var(arr):
    return float(np.abs(arr).max()), float(arr.var())


def test_initialize_without_init_draws_uniform_007():
    """A Dense layer drawn with no ``init``: its weight lies within
    [-0.07, 0.07] with the uniform variance 0.07^2/3, as the JAX
    package's, and its bias is 0 in both."""
    mx.random.seed(0)
    net = gluon.nn.Dense(256, in_units=512).initialize(ctx=mx.cpu())
    jmx.random.seed(0)
    jnet = jgluon.nn.Dense(256, in_units=512)
    jnet.initialize()
    want = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    got = {n: p.detach().numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want)
    var = 0.07 ** 2 / 3
    for arr in (got["weight"], want["weight"]):
        bound, v = _bound_and_var(arr)
        assert bound <= 0.07 and bound > 0.069
        assert abs(v - var) < 0.03 * var
    assert not got["bias"].any() and not want["bias"].any()


def test_own_xavier_wins_over_the_global_uniform():
    """The fused ResNet declares its conv weights ``init="xavier"``: under
    ``initialize("uniform")`` they keep Xavier's bound and variance (most
    of them wider than 0.07 here) in the port as in the JAX package, while
    the classifier, which declares none, takes Uniform(0.07)."""
    layers, channels = [1, 1, 1, 1], [8, 16, 32, 64, 128]
    mx.random.seed(1)
    net = FusedResNetV1(layers, channels, classes=10).initialize(
        "uniform", ctx=mx.cpu())
    jmx.random.seed(1)
    jnet = jfr.FusedResNetV1(layers, channels, classes=10)
    jnet.initialize(init="uniform")
    jnet(jmx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    want = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    got = {n: p.detach().numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want)
    convs = [n for n in got if n.endswith("_weight") and "conv" in n]
    assert len(convs) == 1 + 3 * 4 + 4
    wide = 0
    for n in convs:
        shape = got[n].shape
        hw = int(np.prod(shape[2:]))
        bound = np.sqrt(3.0 / ((shape[0] * hw + shape[1] * hw) / 2.0))
        wide += bound > 0.08
        for arr in (got[n], want[n]):
            b, v = _bound_and_var(arr)
            assert b <= bound * (1 + 1e-6), (n, b, bound)
            assert bound <= 0.08 or b > 0.07, (n, b, bound)
            if arr.size >= 2000:
                assert abs(v - bound ** 2 / 3) < 0.15 * bound ** 2 / 3, n
    assert wide >= 5
    for arr in (got["output.weight"], want["output.weight"]):
        b, v = _bound_and_var(arr)
        assert 0.06 < b <= 0.07


# ---------------------------------------------------------------------------
# NAG at momentum 0 in SPMDTrainer
# ---------------------------------------------------------------------------
VOCAB, B, T = 37, 8, 8


def test_spmd_nag_without_momentum_is_plain_sgd_as_in_jax():
    np.random.seed(4)
    jmx.random.seed(4)
    jnet = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                       num_layers=2, max_length=48, dropout=0.0)
    jnet.initialize(init="xavier")
    jnet(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    net = load_jax_params(
        get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                num_layers=2, max_length=48, dropout=0.0), params,
        ctx=mx.cpu())
    jce, ce = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        gluon.loss.SoftmaxCrossEntropyLoss()
    hyper = {"learning_rate": 0.1, "momentum": 0.0}
    jst = jparallel.SPMDTrainer(jnet, lambda lg, lb: jce(lg, lb).mean(),
                                "nag", dict(hyper))
    st = parallel.SPMDTrainer(net, lambda lg, lb: ce(lg, lb).mean(), "nag",
                              dict(hyper))
    rs = np.random.RandomState(5)
    for _ in range(2):
        x = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
        y = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
        np.testing.assert_allclose(float(st.step(x, y)),
                                   float(jst.step(x, y)), rtol=1e-4,
                                   atol=1e-5)
    st.sync_to_net()
    for n, p in tensors_of(net).items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jst.params[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# pick, cast and norm against the JAX package's ops on the same numpy
# inputs: out-of-range picks read jnp.take_along_axis's fill, float ->
# integer casts saturate, and the norm of the flattened array keeps one axis
# ---------------------------------------------------------------------------
from incubator_mxnet_tpu.ops import tensor as jtensor  # noqa: E402

from incubator_mxnet_tpu_torch.ops import tensor as ptensor  # noqa: E402


def _jax_np(fn, *args, **kw):
    import jax.numpy as jnp

    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


# (axis, index) over x of shape (3, 4): past both ends, the negative ends
# in range, and the edges
PICKS = [(-1, [-5, 4, -1]), (-1, [100, -4, 3]), (0, [-4, 3, -1, 0]),
         (0, [-3, 2, 7, -100])]


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8],
                         ids=["float32", "int32", "uint8"])
@pytest.mark.parametrize("axis, index", PICKS)
def test_pick_out_of_range_reads_the_reference_fill(dtype, axis, index):
    x = np.arange(3 * 4).reshape(3, 4).astype(dtype)
    idx = np.array(index, np.float32)
    want = _jax_np(jtensor.pick, x, idx, axis=axis)
    got = ptensor.pick(torch.from_numpy(x), torch.from_numpy(idx), axis=axis)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # keepdims keeps the picked axis as 1
    want_k = _jax_np(jtensor.pick, x, idx, axis=axis, keepdims=True)
    got_k = ptensor.pick(torch.from_numpy(x), torch.from_numpy(idx),
                         axis=axis, keepdims=True)
    np.testing.assert_array_equal(got_k.numpy(), want_k)


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_cast_float_to_int_saturates_as_the_reference(dtype):
    v = np.array([-3.7, -1.2, 2.5, 300.0, np.nan, np.inf, -np.inf, 255.9,
                  -0.5, 1e10, -1e10, 2.0 ** 31], np.float32)
    want = _jax_np(jtensor.cast, v, dtype=np.dtype(dtype))
    got = ptensor.cast(torch.from_numpy(v), dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "uint8":
        np.testing.assert_array_equal(got.numpy()[:4], [0, 0, 2, 255])


def test_norm_keepdims_without_axis_is_shape_1_as_the_reference():
    x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    want = _jax_np(jtensor.norm, x, keepdims=True)
    got = ptensor.norm(torch.from_numpy(x), keepdims=True)
    assert tuple(got.shape) == want.shape == (1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # over an axis, and without keepdims, the shapes still agree
    for kw in (dict(), dict(axis=1, keepdims=True)):
        want = _jax_np(jtensor.norm, x, **kw)
        got = ptensor.norm(torch.from_numpy(x), **kw)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_pick_out_of_range_on_the_card_raises_no_device_assert():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.arange(12, dtype=torch.float32, device="cuda").view(3, 4)
    idx = torch.tensor([-9.0, 2.0, 40.0], device="cuda")
    got = ptensor.pick(x, idx)
    torch.cuda.synchronize()
    assert torch.isnan(got[0]) and got[1] == 6 and torch.isnan(got[2])


# ---------------------------------------------------------------------------
# flash_attention with float lengths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interpret", [True, None],
                         ids=["pallas_interpret", "dense_below_crossover"])
def test_flash_attention_float_lengths_truncate_as_the_reference(interpret):
    """Non-integer float lengths through the JAX ``flash_attention`` op
    (its Pallas kernel in interpret mode, and its dense path below
    ``MXTPU_FLASH_MIN_SEQ``) and through the port's CPU path: the same
    output, the int32 truncation's, with and without a gradient."""
    import jax.numpy as jnp

    from incubator_mxnet_tpu.ops.pallas_attention import (
        flash_attention as jflash)
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    rs = np.random.RandomState(21)
    q, k, v = (rs.randn(3, 2, 16, 32).astype(np.float32) for _ in range(3))
    lens = np.array([9.7, 1.2, 16.0], np.float32)
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)),
                             jnp.asarray(lens), interpret=interpret))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    as_int = fa.flash_attention(tq, tk, tv, torch.tensor([9, 1, 16]))
    assert torch.equal(got, as_int)
    tq.requires_grad_(True)
    with_grad = fa.flash_attention(tq, tk, tv, torch.from_numpy(lens))
    assert torch.equal(with_grad.detach(), got)


# ---------------------------------------------------------------------------
# reductions over no axis, and the types of integer sums and products
# ---------------------------------------------------------------------------
def _nd_pair(x):
    with mx.cpu():
        return jmx.nd.array(x, dtype=x.dtype.name), \
            mx.nd.array(x, dtype=x.dtype.name)


# MXNet itself read ``axis=()`` as every axis; the JAX package (jnp) reads
# it as none, and the port follows the JAX package
@pytest.mark.parametrize("name", ["sum", "mean", "nansum"])
@pytest.mark.parametrize("axis", [(), []], ids=["tuple", "list"])
@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.uint8],
                         ids=["float32", "int8", "uint8"])
def test_reduce_over_no_axis_returns_the_input_as_the_reference(name, axis,
                                                                dtype):
    x = (np.arange(12).reshape(4, 3) % 5 + 4).astype(dtype)
    jx, px = _nd_pair(x)
    # jnp.nansum refuses a list for axis: the reference is read with ()
    want = getattr(jmx.nd, name)(jx, axis=() if name == "nansum"
                                 else axis).asnumpy()
    got = getattr(mx.nd, name)(px, axis=axis).asnumpy()
    assert got.shape == want.shape == x.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sum", "nansum", "prod", "nanprod"])
@pytest.mark.parametrize("dtype, want_dtype", [
    (np.int8, np.int32), (np.uint8, np.uint32), (np.bool_, np.int32),
    (np.int32, np.int32)], ids=["int8", "uint8", "bool", "int32"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_integer_sums_and_products_widen_as_the_reference(name, dtype,
                                                          want_dtype, axis):
    x = np.array([[4, 5, 6, 7], [3, 1, 2, 5]]).astype(dtype)
    jx, px = _nd_pair(x)
    want = getattr(jmx.nd, name)(jx, axis=axis).asnumpy()
    got = getattr(mx.nd, name)(px, axis=axis).asnumpy()
    assert want.dtype == want_dtype
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "prod" and dtype == np.int8 and axis == 1:
        assert got[0] == 840                # 4*5*6*7: int8 would wrap


# ---------------------------------------------------------------------------
# gathers outside [0, n): wrap [-n, -1], NaN outside [-n, n)
# ---------------------------------------------------------------------------
EMBED_IDS = [-5, -4, -1, 0, 3, 4, 9]


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_embedding_out_of_range_reads_the_reference_fill(dtype):
    from incubator_mxnet_tpu_torch.ops import nn as pnn

    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array(EMBED_IDS).astype(dtype)
    with mx.cpu():
        want = jmx.nd.Embedding(jmx.nd.array(ids, dtype=dtype),
                                jmx.nd.array(w), input_dim=4,
                                output_dim=3).asnumpy()
    got = pnn.embedding(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[0, 5, 6]]).all() and (got[2] == w[3]).all()


def test_embedding_layer_out_of_range_reads_the_reference_fill():
    jmx.random.seed(2)
    jemb = jgluon.nn.Embedding(4, 3)
    jemb.initialize()
    ids = np.array([EMBED_IDS, EMBED_IDS[::-1]], np.int32)
    want = jemb(jmx.nd.array(ids, dtype="int32")).asnumpy()
    emb = gluon.nn.Embedding(4, 3).initialize(ctx=mx.cpu())
    emb.set_param("weight", torch.from_numpy(
        jemb.weight.data().asnumpy().copy()))
    got = emb(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    # the gradient reaches the rows the wrapped ids read, none of the rest
    x = torch.from_numpy(ids)
    emb(x).nan_to_num(0.0).sum().backward()
    counts = np.bincount([i % 4 for i in EMBED_IDS if -4 <= i < 4] * 2,
                         minlength=4)
    np.testing.assert_array_equal(emb.weight.grad[:, 0].numpy(), counts)


@pytest.mark.parametrize("labels", [[-4, -1, 2, 3, 0], [1, -3, 7, -9, 2]])
def test_softmax_ce_sparse_labels_out_of_range_as_the_reference(labels):
    rs = np.random.RandomState(9)
    pred = rs.randn(5, 3).astype(np.float32)
    lab = np.array(labels, np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(
        jmx.nd.array(pred), jmx.nd.array(lab)).asnumpy()
    got = gluon.loss.SoftmaxCrossEntropyLoss()(
        torch.from_numpy(pred), torch.from_numpy(lab)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and not np.isnan(want).all()


def test_gathers_out_of_range_on_the_card_raise_no_device_assert():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from incubator_mxnet_tpu_torch.ops import nn as pnn

    w = torch.arange(12, dtype=torch.float32, device="cuda").view(4, 3)
    rows = pnn.embedding(torch.tensor([-1, 9], device="cuda"), w)
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        torch.zeros(2, 3, device="cuda"), torch.tensor([-1.0, 5.0],
                                                       device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(rows[0], w[3]) and torch.isnan(rows[1]).all()
    assert torch.isfinite(loss[0]) and torch.isnan(loss[1])


# ---------------------------------------------------------------------------
# negative slice steps in NDArray indexing
# ---------------------------------------------------------------------------
NEG_KEYS = [np.s_[::-1], np.s_[:, ::-2], np.s_[1, ::-1, 1:3],
            np.s_[..., ::-3], np.s_[::-1, None, 3:0:-2],
            np.s_[:, [0, 2], ::-1], np.s_[5:-7:-1], np.s_[0, 4:1:-1]]


@pytest.mark.parametrize("key", NEG_KEYS, ids=[str(k) for k in NEG_KEYS])
def test_negative_slice_steps_read_and_write_as_the_reference(key):
    x = np.arange(2 * 5 * 4).reshape(2, 5, 4).astype(np.float32)
    jx, px = _nd_pair(x)
    want = jx[key].asnumpy()
    got = px[key].asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    val = np.arange(want.size, dtype=np.float32).reshape(want.shape) + 100
    for v in (val, 7.0):
        jx, px = _nd_pair(x)
        jx[key] = jmx.nd.array(v) if isinstance(v, np.ndarray) else v
        with mx.cpu():
            px[key] = mx.nd.array(v) if isinstance(v, np.ndarray) else v
        np.testing.assert_array_equal(px.asnumpy(), jx.asnumpy())


def test_negative_slice_step_gradient_reaches_the_read_elements():
    with mx.cpu():
        a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        a.attach_grad()
        with mx.autograd.record():
            y = (a[:, ::-2] * mx.nd.array([[1.0, 2.0], [3.0, 4.0]])).sum()
        y.backward()
    np.testing.assert_array_equal(a.grad.asnumpy(),
                                  [[2.0, 0.0, 1.0], [4.0, 0.0, 3.0]])


# ---------------------------------------------------------------------------
# complex arrays
# ---------------------------------------------------------------------------
_Z = np.array([[1 + 2j, 3 - 1j], [-0.5j, 2.25 + 0j]])


def test_complex_array_narrows_to_complex64_and_asnumpy_keeps_it_whole():
    want = jmx.nd.array(_Z)
    got = mx.nd.array(_Z, ctx=mx.cpu())
    assert want.dtype == got.dtype == np.complex64
    assert got.asnumpy().dtype == np.complex64
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(got.asnumpy(), _Z.astype(np.complex64))


@pytest.mark.parametrize("name", ["complex64", "complex128", np.complex64,
                                  np.complex128])
def test_complex_dtype_names_as_the_reference(name):
    want = jmx.nd.zeros((2,), dtype=name)
    got = mx.nd.zeros((2,), ctx=mx.cpu(), dtype=name)
    assert got.dtype == want.dtype == np.complex64
    cast = mx.nd.array(_Z.real, ctx=mx.cpu()).astype(name)
    assert cast.dtype == jmx.nd.array(_Z.real).astype(name).dtype


def test_complex_scalar_and_op_results():
    with mx.cpu():
        a = mx.nd.array(_Z)
        b = a * a + 1.0
    ja = jmx.nd.array(_Z)
    jb = ja * ja + 1.0
    assert b.dtype == jb.dtype == np.complex64
    np.testing.assert_allclose(b.asnumpy(), jb.asnumpy(), rtol=1e-6)
    got, want = a[0, 0].asscalar(), ja[0, 0].asscalar()
    assert got == want == 1 + 2j and np.asarray(got).dtype == np.complex64


def test_complex_save_load_round_trip_as_the_reference(tmp_path):
    for pkg, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        f = str(tmp_path / f"{pkg.__name__}.params")
        pkg.nd.save(f, {"z": pkg.nd.array(_Z, **kw),
                        "x": pkg.nd.array(_Z.real, **kw)})
        back = pkg.nd.load(f, **kw)
        assert back["z"].dtype == np.complex64
        np.testing.assert_array_equal(back["z"].asnumpy(),
                                      _Z.astype(np.complex64))
    # a file either package saved loads in the other
    back = mx.nd.load(str(tmp_path / "incubator_mxnet_tpu.params"),
                      ctx=mx.cpu())
    np.testing.assert_array_equal(back["z"].asnumpy(),
                                  _Z.astype(np.complex64))


# ---------------------------------------------------------------------------
# astype saturates; integer division by zero; the recorded head with no
# gradient; the second backward
# ---------------------------------------------------------------------------
_SATURATE = np.array([-300.7, -100.2, 200.3, 300.6, 1e10, -1e10, np.nan,
                      np.inf, -np.inf], np.float32)


@pytest.mark.parametrize("entry", ["astype", "np_astype", "cast"])
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32", "int64"])
def test_astype_saturates_as_the_reference(entry, dtype):
    def run(pkg, **kw):
        if entry == "cast":
            return pkg.nd.cast(pkg.nd.array(_SATURATE, **kw), dtype=dtype)
        if entry == "np_astype":
            return pkg.np.array(_SATURATE, **kw).astype(dtype)
        return pkg.nd.array(_SATURATE, **kw).astype(dtype)

    want, got = run(jmx), run(mx, ctx=mx.cpu())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


_DIVIDEND = np.array([5, -5, 0, 7, -7, 6, -6, 0], np.int64)
_DIVISOR = np.array([0, 0, 0, 3, 2, -4, 4, -3], np.int64)
_DIVISIONS = {
    "operator": lambda nd, a, b: a % b,
    "broadcast_mod": lambda nd, a, b: nd.broadcast_mod(a, b),
    "scalar": lambda nd, a, b: a % 0,
    "reversed_scalar": lambda nd, a, b: 7 % b,
    "reversed_negative_scalar": lambda nd, a, b: -7 % b,
    "nd_floor_divide": lambda nd, a, b: nd.floor_divide(a, b),
    "np_mod": lambda nd, a, b: nd.np.mod(a, b),
    "np_remainder": lambda nd, a, b: nd.np.remainder(a, b),
    "np_fmod": lambda nd, a, b: nd.np.fmod(a, b),
    "np_floor_divide": lambda nd, a, b: nd.np.floor_divide(a, b),
}


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("entry", sorted(_DIVISIONS))
def test_integer_division_by_zero_as_the_reference(entry, dtype):
    def run(pkg, **kw):
        a = pkg.nd.array(_DIVIDEND, dtype=dtype, **kw)
        b = pkg.nd.array(_DIVISOR, dtype=dtype, **kw)
        nd = pkg.nd
        nd.np = pkg.np
        return _DIVISIONS[entry](nd, a, b)

    want, got = run(jmx), run(mx, ctx=mx.cpu())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _null_head(pkg, recorded, **kw):
    """``x`` attached with ``grad_req="null"``, ``y`` attached ``"write"``
    and the head ``sum(x * x)``, recorded or not."""
    x = pkg.nd.array(np.arange(1.0, 5.0, dtype=np.float32), **kw)
    x.attach_grad(grad_req="null")
    y = pkg.nd.array(np.ones(4, np.float32), **kw)
    y.attach_grad()
    if recorded:
        with pkg.autograd.record():
            return x, y, (x * x).sum()
    return x, y, (x * x).sum()


def test_backward_of_a_recorded_head_with_no_gradient_returns():
    jx, jy, jhead = _null_head(jmx, True)
    jhead.backward()
    x, y, head = _null_head(mx, True, ctx=mx.cpu())
    y.grad._data.fill_(7.0)
    head.backward()
    mx.autograd.backward([head])
    np.testing.assert_array_equal(x.grad.asnumpy(), jx.grad.asnumpy())
    np.testing.assert_array_equal(y.grad.asnumpy(), np.full(4, 7.0))


def test_backward_of_a_head_computed_outside_record_still_raises():
    words = "cannot differentiate a head that was not computed under"
    for pkg, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        _, _, head = _null_head(pkg, False, **kw)
        with pytest.raises(ValueError, match=words):
            head.backward()


def test_a_second_backward_names_retain_graph():
    x = mx.nd.array(np.arange(1.0, 4.0, dtype=np.float32), ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 4.0, 6.0])
    # MXNet's words (torch's own message names retain_graph=True too, but
    # not the graph that is gone)
    words = ("not in a computational graph.*you need to pass "
             "retain_graph=True to backward")
    with pytest.raises(RuntimeError, match=words):
        y.backward()
    with pytest.raises(RuntimeError, match=words):
        mx.autograd.grad(y, [x])
    # the JAX package computes the same gradient again
    jx = jmx.nd.array(np.arange(1.0, 4.0, dtype=np.float32))
    jx.attach_grad()
    with jmx.autograd.record():
        jy = (jx * jx).sum()
    jy.backward()
    jy.backward()
    np.testing.assert_array_equal(jx.grad.asnumpy(), x.grad.asnumpy())
