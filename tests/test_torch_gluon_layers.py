"""Port parity: the gluon layer set against the JAX package's, on the CPU.

Each layer is built in both packages with the same arguments, run once on
each side (deferred shapes filled by that forward), and the JAX
package's parameters carried into the port with ``load_jax_params``.
Inputs and head gradients are drawn with numpy from a seed. Compared:
outputs, input gradients and parameter gradients of ``sum(out * g)``, and
BatchNorm's running statistics. Random initializers are compared by
their statistics, never by their draws (JAX threefry and numpy differ).

Tolerances (relative L2 error, fp32 on both sides; the two differ only in
the order of sums): ``RTOL`` 1e-5 for convolutions, dense layers,
BatchNorm and the pools' gradients; max pooling's outputs are equal;
average pooling ``RTOL``. The same for the layers of slice 21: the
activation blocks, ``Lambda``/``HybridLambda``, ``GroupNorm``,
``InstanceNorm``, ``RMSNorm``, the transposed convolutions and
``ReflectionPad2D``.
"""

import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.parallel.spmd import collect_params as jcollect

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, initializer, parallel
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.block import DeferredInitializationError
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

RTOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


def _assert_rel(name, got, want, tol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    assert np.shape(got) == np.shape(want), (name, np.shape(got),
                                             np.shape(want))
    # -inf where a max pool's window holds padding only: equal on both
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.asarray(got)[~finite], want[~finite])
    err = _rel(np.asarray(got)[finite], want[finite])
    assert err <= tol, f"{name}: relative L2 error {err} > {tol}"


def _jax_run(jnet, x, g, train):
    """Output, input gradient, parameter gradients and values of
    ``sum(out * g)`` through the JAX layer (training mode when
    ``train``)."""
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jautograd.record(train_mode=train):
        out = jnet(xj)
        loss = (out * jmx.nd.array(g)).sum()
    loss.backward()
    objs = jcollect(jnet)
    return dict(out=out.asnumpy(), dx=xj.grad.asnumpy(),
                grads={n: p.grad().asnumpy() for n, p in objs.items()
                       if p.grad_req != "null"},
                values={n: p.data().asnumpy() for n, p in objs.items()})


def _port_run(net, x, g, train):
    xt = torch.from_numpy(x).requires_grad_(True)
    with mx.autograd.record(train_mode=train):
        out = net(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return dict(out=out.detach().numpy(), dx=xt.grad.numpy(),
                grads={n: p.grad.numpy() for n, p in net.named_parameters()
                       if p.requires_grad},
                values={n: p.detach().numpy()
                        for n, p in net.named_parameters()})


def _pair(jnet, net, x, init="xavier"):
    """Both layers initialized and run once on ``x`` (deferred shapes
    filled), then the JAX parameters carried into the port."""
    jnet.initialize(init=init)
    jnet(jmx.nd.array(x))
    net.initialize(init, ctx=mx.cpu())
    with torch.no_grad():
        net(torch.from_numpy(x))
    params = {n: p.data().asnumpy() for n, p in jcollect(jnet).items()}
    load_jax_params(net, params, ctx=mx.cpu())
    return params


def _compare(jnet, net, x, train=False, seed=0, tol=RTOL):
    _pair(jnet, net, x)
    rs = np.random.RandomState(seed + 100)
    jout = jnet(jmx.nd.array(x)).asnumpy()
    g = rs.randn(*jout.shape).astype(np.float32)
    want = _jax_run(jnet, x, g, train)
    got = _port_run(net, x, g, train)
    _assert_rel("out", got["out"], want["out"], tol)
    _assert_rel("dx", got["dx"], want["dx"], tol)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for n in want["grads"]:
        _assert_rel(f"grad {n}", got["grads"][n], want["grads"][n], tol)
    return got, want


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
CONV_CASES = [
    # (ndim, channels, kernel, strides, padding, dilation, groups, bias,
    #  activation, input shape)
    (1, 6, 3, 1, 1, 1, 1, True, None, (2, 4, 11)),
    (1, 8, 5, 2, 2, 2, 2, False, "relu", (2, 4, 17)),
    (2, 8, 3, 1, 1, 1, 1, True, "relu", (2, 3, 9, 9)),
    (2, 6, (3, 1), (2, 1), (1, 0), (2, 1), 3, True, "tanh", (2, 6, 10, 7)),
    (2, 4, 1, 2, 0, 1, 1, False, None, (2, 8, 8, 8)),
    (3, 4, 3, 1, 1, 1, 2, True, "sigmoid", (1, 4, 5, 6, 5)),
    (3, 6, 2, 2, 0, (1, 2, 1), 1, False, None, (2, 3, 6, 7, 6)),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"conv{c[0]}d_{i}" for i, c in
                              enumerate(CONV_CASES)])
def test_conv_matches_jax(case):
    ndim, ch, k, s, p, d, groups, bias, act, shape = case
    cls = {1: "Conv1D", 2: "Conv2D", 3: "Conv3D"}[ndim]
    kw = dict(strides=s, padding=p, dilation=d, groups=groups,
              use_bias=bias, activation=act)
    jnet = getattr(jnn, cls)(ch, k, **kw)
    net = getattr(nn, cls)(ch, k, **kw)
    assert 0 in net.weight.shape            # in_channels from the input
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got, _ = _compare(jnet, net, x)
    assert net.weight.shape[1] == shape[1] // groups
    assert ("bias" in got["grads"]) == bias


def test_conv_declared_in_channels_and_channels_last_layouts():
    net = nn.Conv2D(8, 3, in_channels=4, groups=2)
    assert tuple(net.weight.shape) == (8, 2, 3, 3)
    with pytest.raises(NotImplementedError, match="NC"):
        nn.Conv2D(8, 3, layout="NHWC")


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
POOL_CASES = [
    ("MaxPool1D", dict(pool_size=3, strides=2, padding=1), (2, 3, 11)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 9)),
    ("MaxPool2D", dict(pool_size=2, ceil_mode=True), (2, 3, 7, 5)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=2, ceil_mode=True),
     (1, 2, 8, 9)),
    ("MaxPool3D", dict(pool_size=2, strides=(1, 2, 2)), (1, 2, 4, 6, 5)),
    ("AvgPool1D", dict(pool_size=2, padding=1), (2, 3, 9)),
    ("AvgPool1D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 10)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 9)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 9, 8)),
    ("AvgPool2D", dict(pool_size=2, ceil_mode=True), (2, 3, 7, 5)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True,
                       count_include_pad=False), (1, 2, 8, 8)),
    ("AvgPool3D", dict(pool_size=2, padding=1), (1, 2, 3, 4, 5)),
    ("GlobalMaxPool1D", {}, (2, 3, 7)),
    ("GlobalMaxPool2D", {}, (2, 3, 5, 6)),
    ("GlobalMaxPool3D", {}, (1, 2, 3, 4, 5)),
    ("GlobalAvgPool1D", {}, (2, 3, 7)),
    ("GlobalAvgPool2D", {}, (2, 3, 5, 6)),
    ("GlobalAvgPool3D", {}, (1, 2, 3, 4, 5)),
]


@pytest.mark.parametrize("cls, kw, shape", POOL_CASES,
                         ids=[f"{c[0]}_{i}" for i, c in
                              enumerate(POOL_CASES)])
def test_pool_matches_jax(cls, kw, shape):
    jnet, net = getattr(jnn, cls)(**kw), getattr(nn, cls)(**kw)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got, want = _compare(jnet, net, x)
    if "Max" in cls:
        np.testing.assert_array_equal(got["out"], want["out"])


def test_pooling_op_keeps_its_nhwc_path_and_refuses_unknown_types():
    x = torch.randn(2, 7, 7, 5)
    got = mx.ops.nn.pooling(x, (3, 3), stride=(2, 2), pad=(1, 1),
                            layout="NHWC")
    want = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="pool_type"):
        mx.ops.nn.pooling(x, pool_type="median")


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw, shape", [
    ({}, (2, 3, 4, 4)),
    ({"center": False, "scale": False}, (2, 3, 5)),
    ({"axis": 3, "epsilon": 1e-3}, (2, 3, 4, 6)),
    ({"in_channels": 4}, (8, 4)),
], ids=["nchw", "fixed", "axis_last", "2d"])
def test_batchnorm_matches_jax(train, kw, shape):
    jnet, net = jnn.BatchNorm(**kw), nn.BatchNorm(**kw)
    x = (np.random.RandomState(3).randn(*shape) * 2 + 1).astype(np.float32)
    params = _pair(jnet, net, x)
    # running statistics away from 0 and 1, so eval tells them apart
    rs = np.random.RandomState(4)
    for n in ("running_mean", "running_var"):
        params[n] = (np.abs(rs.randn(*params[n].shape)) + 0.5).astype(
            np.float32)
        jcollect(jnet)[n].set_data(jmx.nd.array(params[n]))
    load_jax_params(net, params, ctx=mx.cpu())
    g = rs.randn(*shape).astype(np.float32)
    want = _jax_run(jnet, x, g, train)
    got = _port_run(net, x, g, train)
    for k in ("out", "dx"):
        _assert_rel(k, got[k], want[k])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for n in want["grads"]:
        _assert_rel(f"grad {n}", got["grads"][n], want["grads"][n])
    for n in ("running_mean", "running_var"):
        _assert_rel(n, got["values"][n], want["values"][n])
        assert np.array_equal(got["values"][n], params[n]) != train, n


def test_batchnorm_running_stats_after_three_steps_match_jax():
    """Three training forwards at B=2 over a (2, 3) input: each channel's
    statistics come from two values, so the biased variance is half the
    unbiased one, and the running statistics move by MXNet's momentum
    (``running * 0.9 + batch * 0.1``), not PyTorch's. Both show: an update
    with the unbiased variance or torch's momentum convention misses by
    far more than the tolerance."""
    jnet, net = jnn.BatchNorm(), nn.BatchNorm()
    rs = np.random.RandomState(5)
    xs = [(rs.randn(2, 3) * 3).astype(np.float32) for _ in range(3)]
    _pair(jnet, net, xs[0])
    rm, rv = np.zeros(3), np.ones(3)
    for x in xs:
        with jautograd.record():
            jnet(jmx.nd.array(x))
        with mx.autograd.record():
            net(torch.from_numpy(x))
        rm = rm * 0.9 + x.mean(0) * 0.1
        rv = rv * 0.9 + x.var(0) * 0.1             # biased
    want = {n: p.data().asnumpy() for n, p in jcollect(jnet).items()}
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    for n, ref in (("running_mean", rm), ("running_var", rv)):
        _assert_rel(n, got[n], want[n])
        _assert_rel(n, got[n], ref)
    unbiased = np.ones(3)
    for x in xs:
        unbiased = unbiased * 0.9 + x.var(0, ddof=1) * 0.1
    assert _rel(unbiased, want["running_var"]) > 100 * RTOL
    torch_momentum = np.zeros(3)
    for x in xs:
        torch_momentum = torch_momentum * 0.1 + x.mean(0) * 0.9
    assert _rel(torch_momentum, want["running_mean"]) > 100 * RTOL


def test_batchnorm_in_bf16_keeps_bf16():
    """``cast("bfloat16")`` casts gamma, beta and the running statistics;
    a training forward takes bf16 in, gives bf16 out, and writes bf16
    statistics back (no fp32 promotion), close to the fp32 layer's."""
    x = np.random.RandomState(6).randn(4, 3, 5, 5).astype(np.float32)
    ref = nn.BatchNorm().initialize(ctx=mx.cpu())
    net = nn.BatchNorm().initialize(ctx=mx.cpu()).cast("bfloat16")
    with mx.autograd.record():
        want = ref(torch.from_numpy(x))
        got = net(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    _assert_rel("bf16 out", got, want.detach().numpy(), 2e-2)
    for n in ("running_mean", "running_var"):
        _assert_rel(n, getattr(net, n).float(),
                    getattr(ref, n).detach().numpy(), 2e-2)
    got.float().sum().backward()
    assert net.gamma.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Activation, Flatten, Dense
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "silu", "log_sigmoid",
                                 "mish"])
def test_activation_matches_jax(act):
    x = (np.random.RandomState(7).randn(3, 4, 5) * 3).astype(np.float32)
    _compare(jnn.Activation(act), nn.Activation(act), x)
    np.testing.assert_allclose(
        mx.nd.Activation(mx.nd.array(x, ctx=mx.cpu()),
                         act_type=act).asnumpy(),
        nn.Activation(act)(torch.from_numpy(x)).numpy(), rtol=0, atol=0)


def test_flatten_matches_jax():
    x = np.random.RandomState(8).randn(2, 3, 4, 5).astype(np.float32)
    got, _ = _compare(jnn.Flatten(), nn.Flatten(), x)
    assert got["out"].shape == (2, 60)


@pytest.mark.parametrize("kw, shape", [
    (dict(units=7, activation="relu"), (3, 2, 4, 5)),
    (dict(units=6, activation="tanh", flatten=False), (2, 3, 5)),
    (dict(units=5, use_bias=False), (4, 9)),
    (dict(units=4, in_units=6, activation="sigmoid"), (3, 6)),
], ids=["flatten_relu", "no_flatten", "no_bias", "in_units"])
def test_dense_matches_jax(kw, shape):
    net = nn.Dense(**kw)
    assert (0 in net.weight.shape) == ("in_units" not in kw)
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    _compare(jnn.Dense(**kw), net, x)
    in_units = math.prod(shape[1:]) if kw.get("flatten", True) \
        else shape[-1]
    assert tuple(net.weight.shape) == (kw["units"], in_units)


def test_dense_dtype_and_initializers():
    mx.random.seed(0)
    net = nn.Dense(3, dtype="bfloat16", weight_initializer="ones",
                   bias_initializer="zeros").initialize(ctx=mx.cpu())
    net(torch.ones(2, 4, dtype=torch.bfloat16))
    assert net.weight.dtype == torch.bfloat16
    assert torch.equal(net.weight, torch.ones(3, 4, dtype=torch.bfloat16))
    assert torch.equal(net.bias, torch.zeros(3, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# ops through mx.nd
# ---------------------------------------------------------------------------
def test_nd_ops_match_the_layers():
    rs = np.random.RandomState(10)
    x = rs.randn(2, 4, 6, 6).astype(np.float32)
    w = rs.randn(6, 2, 3, 3).astype(np.float32)
    gam, bet = rs.rand(4).astype(np.float32), rs.randn(4).astype(np.float32)
    with mx.cpu():
        nd = {k: mx.nd.array(v) for k, v in
              dict(x=x, w=w, g=gam, b=bet, m=np.zeros(4, np.float32),
                   v=np.ones(4, np.float32)).items()}
        conv = mx.nd.Convolution(nd["x"], nd["w"], kernel=(3, 3), pad=(1, 1),
                                 num_filter=6, num_group=2)
        pool = mx.nd.Pooling(nd["x"], kernel=(2, 2), pool_type="avg")
        out, mean, var = mx.nd.BatchNorm(nd["x"], nd["g"], nd["b"], nd["m"],
                                         nd["v"], training=True)
    jconv = jmx.nd.Convolution(jmx.nd.array(x), jmx.nd.array(w),
                               kernel=(3, 3), pad=(1, 1), num_filter=6,
                               num_group=2)
    _assert_rel("Convolution", conv.asnumpy(), jconv.asnumpy())
    jpool = jmx.nd.Pooling(jmx.nd.array(x), kernel=(2, 2), pool_type="avg")
    _assert_rel("Pooling", pool.asnumpy(), jpool.asnumpy())
    for kw in (dict(pool_type="sum", kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1)),
               dict(pool_type="lp", kernel=(2, 2), pooling_convention="full",
                    pad=(1, 1)),
               dict(pool_type="sum", global_pool=True),
               dict(pool_type="lp", global_pool=True)):
        with mx.cpu():
            got = mx.nd.Pooling(mx.nd.array(x), **kw)
        want = jmx.nd.Pooling(jmx.nd.array(x), **kw)
        _assert_rel(f"Pooling {kw}", got.asnumpy(), want.asnumpy())
    jout = jmx.nd.BatchNorm(jmx.nd.array(x), jmx.nd.array(gam),
                            jmx.nd.array(bet),
                            jmx.nd.array(np.zeros(4, np.float32)),
                            jmx.nd.array(np.ones(4, np.float32)),
                            training=True)
    for got, want in zip((out, mean, var), jout):
        _assert_rel("BatchNorm", got.asnumpy(), want.asnumpy())


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def test_deterministic_initializers_match_jax_exactly():
    for spec, shape in ((initializer.Constant(0.25), (3, 4)),
                        (initializer.Constant(-2.0), (2, 3, 3, 3))):
        want = jinit.Constant(spec.value)("w", shape)
        np.testing.assert_array_equal(spec("w", shape), want)
    for shape in ((1, 1, 4, 4), (2, 3, 5, 5), (4, 1, 3, 6)):
        np.testing.assert_array_equal(initializer.Bilinear()("w", shape),
                                      jinit.Bilinear()("w", shape))
    # the name dispatch holds whatever the initializer: a bias is 0
    assert not initializer.Constant(3.0)("dense_bias", (4,)).any()
    assert (initializer.create("constant")("w", (2,)) == 0).all()


def test_random_initializers_by_their_statistics():
    mx.random.seed(3)
    shape = (256, 128, 3, 3)
    fan_in, fan_out = 128 * 9, 256 * 9
    w = initializer.Normal(0.02)("w", shape)
    assert abs(w.std() - 0.02) < 2e-4 and abs(w.mean()) < 2e-4
    w = initializer.MSRAPrelu(slope=0.25)("w", shape)
    want = math.sqrt(2.0 / (1 + 0.25 ** 2) / ((fan_in + fan_out) / 2))
    assert abs(w.std() / want - 1) < 0.01
    w = initializer.LeCunN()("w", shape)
    assert abs(w.std() / math.sqrt(1.0 / fan_in) - 1) < 0.01
    for rand_type in ("uniform", "normal"):
        for rows, cols in ((16, 40), (40, 16)):
            q = initializer.Orthogonal(scale=1.5, rand_type=rand_type)(
                "w", (rows, cols // 4, 2, 2)).reshape(rows, cols)
            gram = q @ q.T if rows <= cols else q.T @ q
            np.testing.assert_allclose(gram, 2.25 * np.eye(min(rows, cols)),
                                       atol=1e-5)
    names = ("constant", "normal", "orthogonal", "msraprelu", "lecunn",
             "bilinear")
    for name in names:
        assert type(initializer.create(name)).__name__ == \
            type(jinit.create(name)).__name__


# ---------------------------------------------------------------------------
# deferred initialization, cast, Trainer's kvstore
# ---------------------------------------------------------------------------
def _mlp():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    return net


def test_deferred_init_raises_before_the_first_forward():
    """A forward before ``initialize`` raises, as the reference's
    ``DeferredInitializationError``; so does building an ``SPMDTrainer``
    (or any trainer over ``collect_params``) after ``initialize`` and
    before the first forward, as the JAX package's ``SPMDTrainer``."""
    x = torch.randn(2, 5)
    with pytest.raises(DeferredInitializationError, match="initialize"):
        _mlp()(x)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, activation="relu"), jnn.Dense(3))
    with pytest.raises(Exception, match="initialize"):
        jnet(jmx.nd.array(x.numpy()))
    net = _mlp().initialize(ctx=mx.cpu())
    assert tuple(net[0].weight.shape) == (8, 0)
    assert net[0].weight.device.type == "cpu"
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(RuntimeError, match="run one forward"):
        parallel.SPMDTrainer(net, ce, "sgd")
    jnet.initialize()
    with pytest.raises(RuntimeError, match="forward"):
        jmx.parallel.SPMDTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd")
    net(x)
    assert tuple(net[0].weight.shape) == (8, 5)
    parallel.SPMDTrainer(net, ce, "sgd")
    with pytest.raises(DeferredInitializationError, match="in_units"):
        from incubator_mxnet_tpu_torch.gluon.block import Block

        class Deferred(Block):
            def __init__(self):
                super().__init__()
                self._declare("weight", (4, 0))
        Deferred().initialize(ctx=mx.cpu())(x)


def test_a_trainer_made_before_the_first_forward_trains():
    """The first forward draws a deferred parameter in place, so a
    ``gluon.Trainer`` made after ``initialize`` and before that forward
    holds the parameters it trains."""
    mx.random.seed(4)
    net = _mlp().initialize("xavier", ctx=mx.cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    x, y = torch.randn(4, 5), torch.tensor([0.0, 1.0, 2.0, 1.0])
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = ce(net(x), y)
    mx.autograd.backward(loss)
    before = net[0].weight.detach().clone()
    tr.step(4)
    assert not torch.equal(net[0].weight.detach(), before)


def test_cast_before_the_first_forward_draws_fp32_then_casts():
    mx.random.seed(5)
    ref = _mlp().initialize("xavier", ctx=mx.cpu())
    ref(torch.randn(2, 5))
    mx.random.seed(5)
    net = _mlp().initialize("xavier", ctx=mx.cpu()).cast("bfloat16")
    out = net(torch.randn(2, 5).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    for (n, p), q in zip(net.named_parameters(), ref.parameters()):
        assert p.dtype == torch.bfloat16, n
        assert torch.equal(p.detach(), q.detach().to(torch.bfloat16)), n


def test_load_jax_params_fills_deferred_shapes():
    jnet = jnn.Dense(4, activation="relu")
    jnet.initialize()
    x = np.random.RandomState(11).randn(3, 6).astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    net = load_jax_params(
        nn.Dense(4, activation="relu"),
        {n: p.data().asnumpy() for n, p in jcollect(jnet).items()},
        ctx=mx.cpu())
    _assert_rel("out", net(torch.from_numpy(x)), want)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(nn.Dense(4, in_units=5),
                        {n: p.data().asnumpy()
                         for n, p in jcollect(jnet).items()}, ctx=mx.cpu())


@pytest.mark.parametrize("kvstore", ["device", "local", None])
def test_trainer_takes_the_one_card_kvstores(kvstore):
    """``kvstore`` "device" (the reference's default), "local" and None
    are one card's, and train alike: one SGD step equals the JAX
    package's ``Trainer`` step with the same kvstore."""
    jnet = jnn.Dense(3, in_units=4)
    jnet.initialize()
    params = {n: p.data().asnumpy() for n, p in jcollect(jnet).items()}
    net = load_jax_params(nn.Dense(3, in_units=4), params, ctx=mx.cpu())
    rs = np.random.RandomState(12)
    x, y = rs.randn(5, 4).astype(np.float32), np.array([0, 1, 2, 1, 0],
                                                          np.float32)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", opt, kvstore=kvstore)
    with jautograd.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(jmx.nd.array(x)),
                                                   jmx.nd.array(y))
    jl.backward()
    jtr.step(5)
    tr = gluon.Trainer(net.collect_params(), "sgd", opt, kvstore=kvstore)
    with mx.autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x)), torch.from_numpy(y))
    mx.autograd.backward(loss)
    tr.step(5)
    for n, p in jcollect(jnet).items():
        _assert_rel(n, tensors_of(net)[n], p.data().asnumpy())


def test_trainer_refuses_what_waits_for_multi_gpu():
    net = nn.Dense(3, in_units=4).initialize(ctx=mx.cpu())
    for kw in (dict(kvstore="dist_sync"), dict(kvstore="nccl"),
               dict(update_on_kvstore=True),
               dict(compression_params={"type": "2bit"})):
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            gluon.Trainer(net.collect_params(), "sgd", **kw)
    gluon.Trainer(net.collect_params(), "sgd", update_on_kvstore=False)


# ---------------------------------------------------------------------------
# slice 21: activation blocks, lambdas, norms, transposed convolutions,
# reflection padding
# ---------------------------------------------------------------------------
LAYER21_CASES = {
    "LeakyReLU": (dict(alpha=0.1), (3, 7)),
    "PReLU": (dict(in_channels=3), (2, 3, 4, 4)),
    "ELU": (dict(alpha=0.5), (3, 7)),
    "SELU": (dict(), (3, 7)),
    "GELU": (dict(), (3, 7)),
    "GELU_erf": (dict(approximate=False), (3, 7)),
    "SiLU": (dict(), (3, 7)),
    "Lambda": (dict(function="tanh"), (3, 4)),
    "HybridLambda": (dict(function="relu"), (3, 4)),
    "GroupNorm": (dict(num_groups=2), (2, 4, 3, 3)),
    "InstanceNorm": (dict(), (2, 3, 4, 4)),
    "RMSNorm": (dict(epsilon=1e-5), (2, 5, 6)),
    "Conv1DTranspose": (dict(channels=4, kernel_size=3, strides=2,
                             padding=1, output_padding=1, use_bias=False,
                             in_channels=3), (2, 3, 7)),
    "Conv2DTranspose": (dict(channels=6, kernel_size=3, strides=(2, 1),
                             padding=(1, 0), output_padding=(1, 0),
                             dilation=(1, 2), groups=2, activation="relu"),
                        (2, 4, 5, 5)),
    "ReflectionPad2D": (dict(padding=(1, 2)), (2, 3, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(LAYER21_CASES))
def test_slice21_layer_matches_jax(name):
    """Output, input gradient and parameter gradients after
    ``load_jax_params`` carried the JAX layer's parameters across."""
    kw, shape = LAYER21_CASES[name]
    cls = name.split("_")[0]
    jnet, net = getattr(jnn, cls)(**kw), getattr(nn, cls)(**kw)
    x = np.random.RandomState(21).randn(*shape).astype(np.float32)
    got, want = _compare(jnet, net, x, train=True)
    assert sorted(got["values"]) == sorted(want["values"])


def test_lambda_takes_a_function_and_passes_ndarrays_through():
    x = np.random.RandomState(22).randn(2, 3).astype(np.float32)
    _compare(jnn.Lambda(lambda a: a * 2 + 1), nn.Lambda(lambda a: a * 2 + 1),
             x)
    with mx.cpu():
        out = nn.Lambda("relu")(mx.nd.array(x))
    assert isinstance(out, mx.nd.NDArray)
    np.testing.assert_array_equal(out.asnumpy(), np.maximum(x, 0))
    with pytest.raises(ValueError, match="no op named"):
        nn.Lambda("no_such_op")
