"""HybridBlock and hybridize against the JAX package's hybridized results
(its ``tests/test_gluon.py`` cases): the forward and the recorded
gradients, BatchNorm's running statistics under ``hybridize``, a user
``HybridBlock`` written with ``hybrid_forward(F, ...)`` (the same class
body in both packages), deferred shapes filled by the first call, and
``cast``/``set_param``/``hybridize`` clearing the captured graphs. On the
CPU a hybridized block runs eagerly; the CUDA-graph path runs in
``chip_smoke.py``'s hybrid phase."""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon import nn as jnn

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.block import CachedOp
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

PKGS = {"port": (gluon, nn), "jax": (jgluon, jnn)}


def _mlp(g, n, bn=False):
    net = n.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(n.Dense(16, activation="tanh"))
        if bn:
            net.add(n.BatchNorm(momentum=0.5))
        net.add(n.Dense(5))
    return net


def _copy(jnet, net, x):
    """Draw both nets' deferred shapes with one eager call, then give the
    port the JAX net's values."""
    jnet(jmx.nd.array(x))
    net(mx.nd.array(x, ctx=mx.cpu()))
    load_jax_params(net, {k: p.data().asnumpy() for k, p in
                          jnet._collect_params_with_prefix().items()},
                    ctx=mx.cpu())


def _x(seed=0, shape=(6, 12)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _step(pkg, net, x):
    m = mx if pkg == "port" else jmx
    kw = {"ctx": mx.cpu()} if pkg == "port" else {}
    with m.autograd.record():
        y = net(m.nd.array(x, **kw))
        loss = (y ** 2).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy().copy() for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return y.asnumpy(), grads


def test_hybridized_forward_matches_the_reference():
    x = _x()
    jnet, net = _mlp(jgluon, jnn), _mlp(gluon, nn)
    jnet.initialize(init="xavier")
    net.initialize(ctx=mx.cpu())
    _copy(jnet, net, x)
    eager = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    jnet.hybridize()
    net.hybridize()
    for _ in range(2):          # the capture call, then the cached one
        got = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
        want = jnet(jmx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, eager)
    assert net._cached_op is None        # the CPU runs eagerly


def test_hybridized_recorded_gradients_match_the_reference():
    x = _x(1, (5, 8))
    jnet, net = _mlp(jgluon, jnn), _mlp(gluon, nn)
    jnet.initialize(init="xavier")
    net.initialize(ctx=mx.cpu())
    _copy(jnet, net, x)
    jnet.hybridize()
    net.hybridize()
    for _ in range(2):
        (y, g), (jy, jg) = _step("port", net, x), _step("jax", jnet, x)
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
        assert set(g) == set(jg)
        for k in jg:
            np.testing.assert_allclose(g[k], jg[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        net.zero_grad()
        jnet.zero_grad()


def test_batchnorm_aux_updates_under_hybridize():
    """The running statistics move on every recorded call of the
    hybridized net, to the reference's values."""
    x = _x(2, (8, 4))
    jnet, net = _mlp(jgluon, jnn, bn=True), _mlp(gluon, nn, bn=True)
    jnet.initialize(init="xavier")
    net.initialize(ctx=mx.cpu())
    _copy(jnet, net, x)
    jnet.hybridize()
    net.hybridize()
    stats = [k for k in jnet._collect_params_with_prefix()
             if "running" in k]
    assert stats == ["1.running_mean", "1.running_var"]
    seen = []
    for _ in range(3):
        _step("port", net, x)
        _step("jax", jnet, x)
        jp = jnet._collect_params_with_prefix()
        pp = net._collect_params_with_prefix()
        for k in stats:
            np.testing.assert_allclose(pp[k].data().asnumpy(),
                                       jp[k].data().asnumpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        seen.append(pp["1.running_mean"].data().asnumpy().copy())
    assert not np.allclose(seen[0], seen[1])


def _user_block(g, n):
    """A user HybridBlock in MXNet 1.x style: a deferred parameter of its
    own, a child, and ``hybrid_forward(F, x, weight)``."""

    class Scaled(g.HybridBlock):
        def __init__(self, units, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.body = n.Dense(units, in_units=3)
                self.weight = self.params.get("weight", shape=(units, 0),
                                              init="xavier")

        def infer_shape(self, x, *args):
            self.weight.shape = (self.weight.shape[0], x.shape[1])

        def hybrid_forward(self, F, x, weight):
            h = F.FullyConnected(x, weight, num_hidden=weight.shape[0],
                                 no_bias=True)
            return (self.body(x) + h).tanh() * 0.5 + 1.0

    return Scaled(4, prefix="scaled_")


def test_user_hybrid_block_hybrid_forward_as_the_reference():
    x = _x(3, (5, 3))
    jnet, net = _user_block(jgluon, jnn), _user_block(gluon, nn)
    jnet.initialize()
    net.initialize(ctx=mx.cpu())
    assert list(net.collect_params()) == list(jnet.collect_params()) == [
        "scaled_weight", "scaled_dense0_weight", "scaled_dense0_bias"]
    assert net.collect_params()["scaled_weight"].shape == (4, 0)
    _copy(jnet, net, x)
    assert net.collect_params()["scaled_weight"].shape == (4, 3)
    jnet.hybridize()
    net.hybridize()
    (y, g), (jy, jg) = _step("port", net, x), _step("jax", jnet, x)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_deferred_shapes_filled_by_the_first_hybridized_call():
    x = _x(4, (2, 9))
    shapes = {}
    for pkg, (g, n) in PKGS.items():
        net = _mlp(g, n, bn=True)
        if pkg == "port":
            net.initialize(ctx=mx.cpu())
            net.hybridize()
            net(mx.nd.array(x, ctx=mx.cpu()))
        else:
            net.initialize()
            net.hybridize()
            net(jmx.nd.array(x))
        shapes[pkg] = {k: tuple(p.shape) for k, p in
                       net.collect_params().items()}
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"]["mlp_dense0_weight"] == (16, 9)


@pytest.mark.parametrize("how", ["cast", "set_param", "hybridize",
                                 "reset_ctx"])
def test_cast_set_param_and_hybridize_clear_the_captured_graphs(how):
    x = _x(5, (2, 12))
    net = _mlp(gluon, nn)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.array(x, ctx=mx.cpu()))
    net._cached_op = CachedOp(net)
    net[0]._cached_op = CachedOp(net[0])
    if how == "cast":
        net.cast("bfloat16")
        y = net(mx.nd.array(x, ctx=mx.cpu()).astype("bfloat16"))
        assert str(y.dtype) == "torch.bfloat16"
    elif how == "set_param":
        net.set_param("0.bias", net[0].bias.detach() + 1.0)
    elif how == "hybridize":
        net.hybridize(static_alloc=True)
        assert net._cached_op_args["static_alloc"]
    else:
        net.reset_ctx(mx.cpu())
    assert net._cached_op is None and net[0]._cached_op is None


def test_hybrid_containers_are_hybrid_blocks():
    from incubator_mxnet_tpu_torch.gluon.contrib.nn import HybridConcurrent
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, vision

    for blk in (nn.HybridSequential(), nn.HybridLambda("relu"),
                HybridConcurrent(), nn.Dense(2), vision.resnet18_v1(),
                get_gpt("gpt_decoder_tiny", vocab_size=11, max_length=8)):
        assert isinstance(blk, gluon.HybridBlock), type(blk).__name__
    assert not isinstance(nn.Sequential(), gluon.HybridBlock)
