"""gluon.Parameter, ParameterDict and the rest of Block against the JAX
package: prefix names under explicit prefixes and ``name_scope``,
``collect_params(select)``, ``setattr``, ``zero_grad``, ``Constant``,
``params=`` sharing, ``save``/``load`` with ``strip_prefix``/
``restore_prefix`` across the packages, ``grad_stype="row_sparse"``,
hooks, ``apply``, ``register_child`` and ``reset_ctx``. Every block gets
an explicit prefix, so the process-global name counters do not matter."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon import nn as jnn

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

PKGS = {"port": (gluon, nn), "jax": (jgluon, jnn)}


def _net(g, n):
    """A nested net: explicit prefixes outside, counters inside."""
    net = n.HybridSequential(prefix="model_")
    with net.name_scope():
        net.add(n.Dense(6, in_units=5, prefix="fc1_"))
        inner = n.HybridSequential()
        with inner.name_scope():
            inner.add(n.Dense(4, in_units=6), n.BatchNorm(in_channels=4))
        net.add(inner, n.Dense(3, in_units=4))
    return net


def _pair(seed=0):
    """The nets of both packages with the JAX net's values."""
    jnet = _net(jgluon, jnn)
    jnet.initialize(init="xavier")
    net = _net(gluon, nn)
    load_jax_params(net, {k: p.data().asnumpy() for k, p in
                          jnet._collect_params_with_prefix().items()},
                    ctx=mx.cpu())
    return jnet, net


def _x(seed=0, shape=(4, 5)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_prefix_names_and_name_scope_as_the_reference():
    jnet, net = _pair()
    assert list(net.collect_params()) == list(jnet.collect_params())
    assert net.prefix == jnet.prefix == "model_"
    assert net.name == jnet.name == "model"
    assert [b.prefix for b in net] == [b.prefix for b in jnet]
    assert [b.prefix for b in net[1]] == [b.prefix for b in jnet[1]]
    assert list(net.params) == list(jnet.params)
    # the structural names stay the JAX package's too
    assert list(net._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert isinstance(net.collect_params(), gluon.ParameterDict)
    p = net.collect_params()["model_fc1_weight"]
    assert isinstance(p, gluon.Parameter) and p.shape == (6, 5)
    assert p.name == "model_fc1_weight"


@pytest.mark.parametrize("select", [".*weight", ".*running_.*",
                                    "model_hybrid_sequential0_.*", "nomatch"])
def test_collect_params_select(select):
    jnet, net = _pair()
    assert list(net.collect_params(select)) == \
        list(jnet.collect_params(select))


def test_setattr_grad_req_and_lr_mult():
    jnet, net = _pair()
    for params in (net.collect_params(".*dense"),
                   jnet.collect_params(".*dense")):
        params.setattr("grad_req", "null")
        params.setattr("lr_mult", 0.5)
    for (n, p), (jn, jp) in zip(net.collect_params().items(),
                                jnet.collect_params().items()):
        assert n == jn and p.grad_req == jp.grad_req, n
        assert p.lr_mult == jp.lr_mult, n
        assert p.data()._data.requires_grad == (p.grad_req != "null"), n
    # a frozen parameter keeps its value through a trainer step
    x = _x()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    frozen = net.collect_params()["model_hybrid_sequential0_dense0_weight"]
    w0 = frozen.data().asnumpy().copy()
    with mx.autograd.record():
        loss = (net(mx.nd.array(x, ctx=mx.cpu())) ** 2).sum()
    loss.backward()
    tr.step(4)
    np.testing.assert_array_equal(frozen.data().asnumpy(), w0)


def test_zero_grad_writes_zeros():
    x = _x()
    jnet, net = _pair()
    for pkg, model, nd, ctx in (("port", net, mx.nd, mx.cpu()),
                                ("jax", jnet, jmx.nd, None)):
        xs = nd.array(x) if ctx is None else nd.array(x, ctx=ctx)
        with (mx if pkg == "port" else jmx).autograd.record():
            loss = (model(xs) ** 2).sum()
        loss.backward()
        grads = {k: p.grad().asnumpy() for k, p in
                 model.collect_params().items() if p.grad_req != "null"}
        assert any(np.abs(g).sum() > 0 for g in grads.values()), pkg
        model.zero_grad()
        for k, p in model.collect_params().items():
            if p.grad_req != "null":
                g = p.grad()
                assert g is not None and not g.asnumpy().any(), (pkg, k)
    # a gradient object survives zero_grad (zeros, not None)
    w = net.collect_params()["model_fc1_weight"]
    assert w.data()._data.grad is not None


def test_constant_as_the_reference():
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    c, jc = gluon.Constant("const", value), jgluon.Constant("const", value)
    c.initialize(ctx=mx.cpu())
    jc.initialize()
    np.testing.assert_array_equal(c.data().asnumpy(), jc.data().asnumpy())
    assert c.grad_req == jc.grad_req == "null"
    assert c.shape == jc.shape == (2, 3)
    assert not c.data()._data.requires_grad


def test_params_sharing_sums_both_uses_as_the_reference():
    """``params=shared.params`` shares the same tensor; its gradient sums
    both uses (reference ``tests/test_gluon.py::test_parameter_sharing``)."""
    x = _x(1, (2, 8))
    grads = {}
    for pkg in ("jax", "port"):
        g, n = PKGS[pkg]
        shared = n.Dense(8, in_units=8, prefix="shared_")
        net = n.HybridSequential(prefix="net_")
        net.add(shared, n.Dense(8, in_units=8, params=shared.params))
        if pkg == "port":
            net.initialize(ctx=mx.cpu())
            ps = net.collect_params()
            assert net[0].weight is net[1].weight   # one tensor
            for k, v in jw.items():
                ps[k].set_data(v)
            xs, ag = mx.nd.array(x, ctx=mx.cpu()), mx.autograd
        else:
            net.initialize()
            ps = net.collect_params()
            jw = {k: p.data().asnumpy() for k, p in ps.items()}
            xs, ag = jmx.nd.array(x), jmx.autograd
        assert list(ps) == ["shared_weight", "shared_bias"]
        with ag.record():
            loss = (net(xs) ** 2).sum()
        loss.backward()
        grads[pkg] = {k: p.grad().asnumpy() for k, p in ps.items()}
    for k, want in grads["jax"].items():
        np.testing.assert_allclose(grads["port"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert np.abs(grads["port"]["shared_weight"]).sum() > 0


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_load_prefix_names_across_packages(tmp_path, direction):
    jnet, net = _pair()
    f = str(tmp_path / "model.params")
    fresh_j = _net(jgluon, jnn)
    fresh = _net(gluon, nn)
    if direction == "port_to_jax":
        net.collect_params().save(f, strip_prefix=net.prefix)
        fresh_j.collect_params().load(f, restore_prefix=fresh_j.prefix)
        got = {k: p.data().asnumpy() for k, p in
               fresh_j.collect_params().items()}
    else:
        jnet.collect_params().save(f, strip_prefix=jnet.prefix)
        fresh.collect_params().load(f, ctx=mx.cpu(),
                                    restore_prefix=fresh.prefix)
        got = {k: p.data().asnumpy() for k, p in
               fresh.collect_params().items()}
    want = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the stripped names are the file's keys, as in the reference
    keys = sorted(mx.nd.load(f, ctx=mx.cpu()))
    assert keys == sorted(k[len("model_"):] for k in want)


def test_save_params_load_params_legacy_names(tmp_path):
    jnet, net = _pair()
    f = str(tmp_path / "legacy.params")
    net.save_params(f)
    fresh = _net(jgluon, jnn)
    fresh.load_params(f)
    x = _x(2)
    np.testing.assert_allclose(fresh(jmx.nd.array(x)).asnumpy(),
                               net(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               rtol=1e-5, atol=1e-6)
    back = _net(gluon, nn)
    back.load_params(f, ctx=mx.cpu())
    for k, p in back.collect_params().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), net.collect_params()[k].data().asnumpy())


def test_grad_stype_row_sparse_as_the_reference():
    ids = np.array([[1, 3, 3], [7, 1, 0]], np.float32)
    w0 = np.random.RandomState(4).rand(10, 4).astype(np.float32)
    emb = nn.Embedding(10, 4, sparse_grad=True, prefix="emb_")
    jemb = jnn.Embedding(10, 4, sparse_grad=True, prefix="emb_")
    jemb.initialize()
    jemb.weight.set_data(jmx.nd.array(w0))
    emb.initialize(ctx=mx.cpu())
    emb.collect_params()["emb_weight"].set_data(w0)
    p = emb.collect_params()["emb_weight"]
    assert p.grad_stype == jemb.weight._grad_stype == "row_sparse"
    with mx.autograd.record():
        loss = (emb(mx.nd.array(ids, ctx=mx.cpu())) ** 2).sum()
    loss.backward()
    with jmx.autograd.record():
        jloss = (jemb(jmx.nd.array(ids)) ** 2).sum()
    jloss.backward()
    g, jg = p.grad(), jemb.weight.grad()
    assert g.stype == jg.stype == "row_sparse"
    np.testing.assert_array_equal(g.indices.asnumpy(), jg.indices.asnumpy())
    np.testing.assert_allclose(g.data.asnumpy(), jg.data.asnumpy(),
                               rtol=1e-6)
    p.zero_grad()
    assert p.grad().indices.shape == (0,)


def test_hooks_see_ndarrays_apply_and_register_child():
    visited, x = {}, _x()
    for pkg, (g, n) in PKGS.items():
        net = _net(g, n)
        net.register_child(n.Dense(2, in_units=3, prefix="extra_"), "extra")
        assert "extra_weight" in net.collect_params()
        assert "extra.weight" in net._collect_params_with_prefix()
        visited[pkg] = []
        net.apply(lambda b: visited[pkg].append(type(b).__name__))
        body, seen = _net(g, n), []
        body.register_forward_pre_hook(
            lambda blk, args: seen.append(("pre", type(args[0]).__name__)))
        body.register_forward_hook(
            lambda blk, args, out: seen.append(("post",
                                                type(out).__name__)))
        if pkg == "port":
            body.initialize(ctx=mx.cpu())
            body(mx.nd.array(x, ctx=mx.cpu()))
        else:
            body.initialize()
            body(jmx.nd.array(x))
        assert seen == [("pre", "NDArray"), ("post", "NDArray")], pkg
    assert visited["port"] == visited["jax"]


def test_reset_ctx_keeps_values_and_objects():
    jnet, net = _pair()
    before = {k: (p.data()._data, p.data().asnumpy().copy())
              for k, p in net.collect_params().items()}
    net.reset_ctx(mx.cpu())
    jnet.reset_ctx(jmx.cpu())
    for k, p in net.collect_params().items():
        t, v = before[k]
        assert p.data()._data is t, k           # the same tensor object
        assert p.list_ctx() == [mx.cpu()], k
        np.testing.assert_array_equal(p.data().asnumpy(), v)
    x = _x(3)
    np.testing.assert_allclose(net(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_parameter_set_data_and_deferred_shape():
    net = nn.Dense(3, prefix="d_")
    net.initialize(ctx=mx.cpu())
    w = net.collect_params()["d_weight"]
    assert w.shape == (3, 0)
    with pytest.raises(gluon.block.DeferredInitializationError):
        w.data()
    net(mx.nd.array(_x(0, (2, 7)), ctx=mx.cpu()))
    assert w.shape == (3, 7)
    w.set_data(np.ones((3, 7), np.float32))
    np.testing.assert_array_equal(net.weight.detach().numpy(),
                                  np.ones((3, 7), np.float32))
    with pytest.raises(ValueError, match="shape"):
        w.set_data(np.ones((2, 7), np.float32))
    # the import path of the reference keeps working
    from incubator_mxnet_tpu_torch.gluon.block import \
        DeferredInitializationError
    from incubator_mxnet_tpu_torch.gluon.parameter import \
        DeferredInitializationError as moved
    assert DeferredInitializationError is moved
    torch.testing.assert_close(w.data()._data, net.weight)


def test_zoo_prefix_names_as_the_reference():
    """Every model of the vision zoo, the fused ResNet-50, the GPT and
    BERT name their parameters as the reference does under one explicit
    prefix (``name_scope`` and the containers' ``prefix=""``)."""
    from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jget_gpt
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu.models import get_bert as jget_bert

    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, vision
    from incubator_mxnet_tpu_torch.models import get_bert

    pairs = [(vision.get_model(name, classes=7, prefix="m_"),
              jvision.get_model(name, classes=7, prefix="m_"))
             for name in sorted(jvision._models)]
    pairs.append((vision.fused_resnet50_v1(classes=7, prefix="f_"),
                  jvision.fused_resnet50_v1(classes=7, prefix="f_")))
    pairs.append((get_gpt("gpt_decoder_tiny", vocab_size=11, max_length=8,
                          prefix="g_"),
                  jget_gpt("gpt_decoder_tiny", vocab_size=11, max_length=8,
                           prefix="g_")))
    kw = dict(vocab_size=50, num_layers=1, units=32, hidden_size=64,
              num_heads=2, max_length=16, prefix="b_")
    pairs.append((get_bert("bert_12_768_12", **kw),
                  jget_bert("bert_12_768_12", **kw)))
    for net, jnet in pairs:
        assert list(net.collect_params()) == list(jnet.collect_params()), \
            type(net).__name__
