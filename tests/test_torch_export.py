"""HybridBlock.export, SymbolBlock.imports and export_for_serving against
the JAX package: the reference's ``tests/test_export.py`` cases on the
port, files carried across the packages both ways, the recorded op
sequence and attributes of the same net equal in both packages, the
reference's ``ValueError`` for the nets it cannot export, and
``ModelServer.from_exported`` on the CPU (the reference's
``test_export_for_serving_round_trip``). The nets are written once for
both packages (``hybrid_forward(F, ...)``)."""

import ast
import functools
import json

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.serving import ModelServer

CPU = mx.cpu()


def _dense_bn(g, n):
    net = n.HybridSequential()
    net.add(n.Dense(16, activation="relu"), n.BatchNorm(), n.Dense(4))
    return net


def _conv_net(g, n):
    net = n.HybridSequential()
    net.add(n.Conv2D(4, 3, padding=1), n.BatchNorm(),
            n.Activation("relu"), n.MaxPool2D(2, 2), n.Dense(5))
    return net


def _pool_net(g, n):
    net = n.HybridSequential()
    net.add(n.Conv2D(3, 3, strides=2, in_channels=2), n.AvgPool2D(2),
            n.GlobalMaxPool2D(), n.Flatten(), n.Dense(3, activation="tanh"))
    return net


def _scaled(g, n):
    class Scaled(g.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.body = n.Dense(6, activation="tanh")

        def hybrid_forward(self, F, x):
            h = self.body(x)
            return h * 0.5 + 1.0 - (2.0 / (h + 3.0))

    return Scaled()


def _reduce(g, n):
    class Reduce(g.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.body = n.Dense(6, in_units=4)

        def hybrid_forward(self, F, x):
            h = self.body(x)
            return h.mean(axis=1, keepdims=True) + h.sum(axis=-1,
                                                         keepdims=True)

    return Reduce()


def _sliced(g, n):
    class Sliced(g.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.body = n.Dense(5, in_units=4)

        def hybrid_forward(self, F, x):
            return self.body(x).slice(begin=(0, 1), end=(None, None))

    return Sliced()


def _attention(g, n, units=16, heads=2):
    """A QKV Dense split into heads and ``flash_attention`` (the structure
    of the GPT's attention)."""

    class Attention(g.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.qkv = n.Dense(3 * units, flatten=False, in_units=units)

        def hybrid_forward(self, F, x):
            b, t, _ = x.shape
            d = units // heads
            qkv = self.qkv(x).reshape(b, t, 3, heads, d)
            q, k, v = [qkv.slice_axis(axis=2, begin=i, end=i + 1)
                       .reshape(b, t, heads, d).transpose((0, 2, 1, 3))
                       for i in range(3)]
            o = F.flash_attention(q, k, v, causal=True)
            return o.transpose((0, 2, 1, 3)).reshape(b, t, units)

    return Attention()


def _resnet18(g, n):
    return g.model_zoo.vision.resnet18_v1(classes=10)


NETS = {"dense_bn": (_dense_bn, (3, 8)), "conv": (_conv_net, (2, 3, 8, 8)),
        "pool": (_pool_net, (2, 2, 9, 9)), "scalar": (_scaled, (2, 3)),
        "reduce": (_reduce, (3, 4)), "slice": (_sliced, (3, 4)),
        "attention": (_attention, (2, 8, 16)),
        "resnet18": (_resnet18, (1, 3, 32, 32))}


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The JAX net (drawn, one forward) and the port's with its values
    (made once a module: the tests only run them in inference)."""
    make, shape = NETS[name]
    x = _x(shape)
    jnet = make(jgluon, jnn)
    jnet.initialize(init="xavier")
    jnet(jmx.nd.array(x))
    net = make(gluon, nn)
    net.initialize(ctx=CPU)
    net(mx.nd.array(x, ctx=CPU))
    load_jax_params(net, {k: p.data().asnumpy() for k, p in
                          jnet._collect_params_with_prefix().items()},
                    ctx=CPU)
    return jnet, net, x


def _ops(sym_file):
    nodes = json.load(open(sym_file))["nodes"]
    return [(n["op"], n["attrs"]) for n in nodes if n["op"] != "null"], \
        [n["name"] for n in nodes if n["op"] == "null"]


def _same_graph(ops, jops):
    """The same ops with the same attributes, but for a flatten: the
    port's ``reshape`` to ``(-1, features)`` runs at any batch, where the
    reference's ``(N, -1)`` fixes the exported batch."""
    assert [op for op, _ in ops] == [op for op, _ in jops]
    for (op, attrs), (_, jattrs) in zip(ops, jops):
        if op == "reshape" and attrs != jattrs:
            shape = ast.literal_eval(attrs["shape"])
            jshape = ast.literal_eval(jattrs["shape"])
            assert len(shape) == len(jshape) == 2
            assert shape[0] == -1 and jshape[1] == -1
            continue
        assert attrs == jattrs, op


@pytest.mark.parametrize("name", list(NETS))
def test_export_round_trip_and_the_same_graph_as_the_reference(tmp_path,
                                                               name):
    jnet, net, x = _pair(name)
    y0 = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(y0, jnet(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-4, atol=1e-5)
    sj, pp = net.export(str(tmp_path / "port"), epoch=7)
    assert sj.endswith("-symbol.json") and pp.endswith("-0007.params")
    blk = gluon.SymbolBlock.imports(sj, "data", pp, ctx=CPU)
    np.testing.assert_array_equal(blk(mx.nd.array(x, ctx=CPU)).asnumpy(),
                                  y0)
    jsj, _ = jnet.export(str(tmp_path / "jax"))
    ops, args = _ops(sj)
    jops, jargs = _ops(jsj)
    _same_graph(ops, jops)
    assert args == jargs
    if name in ("dense_bn", "conv", "resnet18"):
        assert blk._sym_aux_names and all(
            "running" in a for a in blk._sym_aux_names)


@pytest.mark.parametrize("name", ["dense_bn", "conv", "attention",
                                  "resnet18"])
def test_files_cross_the_packages_both_ways(tmp_path, name):
    jnet, net, x = _pair(name)
    jy = jnet(jmx.nd.array(x)).asnumpy()
    y = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    jsj, jpp = jnet.export(str(tmp_path / "jax"))
    sj, pp = net.export(str(tmp_path / "port"))
    into_port = gluon.SymbolBlock.imports(jsj, "data", jpp, ctx=CPU)
    np.testing.assert_allclose(into_port(mx.nd.array(x, ctx=CPU)).asnumpy(),
                               jy, rtol=1e-4, atol=1e-5)
    into_jax = JSymbolBlock.imports(sj, "data", pp)
    np.testing.assert_allclose(into_jax(jmx.nd.array(x)).asnumpy(), y,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["pool", "resnet18"])
def test_an_exported_flatten_runs_at_another_batch(tmp_path, name):
    """The port's export of a net with a flatten serves any batch, in
    either package (the reference's own export fixes the batch)."""
    jnet, net, x = _pair(name)
    sj, pp = net.export(str(tmp_path / "port"))
    x3 = _x((3,) + x.shape[1:], 5)
    want = net(mx.nd.array(x3, ctx=CPU)).asnumpy()
    got = gluon.SymbolBlock.imports(sj, "data", pp, ctx=CPU)(
        mx.nd.array(x3, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(got, want)
    jgot = JSymbolBlock.imports(sj, "data", pp)(jmx.nd.array(x3)).asnumpy()
    np.testing.assert_allclose(jgot, want, rtol=1e-4, atol=1e-5)


def test_export_bn_aux_states_after_training(tmp_path):
    """Trained running statistics survive the round trip, and the
    imported block writes them back in training, as the reference's."""
    net = _dense_bn(gluon, nn)
    net.initialize(init="xavier", ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = mx.nd.array(_x((16, 4), 1), ctx=CPU)
    for _ in range(3):
        with autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
        trainer.step(16)
    y0 = net(x).asnumpy()
    sj, pp = net.export(str(tmp_path / "bn"))
    blk = gluon.SymbolBlock.imports(sj, "data", pp, ctx=CPU)
    np.testing.assert_allclose(blk(x).asnumpy(), y0, rtol=1e-5, atol=1e-6)
    assert blk._sym_aux_names == ["1.running_mean", "1.running_var"]
    aux = blk.collect_params()["1.running_mean"]
    assert aux.grad_req == "null"
    jblk = JSymbolBlock.imports(sj, "data", pp)
    xs = _x((16, 4), 2)
    with autograd.record():
        out = blk(mx.nd.array(xs, ctx=CPU))
        loss = ((out - 1.0) ** 2).sum()
    loss.backward()
    with jautograd.record():
        jout = jblk(jmx.nd.array(xs))
        jloss = ((jout - 1.0) ** 2).sum()
    jloss.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    jaux = jblk.collect_params()["1.running_mean"]
    np.testing.assert_allclose(aux.data().asnumpy(), jaux.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)
    for k, p in blk.collect_params().items():
        if p.grad_req != "null":
            want = jblk.collect_params()[k].grad().asnumpy()
            np.testing.assert_allclose(
                p.grad().asnumpy(), want, rtol=1e-4,
                atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_symbol_block_fills_deferred_shapes(tmp_path):
    jnet, net, x = _pair("conv")
    sj, pp = net.export(str(tmp_path / "conv"))
    blk = gluon.SymbolBlock.imports(sj, "data")
    blk.initialize(ctx=CPU)
    assert blk.collect_params()["0.weight"].shape is None
    out = blk(mx.nd.array(x, ctx=CPU))
    assert out.shape == (2, 5)
    shapes = {k: p.shape for k, p in blk.collect_params().items()}
    assert shapes == {k: tuple(p.shape) for k, p in
                      net._collect_params_with_prefix().items()}
    sym = mx.sym.load(sj)
    args, outs, aux = sym.infer_shape_partial(data=x.shape)
    assert outs == [(2, 5)]
    assert aux == [(4,), (4,)]
    assert len(sym.list_arguments()) == len(args)
    assert sym.list_outputs() == [sym.get_internals().list_outputs()[-1]]


def test_export_hybridized_net(tmp_path):
    net = _dense_bn(gluon, nn)
    net.initialize(init="xavier", ctx=CPU)
    net.hybridize()
    x = mx.nd.array(_x((4, 6), 3), ctx=CPU)
    net(x)
    y0 = net(x)
    sj, pp = net.export(str(tmp_path / "hyb"))
    blk = gluon.SymbolBlock.imports(sj, "data", pp, ctx=CPU)
    np.testing.assert_array_equal(blk(x).asnumpy(), y0.asnumpy())


def test_export_without_forward_raises(tmp_path):
    net = nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    with pytest.raises(RuntimeError, match="forward"):
        net.export(str(tmp_path / "x"))


def test_export_of_a_captured_constant_raises(tmp_path):
    for g, n, nd, kw in ((gluon, nn, mx.nd, {"ctx": CPU}),
                         (jgluon, jnn, jmx.nd, {})):
        class Const(g.HybridBlock):
            def hybrid_forward(self, F, x):
                return x + nd.ones((3,), **kw)

        blk = Const()
        blk(nd.array(_x((2, 3)), **kw))
        with pytest.raises(ValueError, match="constant captured"):
            blk.export(str(tmp_path / "c"))


def _bert(pkg):
    if pkg == "port":
        from incubator_mxnet_tpu_torch.models import get_bert
    else:
        from incubator_mxnet_tpu.models import get_bert
    return get_bert("bert_12_768_12", vocab_size=50, num_layers=1,
                    units=32, hidden_size=64, num_heads=2, max_length=16,
                    dropout=0.0)


def _gpt(pkg):
    g = gluon if pkg == "port" else jgluon
    return g.model_zoo.get_gpt("gpt_decoder_tiny", vocab_size=50,
                               max_length=16)


def _fused(pkg):
    """A miniature of ``fused_resnet50_v1``'s class (the JAX side runs its
    Pallas kernels in interpret mode)."""
    if pkg == "port":
        from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.fused_resnet \
            import FusedResNetV1
    else:
        from incubator_mxnet_tpu.gluon.model_zoo.vision.fused_resnet import \
            FusedResNetV1
    return FusedResNetV1([1, 1, 1, 1], [8, 16, 32, 64, 128], classes=4)


@pytest.mark.parametrize("make,op", [(_bert, "positions"),
                                     (_gpt, "positions"),
                                     (_fused, "fused_stem")])
def test_the_nets_the_reference_cannot_export_raise_as_it(tmp_path, make,
                                                          op):
    messages = []
    for pkg in ("port", "jax"):
        net = make(pkg)
        if pkg == "port":
            net.initialize(ctx=CPU)
            nd, kw = mx.nd, {"ctx": CPU}
        else:
            net.initialize()
            nd, kw = jmx.nd, {}
        if op == "fused_stem":
            net(nd.array(_x((1, 3, 16, 16)), **kw))
        else:
            net(nd.array(np.ones((1, 8), np.int32), dtype="int32", **kw))
        with pytest.raises(ValueError) as err:
            net.export(str(tmp_path / pkg))
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert f"op {op!r} is not a registered op" in messages[0]


def test_export_for_serving_and_from_exported_round_trip(tmp_path):
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    x = _x((2, 4), 3)
    ref = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    prefix = str(tmp_path / "net")
    spec_file = net.export_for_serving(prefix, buckets=(1, 2))
    spec = json.load(open(spec_file))
    assert spec["inputs"] == [{"name": "data", "features": [4],
                               "dtype": "float32"}]
    assert spec["buckets"] == [1, 2]
    srv = ModelServer.from_exported(prefix, ctx=CPU, max_wait_ms=1.0)
    try:
        assert [k[0] for k in srv.compiled_signatures()] == [1, 2]
        got = np.stack([srv.predict(row) for row in x])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    finally:
        srv.close()
    # the JAX package serves the port's trio and the port the JAX one's
    jnet = jnn.Dense(3, in_units=4)
    jnet.initialize()
    jref = jnet(jmx.nd.array(x)).asnumpy()
    jprefix = str(tmp_path / "jnet")
    jnet.export_for_serving(jprefix, buckets=(2,))
    srv = ModelServer.from_exported(jprefix, ctx=CPU, max_wait_ms=1.0)
    try:
        got = np.stack([srv.predict(row) for row in x])
        np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-6)
    finally:
        srv.close()


@pytest.mark.parametrize("name", ["squeezenet1.1", "mobilenetv2_0.25",
                                  "mobilenetv3_small", "densenet121"])
def test_zoo_nets_export_and_import(tmp_path, name):
    """The zoo's concatenations, clips and residual sums are registered
    ops, so the nets export and run again from the files (the port alone:
    the JAX side of these nets takes minutes on the CPU)."""
    net = gluon.model_zoo.vision.get_model(name, classes=5)
    net.initialize("xavier", ctx=CPU)
    x = mx.nd.array(_x((1, 3, 64, 64), 7), ctx=CPU)
    y = net(x).asnumpy()
    sj, pp = net.export(str(tmp_path / "zoo"))
    blk = gluon.SymbolBlock.imports(sj, "data", pp, ctx=CPU)
    np.testing.assert_array_equal(blk(x).asnumpy(), y)
