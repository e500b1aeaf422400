"""Port parity: ``gluon.utils`` and ``gluon.contrib.nn``.

Each behavior of the JAX package's ``gluon/utils.py`` against the port's
on the same numpy inputs: ``split_data`` (even, the remainder, the
``ValueError`` in the reference's words), ``split_and_load`` (numpy,
``NDArray`` and tensor inputs, one context and several),
``clip_global_norm`` (the norm returned as a float, the scaling only below
1, the NaN and inf cases and their warning), ``check_sha1`` of a file
under ``tmp_path`` and ``download``, which resolves a present file and
raises ``RuntimeError`` in the reference's words otherwise; then
``HybridConcurrent`` on axis 1 and -1 with its names, and ``SyncBatchNorm``
against ``BatchNorm``, against ``gluon.contrib.nn``.
"""

import hashlib
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu.gluon import contrib as jcontrib
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon import utils as jutils

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch.gluon import contrib, nn, utils
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.ndarray import NDArray

RTOL = 1e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else a.detach().numpy()


def test_public_names_match_the_reference():
    """Every public name of the reference's ``gluon.utils`` and
    ``gluon.contrib.nn`` but ``MoEFFN`` (which comes with the
    expert-parallel path) is in the port."""
    for jmod, mod, skip in ((jutils, utils, ()),
                            (jcontrib.nn, contrib.nn, ("MoEFFN",))):
        want = {n for n, v in vars(jmod).items() if not n.startswith("_")
                and callable(v) and getattr(v, "__module__", "") ==
                jmod.__name__} - set(skip)
        want |= {"Concurrent"} if jmod is jcontrib.nn else set()
        assert want <= set(mod.__all__), want - set(mod.__all__)
    assert gluon.utils is utils and gluon.contrib.nn is contrib.nn


@pytest.mark.parametrize("size,num,axis,even", [
    (8, 4, 0, True), (6, 3, 1, True), (7, 3, 0, False), (10, 4, 1, False)])
def test_split_data_matches_jax(size, num, axis, even):
    shape = (size, 3) if axis == 0 else (2, size)
    x = _rand(0, *shape)
    want = [s.asnumpy() for s in jutils.split_data(jmx.nd.array(x), num,
                                                   axis, even)]
    got = utils.split_data(mx.nd.array(x, ctx=mx.cpu()), num, axis, even)
    assert all(isinstance(g, NDArray) for g in got)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w)
    assert all(g.as_torch().device == torch.device("cpu") for g in got)


def test_split_data_uneven_raises_in_the_reference_words():
    x = _rand(1, 7, 2)
    with pytest.raises(ValueError) as want:
        jutils.split_data(jmx.nd.array(x), 3)
    with pytest.raises(ValueError) as got:
        utils.split_data(mx.nd.array(x, ctx=mx.cpu()), 3)
    assert str(got.value) == str(want.value) == \
        "batch size 7 not divisible by num_slice 3"
    with pytest.raises(ValueError, match="not divisible"):
        utils.split_and_load(x, [mx.cpu(0), mx.cpu(1)], 0)


@pytest.mark.parametrize("kind", ["numpy", "ndarray", "tensor"])
def test_split_and_load_matches_jax(kind):
    """One context: the whole batch on it; two: one slice each (the port
    names cpu(0) and cpu(1), which are the same device)."""
    x = _rand(2, 6, 4)
    src = {"numpy": lambda: x,
           "ndarray": lambda: mx.nd.array(x, ctx=mx.cpu()),
           "tensor": lambda: torch.from_numpy(x)}[kind]()
    jsrc = jmx.nd.array(x) if kind != "numpy" else x
    for n in (1, 2, 3):
        want = jutils.split_and_load(jsrc, [jmx.cpu(0)] * n)
        got = utils.split_and_load(src, [mx.cpu(i) for i in range(n)])
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert isinstance(g, NDArray) and g.ctx.device_type == "cpu"
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    odd = utils.split_and_load(x[:5], [mx.cpu(0), mx.cpu(1)],
                               even_split=False)
    assert [o.shape[0] for o in odd] == [2, 3]


def _grads(seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * 0.5).astype(np.float32)
            for s in ((3, 4), (7,), (2, 3, 5), (1,))]


@pytest.mark.parametrize("max_norm", [0.5, 2.0, 100.0])
@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_clip_global_norm_matches_jax(max_norm, kind):
    """The norm as a Python float, within ``RTOL`` of the reference's and
    of fp64; the arrays scaled by ``max_norm / (norm + 1e-8)`` only when
    that is below 1, in place."""
    arrays = _grads(3)
    jarr = [jmx.nd.array(a) for a in arrays]
    want_norm = jutils.clip_global_norm(jarr, max_norm)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    got_in = [NDArray(t) for t in ts] if kind == "ndarray" else ts
    norm = utils.clip_global_norm(got_in, max_norm)
    assert isinstance(norm, float)
    f64 = np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a in arrays))
    assert abs(norm - want_norm) <= RTOL * want_norm
    assert abs(norm - f64) <= RTOL * f64
    scale = max_norm / (f64 + 1e-8)
    for t, j, a in zip(ts, jarr, arrays):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=RTOL,
                                   atol=1e-7)
        if scale >= 1.0:
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            np.testing.assert_allclose(t.numpy(), a * scale, rtol=RTOL)


def test_clip_global_norm_on_parameter_gradients():
    """``p.grad`` of the port's parameters (leaves that require grad) are
    scaled in place, as the reference scales a parameter's gradient."""
    net = nn.Dense(3, in_units=4).initialize(ctx=mx.cpu())
    with mx.autograd.record():
        loss = (net(torch.from_numpy(_rand(4, 5, 4))) ** 2).sum()
    loss.backward()
    grads = [p.grad for p in net.parameters()]
    before = [g.clone() for g in grads]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in before)))
    norm = utils.clip_global_norm(grads, 0.1 * total)
    assert abs(norm - total) <= RTOL * total
    for p, b in zip(net.parameters(), before):
        torch.testing.assert_close(p.grad, b * (0.1 * total / (total + 1e-8)),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_clip_global_norm_not_finite_warns_as_the_reference(bad):
    """A NaN norm warns and scales nothing; an infinite one warns and
    scales by 0 (inf * 0 is NaN), on both sides."""
    arrays = _grads(5)
    arrays[1][2] = bad
    jarr = [jmx.nd.array(a) for a in arrays]
    with pytest.warns(UserWarning, match="nan or inf in clip_global_norm"):
        want_norm = jutils.clip_global_norm(jarr, 1.0)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    with pytest.warns(UserWarning, match="nan or inf in clip_global_norm"):
        norm = utils.clip_global_norm(ts, 1.0)
    assert (np.isnan(norm), np.isinf(norm)) == (np.isnan(want_norm),
                                                np.isinf(want_norm))
    for t, j, a in zip(ts, jarr, arrays):
        np.testing.assert_array_equal(t.numpy(), j.asnumpy())
        if np.isnan(bad):
            np.testing.assert_array_equal(t.numpy(), a)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        utils.clip_global_norm([torch.from_numpy(a) for a in arrays], 1.0,
                               check_isfinite=False)


def test_check_sha1_and_download_match_jax(tmp_path):
    f = tmp_path / "weights.params"
    f.write_bytes(b"\x00\x01" * 70000)
    digest = hashlib.sha1(f.read_bytes()).hexdigest()
    for mod in (jutils, utils):
        assert mod.check_sha1(str(f), digest)
        assert not mod.check_sha1(str(f), "0" * 40)
    url = "https://example.com/models/weights.params"
    for path in (str(f), str(tmp_path)):
        assert utils.download(url, path=path) == jutils.download(
            url, path=path) == str(f)
        assert utils.download(url, path=path, sha1_hash=digest) == str(f)
    for kwargs in (dict(path=str(tmp_path / "missing.params")),
                   dict(path=str(f), overwrite=True),
                   dict(path=str(f), sha1_hash="0" * 40)):
        with pytest.raises(RuntimeError) as want:
            jutils.download(url, **kwargs)
        with pytest.raises(RuntimeError) as got:
            utils.download(url, **kwargs)
        assert str(got.value) == str(want.value)
        assert "no network egress" in str(got.value)


def _concurrent(pkg_nn, pkg_contrib, axis):
    out = pkg_contrib.nn.HybridConcurrent(axis=axis)
    inner = pkg_nn.HybridSequential()
    inner.add(pkg_nn.Conv2D(5, 1), pkg_nn.Activation("relu"))
    out.add(pkg_nn.Conv2D(5, 3, padding=1), inner)
    nested = pkg_contrib.nn.Concurrent(axis=axis)
    nested.add(pkg_nn.Conv2D(5, 1, in_channels=5),
               pkg_nn.BatchNorm(in_channels=5))
    out.add(nested)
    return out


@pytest.mark.parametrize("axis", [1, -1])
def test_hybrid_concurrent_matches_jax(axis):
    """The same input to every child, concatenated on ``axis``; children
    named by index (``1.0.weight``, ``2.1.gamma``) as the JAX package's;
    output and gradients within 1e-5 (relative L2) of it."""
    x = _rand(6, 2, 5, 4, 4)
    jnet = _concurrent(jnn, jcontrib, axis)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    params = {n: _rand(7 + i, *p.shape) + (1.0 if n.endswith("var") else 0)
              for i, (n, p) in enumerate(
                  jnet._collect_params_with_prefix().items())}
    for n, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(params[n]))
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jautograd.record():
        yj = jnet(xj)
        (yj * yj).sum().backward()
    net = _concurrent(nn, contrib, axis)
    assert list(dict(net.named_parameters())) == list(params)
    load_jax_params(net, params, ctx=mx.cpu())
    xt = torch.from_numpy(x).requires_grad_()
    with mx.autograd.record():
        y = net(xt)
        (y * y).sum().backward()
    assert tuple(y.shape) == yj.shape
    assert len(net) == 3 and isinstance(net[2], contrib.nn.HybridConcurrent)
    for got, want in [(y, yj.asnumpy()), (xt.grad, xj.grad.asnumpy())] + [
            (p.grad, jnet._collect_params_with_prefix()[n].grad().asnumpy())
            for n, p in net.named_parameters() if p.requires_grad]:
        err = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert err <= 1e-5


def test_sync_batch_norm_is_batch_norm_over_axis_1():
    """``SyncBatchNorm`` normalizes as ``BatchNorm(axis=1)`` and moves its
    running statistics the same, records ``num_devices``, and matches the
    JAX package's ``SyncBatchNorm`` on the same values; ``prefix`` and
    ``params`` wait for the Block surface."""
    x = _rand(8, 4, 3, 5, 5) * 2 + 1
    sbn = contrib.nn.SyncBatchNorm(in_channels=3, num_devices=2,
                                   momentum=0.8).initialize(ctx=mx.cpu())
    bn = nn.BatchNorm(axis=1, in_channels=3,
                      momentum=0.8).initialize(ctx=mx.cpu())
    jsbn = jcontrib.nn.SyncBatchNorm(in_channels=3, num_devices=2,
                                     momentum=0.8)
    jsbn.initialize()
    assert sbn._num_devices == 2
    values = {n: _rand(9 + i, 3) * 0.3 + (1.0 if n in ("gamma",
                                                      "running_var")
                                            else 0.0)
              for i, n in enumerate(("gamma", "beta", "running_mean",
                                     "running_var"))}
    for n, v in values.items():
        jsbn._collect_params_with_prefix()[n].set_data(jmx.nd.array(v))
    load_jax_params(sbn, values, ctx=mx.cpu())
    load_jax_params(bn, values, ctx=mx.cpu())
    with jautograd.record():
        want = jsbn(jmx.nd.array(x)).asnumpy()
    with mx.autograd.record():
        got, plain = sbn(torch.from_numpy(x)), bn(torch.from_numpy(x))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for n in ("running_mean", "running_var"):
        torch.testing.assert_close(tensors_of(sbn)[n],
                                   tensors_of(bn)[n],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(
            tensors_of(sbn)[n].detach().numpy(),
            jsbn._collect_params_with_prefix()[n].data().asnumpy(),
            rtol=1e-5, atol=1e-6)
    with mx.autograd.pause():
        torch.testing.assert_close(sbn(torch.from_numpy(x)),
                                   bn(torch.from_numpy(x)), rtol=0, atol=0)
    assert contrib.nn.SyncBatchNorm(prefix="sbn_").prefix == "sbn_"
    assert list(contrib.nn.SyncBatchNorm(in_channels=2, prefix="sbn_")
                .collect_params())[:2] == ["sbn_gamma", "sbn_beta"]
    assert contrib.nn.HybridConcurrent(axis=1, params=None).params.prefix \
        .startswith("hybrid_concurrent")
