"""Port parity: every optimizer rule, with and without ``multi_precision``.

The JAX package's thirteen rules (SGD, NAG, Adam, AdamW and the nine the
port added: AdaGrad, AdaDelta, RMSProp plain and centered, Ftrl, LAMB,
LARS, Signum, SGLD, DCASGD) each take 3 steps through the ``Updater`` of
each package on the same weights and gradients (numpy, from a seed),
with weight decay, clipping and a gradient rescale. fp32: the weights and
states agree to 1e-5 relative, 1e-6 absolute (fp32 in another order of
operations). ``multi_precision`` with bf16 weights: the fp32 master
weights agree to 1e-5 relative, the bf16 weights within one bf16 step
(2^-7 relative: the cast of masters that differ in their last fp32
bits may round the other way). AdaDelta's master is held to 1e-3: the
JAX package makes the inner state in the weight's type (bf16 zeros, as
``create_state(index, weight)``), so its first step takes ``sqrt(ad +
eps)`` in bf16 before the state turns fp32; the port, like the reference,
makes the state of the fp32 master. SGLD's noise is taken out for the drift
(both packages' noise replaced by zeros); the noise itself is held by its
mean and variance against N(0, lr) in each package, never by its draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import optimizer as jopt

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, optimizer as opt

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -7
SHAPES = [(6, 5), (7,)]
COMMON = dict(wd=1e-3, clip_gradient=0.8, rescale_grad=0.5)
RULES = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01)),
    ("adamw", dict(learning_rate=0.01)),
    ("adagrad", dict(learning_rate=0.1)),
    ("adadelta", dict(rho=0.9)),
    ("rmsprop", dict(learning_rate=0.01, clip_weights=2.0)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    ("lamb", dict(learning_rate=0.01, lower_bound=0.1, upper_bound=5.0)),
    ("lars", dict(learning_rate=0.1, momentum=0.9)),
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd_lh=1e-3)),
    ("signum", dict(learning_rate=0.01, momentum=0.0)),
    ("sgld", dict(learning_rate=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1)),
]
IDS = ["sgd", "nag", "adam", "adamw", "adagrad", "adadelta", "rmsprop",
       "rmsprop_centered", "ftrl", "lamb", "lars", "signum",
       "signum_nomom", "sgld", "dcasgd"]


@pytest.fixture(autouse=True)
def _quiet_sgld(monkeypatch):
    """SGLD's drift alone: both packages' noise is zero."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(
                            shape, dtype))
    monkeypatch.setattr(opt.SGLD, "_noise",
                        staticmethod(lambda w, lr: torch.zeros_like(w)))


def _data(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rs.randn(*s).astype(np.float32) * 1.5 for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _states_np(state):
    """Every array of a state (nested tuples), as fp32 numpy."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [a for s in state for a in _states_np(s)]
    if isinstance(state, torch.Tensor):
        return [state.detach().float().numpy()]
    return [np.asarray(state, np.float32)]


def _run(name, kw, dtype, multi_precision=False):
    """Three steps in each package; returns (JAX weights, port weights,
    JAX states, port states) as fp32 numpy."""
    ws, gs = _data(0)
    kw = dict(kw, **COMMON, multi_precision=multi_precision)
    jo, to = jopt.create(name, **kw), opt.create(name, **kw)
    ju, tu = jopt.get_updater(jo), opt.get_updater(to)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jw = [jmx.nd.NDArray(jnp.asarray(w, jd)) for w in ws]
    tw = [torch.from_numpy(w).to(td) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            ju(i, jmx.nd.NDArray(jnp.asarray(g, jd)), jw[i])
            tu(i, torch.from_numpy(g).to(td), tw[i])
    return ([np.asarray(w._data, np.float32) for w in jw],
            [w.float().numpy() for w in tw],
            [_states_np(ju.states[i]) for i in range(len(ws))],
            [_states_np(tu.states[i]) for i in range(len(ws))])


@pytest.mark.parametrize("name, kw", RULES, ids=IDS)
def test_three_fp32_steps_match_jax(name, kw):
    jw, tw, js, ts = _run(name, kw, "float32")
    for w, g in zip(jw, tw):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for a, b in zip(js, ts):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name, kw", RULES, ids=IDS)
def test_three_bf16_steps_with_fp32_master_weights_match_jax(name, kw):
    jw, tw, js, ts = _run(name, kw, "bfloat16", multi_precision=True)
    for w, g in zip(jw, tw):
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-6)
    for a, b in zip(js, ts):
        # (master, inner state...): the master is fp32 in both packages
        assert len(b) >= 1 and len(a) == len(b)
        rtol = 1e-3 if name == "adadelta" else RTOL
        np.testing.assert_allclose(b[0], a[0], rtol=rtol, atol=ATOL)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_allclose(y, x, rtol=rtol, atol=ATOL)


def test_multi_precision_keeps_an_fp32_master_and_casts_the_weight():
    o = opt.create("adam", learning_rate=0.1, multi_precision=True)
    w = torch.randn(5, 3).bfloat16()
    st = o.create_state_multi_precision(0, w)
    assert st[0].dtype == torch.float32 and torch.equal(st[0].bfloat16(), w)
    assert st[0].data_ptr() != w.data_ptr()
    st = o.update_multi_precision(0, w, torch.randn(5, 3).bfloat16(), st)
    assert torch.equal(w, st[0].bfloat16())
    # a row-sparse gradient is densified under a master weight
    g = torch.sparse_coo_tensor([[1, 3]], torch.ones(2, 3), (5, 3))
    st = o.update_multi_precision(0, w, g.bfloat16(), st)
    assert torch.equal(w, st[0].bfloat16())
    # an fp32 weight keeps the rule's own state
    assert len(o.create_state_multi_precision(1, torch.zeros(3))) == 2


def test_dcasgd_previous_weight_is_a_copy():
    o = opt.create("dcasgd", learning_rate=0.1)
    w = torch.randn(4)
    _, prev = o.create_state(0, w)
    assert torch.equal(prev, w) and prev.data_ptr() != w.data_ptr()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sgld_noise_has_the_langevin_moments(pkg, monkeypatch):
    """One SGLD step from a zero gradient with no weight decay moves each
    weight by its noise alone: N(0, lr). Mean and variance over 2^18
    draws within 6 standard errors."""
    monkeypatch.undo()
    n, lr = 2 ** 18, 0.04
    if pkg == "jax":
        jmx.random.seed(3)
        o = jopt.create("sgld", learning_rate=lr)
        w = jmx.nd.NDArray(jnp.zeros((n,), jnp.float32))
        jopt.get_updater(o)(0, jmx.nd.NDArray(jnp.zeros((n,))), w)
        d = np.asarray(w._data)
    else:
        mx.random.seed(3)
        o = opt.create("sgld", learning_rate=lr)
        w = torch.zeros(n)
        opt.get_updater(o)(0, torch.zeros(n), w)
        d = w.numpy()
    se_mean = np.sqrt(lr / n)
    se_var = lr * np.sqrt(2.0 / n)
    assert abs(d.mean()) < 6 * se_mean
    assert abs(d.var() - lr) < 6 * se_var


def _mlp(seed):
    """A small net in each package with the same weights."""
    from incubator_mxnet_tpu.gluon import nn as jnn

    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
    from incubator_mxnet_tpu.parallel.spmd import collect_params

    jmx.random.seed(seed)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu", in_units=8), jnn.Dense(4,
                                                                    in_units=16))
    jnet.initialize(init="xavier")
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8), nn.Dense(4,
                                                                  in_units=16))
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    load_jax_params(net, params, ctx=mx.cpu())
    return jnet, net


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["lamb", "rmsprop", "ftrl"])
def test_gluon_trainer_steps_match_jax(name, fused):
    """``gluon.Trainer`` (FusedStep, or the per-parameter path) over a
    small net, 3 steps, against the JAX package's Trainer."""
    from incubator_mxnet_tpu import gluon as jgluon

    jnet, net = _mlp(1)
    hyper = dict(learning_rate=0.01, wd=1e-3)
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(hyper))
    with mx.cpu():
        tr = gluon.Trainer(net.collect_params(), name, dict(hyper))
        tr.fused_step(fused)
        rs = np.random.RandomState(2)
        for _ in range(3):
            x = rs.randn(8, 8).astype(np.float32)
            with jmx.autograd.record():
                jl = (jnet(jmx.nd.array(x)) ** 2).mean()
            jl.backward()
            jtr.step(8)
            with mx.autograd.record():
                tl = (net(mx.nd.array(x, ctx=mx.cpu())) ** 2).mean()
            tl.backward()
            tr.step(8)
    assert tr._fused.last_fallback is None if fused else True
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    from incubator_mxnet_tpu.parallel.spmd import collect_params

    for n, p in collect_params(jnet).items():
        np.testing.assert_allclose(got[n], p.data().asnumpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_fused_step_falls_back_for_master_weights():
    with mx.cpu():
        net = gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=mx.cpu())
        net.cast("bfloat16")
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.1, "multi_precision": True})
        x = mx.nd.array(np.ones((2, 4), np.float32), ctx=mx.cpu(),
                        dtype="bfloat16")
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
    assert tr._fused.last_fallback == "multi_precision master weights"
    st = tr._updater.states[0]
    assert st[0].dtype == torch.float32
    assert torch.equal(net.weight.detach(), st[0].bfloat16())
