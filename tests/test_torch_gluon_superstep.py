"""Port parity: the gluon step engines (FusedStep, SuperStep) and the
optimizers' functional core.

``update_fn`` of SGD, NAG, Adam and AdamW against the JAX package's on the
same numpy ``(w, g, states, lr, wd, t)``, to 1e-6 relative. The SuperStep
(``Trainer.superstep(net, loss_fn, window).run_window``) fused against its
eager path (``MXTPU_SUPERSTEP=0``: forward, backward, ``Trainer.step(1)``)
over two windows, as the JAX package's
``test_gluon_superstep_fused_matches_eager``: bit for bit here (the same
``update_fn`` serves both paths), and against the JAX package's fused
window to 1e-5 (other orders of summation). The fallback reasons and
``dispatch_count``. FusedStep against the per-parameter path of the same
rule, bit for bit (``Optimizer.update`` is the functional core over a
list of one parameter). On the CPU the SuperStep
calls its step body K times; the card captures it
(``tests/test_torch_graph_capture.py``).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu.optimizer as jopt
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.parallel import superstep as jss
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
import incubator_mxnet_tpu_torch.optimizer as popt
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.parallel import superstep as ss

K = 4
RULES = [
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.0, "clip_gradient": 0.3}),
    ("nag", {"momentum": 0.9}),
    ("nag", {"momentum": 0.0}),
    ("adam", {"beta1": 0.8, "epsilon": 1e-6}),
    ("adam", {"clip_gradient": 0.2}),
    ("adamw", {}),
    ("adamw", {"beta2": 0.99, "clip_gradient": 0.5}),
]
IDS = [f"{n}_{i}" for i, (n, _) in enumerate(RULES)]
TRAIN = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.05}),
    ("adamw", {"learning_rate": 0.05, "wd": 1e-2}),
]


@pytest.fixture(autouse=True)
def _knob():
    yield
    config.unset("MXTPU_SUPERSTEP")


@pytest.mark.parametrize("name,kw", RULES, ids=IDS)
@pytest.mark.parametrize("t", [1.0, 7.0])
def test_update_fn_matches_jax(name, kw, t):
    import jax.numpy as jnp

    rs = np.random.RandomState(int(t) + len(kw))
    w = rs.randn(6, 5).astype(np.float32)
    g = rs.randn(6, 5).astype(np.float32)
    jo, po = jopt.create(name, **kw), popt.create(name, **kw)
    n_states = len(jo._pack_state(jo.create_state(0, jmx.nd.array(w))))
    states = [rs.rand(6, 5).astype(np.float32) for _ in range(n_states)]
    lr, wd = 0.05, 0.01
    jw, jst = jo.update_fn(jnp.asarray(w), jnp.asarray(g),
                           tuple(jnp.asarray(s) for s in states),
                           jnp.float32(lr), jnp.float32(wd), jnp.float32(t))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    gt = torch.from_numpy(g.copy())
    pw, pst = po.update_fn(torch.from_numpy(w.copy()), gt,
                           tuple(torch.from_numpy(s.copy()) for s in states),
                           f32(lr), f32(wd), f32(t))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    assert len(pst) == len(jst)
    for a, b in zip(pst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert torch.equal(gt, torch.from_numpy(g))    # the gradient is left


def test_update_fn_takes_a_list_in_place():
    """The list form updates every weight and state in place, as the
    single form does for each."""
    rs = np.random.RandomState(0)
    ws = [torch.from_numpy(rs.randn(*s).astype(np.float32))
          for s in ((3, 4), (5,), (2, 2, 2))]
    gs = [torch.from_numpy(rs.randn(*w.shape).astype(np.float32))
          for w in ws]
    opt = popt.create("adam")
    one = [(w.clone(), opt._pack_state(opt.create_state(0, w))) for w in ws]
    states = [opt._pack_state(opt.create_state(0, w)) for w in ws]
    scal = [torch.tensor(v) for v in (0.1, 0.01, 3.0)]
    out_ws, out_states = opt.update_fn(ws, gs, states, *scal)
    assert all(a is b for a, b in zip(out_ws, ws))
    for (w1, st1), w, st, g in zip(one, ws, states, gs):
        opt.update_fn(w1, g, st1, *scal)
        assert torch.equal(w1, w)
        for a, b in zip(st1, st):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SuperStep
# ---------------------------------------------------------------------------
def _batches(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.rand(16, 8).astype(np.float32),
             rs.randint(0, 4, (16,)).astype(np.float32)) for _ in range(n)]


def _jax_net(seed=1):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, in_units=8, activation="relu"),
            jnn.Dense(4, in_units=16))
    net.initialize(init="xavier")
    net(jmx.nd.uniform(shape=(4, 8)))
    return net


def _port(jnet, opt, kw):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(4, in_units=16))
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          collect_params(jnet).items()}, ctx=mx.cpu())
    return net, gluon.Trainer(net.collect_params(), opt, dict(kw))


@pytest.mark.parametrize("opt,kw", TRAIN, ids=[c[0] for c in TRAIN])
def test_gluon_superstep_fused_matches_eager(opt, kw):
    wins = [ss.stack_window(_batches(K, s)) for s in (3, 17)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    jnet = _jax_net()

    net_f, tr_f = _port(jnet, opt, kw)
    eng_f = tr_f.superstep(net_f, loss_fn, window=K)
    lf = torch.cat([eng_f.run_window(w[0], w[1]) for w in wins])
    assert eng_f.dispatch_count == 2, eng_f.last_fallback
    assert eng_f.last_fallback is None

    config.set("MXTPU_SUPERSTEP", "0")
    net_e, tr_e = _port(jnet, opt, kw)
    eng_e = tr_e.superstep(net_e, loss_fn, window=K)
    le = torch.cat([eng_e.run_window(w[0], w[1]) for w in wins])
    config.unset("MXTPU_SUPERSTEP")
    assert eng_e.dispatch_count == 0
    assert eng_e.last_fallback == "MXTPU_SUPERSTEP off"
    assert lf.shape == (2 * K,) and lf.dtype == torch.float32
    assert torch.equal(lf, le)
    for a, b in zip(net_f.parameters(), net_e.parameters()):
        assert torch.equal(a, b)

    # the JAX package's fused window on the same weights and batches
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(kw))
    jeng = jtr.superstep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                         window=K)
    lj = np.concatenate([np.asarray(jeng.run_window(*jss.stack_window(
        _batches(K, s)))) for s in (3, 17)])
    np.testing.assert_allclose(lf.numpy(), lj, rtol=1e-5, atol=1e-6)
    want = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    for n, p in net_f.collect_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_gluon_superstep_fallback_reasons():
    jnet = _jax_net()
    net, tr = _port(jnet, "adam", {"learning_rate": 0.05})
    eng = tr.superstep(net, gluon.loss.SoftmaxCrossEntropyLoss(), window=2)
    assert eng.window == 2
    win = ss.stack_window(_batches(2, seed=5))
    # amp loss scaling pins the eager path (the JAX package's taxonomy)
    tr._amp_loss_scaler = object()
    losses = eng.run_window(win[0], win[1])
    assert eng.dispatch_count == 0
    assert eng.last_fallback == "amp loss scaling"
    assert losses.shape == (2,)
    del tr._amp_loss_scaler
    eng.run_window(win[0], win[1])
    assert eng.dispatch_count == 1
    assert eng.last_fallback is None   # stale reason cleared on engage

    # a parameter the trainer does not own
    other = nn.Dense(4, in_units=16)
    other.initialize(ctx=mx.cpu())
    tr2 = gluon.Trainer(other.collect_params(), "sgd")
    eng2 = tr2.superstep(net, gluon.loss.SoftmaxCrossEntropyLoss(), window=2)
    assert not eng2._engageable()
    assert eng2.last_fallback.startswith("net parameter 0.weight not owned")

    # a rule without a functional core
    @popt.register
    class CorelessSGD(popt.SGD):
        _has_fused_core = False

    net3, tr3 = _port(jnet, "corelesssgd", {"learning_rate": 0.1})
    eng3 = tr3.superstep(net3, gluon.loss.SoftmaxCrossEntropyLoss(),
                         window=2)
    eng3.run_window(win[0], win[1])
    assert eng3.dispatch_count == 0
    assert eng3.last_fallback == "optimizer has no functional core"
    assert tr3._fused.last_fallback == "optimizer has no functional core"

    config.set("MXTPU_SUPERSTEP", "off")
    eng.run_window(win[0], win[1])
    assert eng.last_fallback == "MXTPU_SUPERSTEP off"
    assert eng.dispatch_count == 1
    with pytest.raises(NotImplementedError, match="data pipeline"):
        eng.feed([])
    with pytest.raises(NotImplementedError, match="ZeRO"):
        tr.fused_step(zero_stage=2)


@pytest.mark.parametrize("opt,kw", TRAIN, ids=[c[0] for c in TRAIN])
def test_fused_step_matches_per_parameter_update(opt, kw):
    """Three ``Trainer.step`` calls through FusedStep (one dispatch a step)
    against the same calls on the per-parameter path
    (``fused_step(False)``)."""
    jnet = _jax_net(seed=4)
    out = []
    for fused in (True, False):
        net, tr = _port(jnet, opt, kw)
        tr.fused_step(fused)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in _batches(3, seed=8):
            with mx.autograd.record():
                loss = ce(net(torch.from_numpy(x)), torch.from_numpy(y))
            mx.autograd.backward(loss)
            tr.step(x.shape[0])
        assert tr._fused.dispatch_count == (3 if fused else 0)
        out.append([p.detach().clone() for p in net.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)
