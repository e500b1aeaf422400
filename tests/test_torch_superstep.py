"""Port parity: the superstep engine of ``parallel.SPMDTrainer``.

The port's ``parallel/superstep.py`` window helpers against the JAX
package's on the same numpy batches; ``run_superstep`` and ``run_steps``
against the JAX package's on a deterministic MLP (8 -> 16 -> 4, sgd with
momentum 0.9, K=5) and a 2-layer, 64-unit GPT without dropout, the weights
drawn in the JAX package and carried into the port. On the CPU the port
runs the same step body K times (the CUDA-graph path is the card's,
``tests/test_torch_graph_capture.py``). Then the port's own contract, as
the JAX package's ``tests/test_superstep.py`` states it: ``run_superstep``
bit-equal to K ``step()`` calls with dropout on, the generator advanced as
K steps, ``MXTPU_SUPERSTEP=0`` the same stream, a failed dispatch rolled
back.

Tolerances: the MLP's [K] losses and final parameters 1e-5 relative, the
GPT's 1e-4 relative (fp32 on both sides, other orders of summation; the
JAX package takes its dense attention at this length, the port the plain
version of its flash kernels).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.parallel import superstep as jss
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, parallel
from incubator_mxnet_tpu_torch import random as prandom
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.parallel import superstep as ss

K = 5
MLP_TOL = dict(rtol=1e-5, atol=1e-7)
GPT_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})


@pytest.fixture(autouse=True)
def _knob():
    yield
    config.unset("MXTPU_SUPERSTEP")


def _batches(n, seed=3, batch=16, dim=8, classes=4):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, dim).astype(np.float32),
             rs.randint(0, classes, (batch,)).astype(np.float32))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# window helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [K, 3], ids=["full", "short_tail"])
def test_window_helpers_match_jax(n):
    """``stack_window``, ``window_len`` and ``slice_window`` on the same
    batches: a full window and the short window of an epoch's tail."""
    batches = _batches(n, seed=7)
    want = jss.stack_window(batches)
    got = ss.stack_window(batches)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ss.window_len(got) == jss.window_len(want) == n
    import jax.numpy as jnp

    jw = [jnp.asarray(a) for a in want]
    tw = [torch.from_numpy(a) for a in got]
    for i in range(n):
        for g, w in zip(ss.slice_window(tw, i), jss.slice_window(jw, i)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a bare (non-tuple) batch stacks into one leaf
    np.testing.assert_array_equal(ss.stack_window([b[0] for b in batches])[0],
                                  jss.stack_window([b[0] for b in
                                                    batches])[0])


def test_window_helpers_raise_as_jax():
    a, b = np.zeros((4, 2)), np.zeros((3, 2))
    for mod in (jss, ss):
        with pytest.raises(ValueError, match="leading"):
            mod.window_len([a, b])
        with pytest.raises(ValueError, match="empty"):
            mod.stack_window([])


# ---------------------------------------------------------------------------
# run_superstep / run_steps against the JAX package
# ---------------------------------------------------------------------------
def _jax_mlp(seed=0):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, in_units=8, activation="relu"),
            jnn.Dense(4, in_units=16))
    net.initialize(init="xavier")
    return net


def _jax_params(jnet):
    return {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}


def _port_mlp(jnet, dropout=0.0):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(4, in_units=16))
    params = _jax_params(jnet)
    if dropout:          # the Dropout layer shifts the second Dense's name
        params = {n.replace("1.", "2.", 1) if n.startswith("1.") else n: v
                  for n, v in params.items()}
    return load_jax_params(net, params, ctx=mx.cpu())


def _pair(kind):
    if kind == "mlp":
        jnet = _jax_mlp(seed=1)
        net = _port_mlp(jnet)
        jce, ce = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                   gluon.loss.SoftmaxCrossEntropyLoss())
        return jnet, net, jce, ce, _batches(K, seed=11), MLP_TOL
    np.random.seed(2)
    jmx.random.seed(2)
    jnet = jax_get_gpt("gpt_decoder_tiny", vocab_size=61, units=64,
                       num_layers=2, max_length=48, dropout=0.0)
    jnet.initialize(init="xavier")
    jnet(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    net = load_jax_params(
        get_gpt("gpt_decoder_tiny", vocab_size=61, units=64, num_layers=2,
                max_length=48, dropout=0.0), _jax_params(jnet),
        ctx=mx.cpu())
    jce0, ce0 = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                 gluon.loss.SoftmaxCrossEntropyLoss())
    rs = np.random.RandomState(5)
    batches = [(rs.randint(0, 61, (8, 12)).astype(np.int32),
                rs.randint(0, 61, (8, 12)).astype(np.float32))
               for _ in range(K)]
    return (jnet, net, lambda lg, lb: jce0(lg, lb).mean(),
            lambda lg, lb: ce0(lg, lb).mean(), batches, GPT_TOL)


@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_run_superstep_matches_jax(kind):
    """One window of K distinct batches: the [K] losses and the final
    parameters of both packages' ``run_superstep``."""
    jnet, net, jloss, loss, batches, tol = _pair(kind)
    jst = jparallel.SPMDTrainer(jnet, jloss, *SGD[:1], dict(SGD[1]))
    st = parallel.SPMDTrainer(net, loss, *SGD[:1], dict(SGD[1]))
    win = ss.stack_window(batches)
    want = np.asarray(jst.run_superstep(*jss.stack_window(batches)))
    got = st.run_superstep(win[0], win[1])
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert st.superstep_window == K
    for n, v in jst.params.items():
        np.testing.assert_allclose(st.params[n].detach().numpy(),
                                   np.asarray(v), err_msg=n, **tol)


@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_run_steps_matches_jax(kind):
    """``run_steps(K)`` on one batch: the last loss and the parameters."""
    jnet, net, jloss, loss, batches, tol = _pair(kind)
    jst = jparallel.SPMDTrainer(jnet, jloss, *SGD[:1], dict(SGD[1]))
    st = parallel.SPMDTrainer(net, loss, *SGD[:1], dict(SGD[1]))
    x, y = batches[0]
    want = float(jst.run_steps(K, x, y))
    got = st.run_steps(K, x, y)
    np.testing.assert_allclose(float(got), want, **tol)
    for n, v in jst.params.items():
        np.testing.assert_allclose(st.params[n].detach().numpy(),
                                   np.asarray(v), err_msg=n, **tol)


# ---------------------------------------------------------------------------
# the port's own contract (the JAX package's tests/test_superstep.py)
# ---------------------------------------------------------------------------
def _trainer(dropout=False, seed=0):
    net = _port_mlp(_jax_mlp(seed), dropout=0.3 if dropout else 0.0)
    return parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                *SGD[:1], dict(SGD[1]))


def test_run_superstep_bit_exact_vs_step_calls_with_dropout():
    batches = _batches(K)
    ta = _trainer(dropout=True)
    mx.random.seed(42)
    ref = torch.stack([ta.step(x, y) for x, y in batches])
    tb = _trainer(dropout=True)
    mx.random.seed(42)
    win = ss.stack_window(batches)
    got = tb.run_superstep(win[0], win[1])
    assert torch.equal(ref, got)
    for n in ta.params:
        assert torch.equal(ta.params[n], tb.params[n]), n


def test_run_superstep_generator_advances_like_k_steps():
    """Draws after a superstep continue where K ``step()`` calls leave
    the generator (dropout on, so each step draws)."""
    batches = _batches(3, seed=9)
    ta = _trainer(dropout=True)
    mx.random.seed(7)
    for x, y in batches:
        ta.step(x, y)
    after_steps = torch.rand(4, generator=prandom.generator(mx.cpu()))
    tb = _trainer(dropout=True)
    mx.random.seed(7)
    win = ss.stack_window(batches)
    tb.run_superstep(win[0], win[1])
    after_super = torch.rand(4, generator=prandom.generator(mx.cpu()))
    assert torch.equal(after_steps, after_super)


def test_superstep_knob_off_falls_back_same_stream(monkeypatch):
    """``MXTPU_SUPERSTEP=0``: the same K ``step()`` calls (the path
    choice says eager even where the card would capture)."""
    win = ss.stack_window(_batches(4, seed=11))
    ta = _trainer(dropout=True)
    mx.random.seed(5)
    fused = ta.run_superstep(win[0], win[1])
    config.set("MXTPU_SUPERSTEP", "0")
    assert ss.step_path(torch.device("cuda", 0)) == "eager"
    calls = []
    tb = _trainer(dropout=True)
    orig = tb.step
    monkeypatch.setattr(tb, "step", lambda x, y: calls.append(1)
                        or orig(x, y))
    mx.random.seed(5)
    eager = tb.run_superstep(win[0], win[1])
    assert len(calls) == 4
    assert torch.equal(fused, eager)
    config.unset("MXTPU_SUPERSTEP")
    assert ss.step_path(torch.device("cuda", 0)) == "graph"
    assert ss.step_path(torch.device("cpu")) == "eager"


def test_run_superstep_dispatch_failure_rolls_back_generator(monkeypatch):
    """A dispatch that fails (here a capture that drew dropout masks and
    then broke) runs no step: it raises, the generator goes back, and the
    retry of the same window gives the run that never failed."""
    win = ss.stack_window(_batches(3, seed=23))
    ref_tr = _trainer(dropout=True)
    mx.random.seed(13)
    ref = ref_tr.run_superstep(win[0], win[1])

    def broken_capture(body, k, state, device, **kw):
        torch.rand(100, generator=prandom.generator(mx.cpu()))
        raise RuntimeError("capture failed")

    tr = _trainer(dropout=True)
    mx.random.seed(13)
    monkeypatch.setattr(ss, "step_path", lambda device: "graph")
    monkeypatch.setattr(ss, "capture_steps", broken_capture)
    with pytest.raises(RuntimeError, match="capture failed"):
        tr.run_superstep(win[0], win[1])
    monkeypatch.undo()
    got = tr.run_superstep(win[0], win[1])
    assert torch.equal(ref, got)
    for n in ref_tr.params:
        assert torch.equal(ref_tr.params[n], tr.params[n]), n


# ---------------------------------------------------------------------------
# the capture helpers' bookkeeping (the capture itself is the card's)
# ---------------------------------------------------------------------------
class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle


def test_launch_counts_of_a_capture_go_to_its_recording(monkeypatch):
    """A launch into a stream a recording captures counts into the
    recording and on no counter; a launch into another stream, or after
    the recording closed, counts as it runs; ``add`` puts a recording on
    the counters (what every replay does)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import launches

    name = "incubator_mxnet_tpu_torch.ops.flash_attention"
    current = {"stream": _Stream(11), "capturing": True}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: current["capturing"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: current["stream"])
    c0 = launches.snapshot()
    with launches.recording(_Stream(11)) as rec:
        launches.count(name, "flash_fwd_tc_launches", "flash_fwd_launches")
        launches.count("rtc", "scale")
        current["stream"] = _Stream(12)          # another thread's stream
        launches.count(name, "flash_fwd_split_launches",
                       "flash_fwd_launches")
        with pytest.raises(RuntimeError, match="already open"):
            with launches.recording(_Stream(11)):
                pass
    assert rec == {(name, "flash_fwd_tc_launches"): 1,
                   (name, "flash_fwd_launches"): 1, ("rtc", "scale"): 1}
    assert launches.delta(c0, launches.snapshot()) == {
        (name, "flash_fwd_split_launches"): 1, (name, "flash_fwd_launches"): 1}
    current["stream"] = _Stream(11)
    launches.count(name, "flash_fwd_tc_launches")   # no recording open
    launches.add(rec, 2)
    assert launches.delta(c0, launches.snapshot()) == {
        (name, "flash_fwd_split_launches"): 1, (name, "flash_fwd_launches"): 3,
        (name, "flash_fwd_tc_launches"): 3, ("rtc", "scale"): 2}
    assert fa.flash_fwd_tc_launches == c0[name, "flash_fwd_tc_launches"] + 3


class _FakeGraph:
    """Stands in for a captured StepGraph: a replay calls the bodies."""

    def __init__(self, body, k):
        self.body, self.k, self.counted = body, k, {}

    def current(self):
        return True

    def replay(self):
        return [self.body(i) for i in range(self.k)]


def test_graph_cache_keys_fills_and_evicts(monkeypatch):
    """``GraphCache.run``: a miss captures over fresh static buffers; a
    hit copies the new inputs into the cached graph's buffers; another
    input signature or K is another graph; past ``size`` graphs the least
    recently used goes; a state that moved drops the graphs of its old
    address."""
    captures = []

    def fake_capture(body, k, state, device, capture_error_mode="global"):
        captures.append(k)
        return _FakeGraph(body, k)

    monkeypatch.setattr(ss, "capture_steps", fake_capture)
    cache = ss.GraphCache(torch.device("cpu"), size=2)
    w = torch.zeros(3)

    def body_of(static):
        return lambda i: static[0][i] + w.sum()

    a = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(torch.stack(cache.run("x", [a], body_of, 2, [w])), a)
    b = a + 10
    assert torch.equal(torch.stack(cache.run("x", [b], body_of, 2, [w])), b)
    assert captures == [2] and len(cache) == 1        # a hit
    cache.run("x", [a[:1]], body_of, 1, [w])         # a short tail window
    cache.run("x", [a.double()], body_of, 2, [w])    # another dtype
    assert captures == [2, 1, 2] and len(cache) == 2  # the first went
    assert [g.k for g in cache.graphs()] == [1, 2]
    w2 = torch.ones(3)                               # the state moved
    cache.run("x", [a], body_of, 2, [w2])
    assert captures == [2, 1, 2, 2] and len(cache) == 1
