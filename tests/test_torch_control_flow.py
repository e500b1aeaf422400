"""mx.contrib.foreach / while_loop / cond against the JAX package's
``contrib`` on the same numpy inputs: values and gradients, with Dense-cell
bodies (the gluon ``Dense`` of each package holding the same weights)."""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import contrib as jcontrib
from incubator_mxnet_tpu.gluon import nn as jnn

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import contrib
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

B, D, H, T = 3, 4, 5, 6


def _cells():
    """(jax cells, port cells): x -> H and h -> H Dense layers."""
    jx, jh = jnn.Dense(H, in_units=D), jnn.Dense(H, in_units=H,
                                                 use_bias=False)
    for c in (jx, jh):
        c.initialize(init="xavier")
    port = []
    for jc, c in ((jx, nn.Dense(H, in_units=D)),
                  (jh, nn.Dense(H, in_units=H, use_bias=False))):
        load_jax_params(c, {k: p.data().asnumpy() for k, p in
                            jc._collect_params_with_prefix().items()},
                        ctx=mx.cpu())
        port.append(c)
    return (jx, jh), tuple(port)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, B, D).astype(np.float32),
            rs.randn(B, H).astype(np.float32))


def _run(pkg, fn, cells, arrays):
    """``fn(F, cells, *NDArrays)`` under record in ``pkg``; returns the
    output, the gradients of the arrays and of the cells' parameters."""
    m = mx if pkg == "port" else jmx
    kw = {"ctx": mx.cpu()} if pkg == "port" else {}
    nds = [m.nd.array(a, **kw) for a in arrays]
    for x in nds:
        x.attach_grad()
    with m.autograd.record():
        out = fn(contrib if pkg == "port" else jcontrib, cells, *nds)
        loss = sum((o ** 2).sum() for o in out)
    loss.backward()
    grads = [x.grad.asnumpy() for x in nds]
    for c in cells:
        grads += [p.grad().asnumpy() for p in
                  c._collect_params_with_prefix().values()]
    return [o.asnumpy() for o in out], grads


def _compare(fn, arrays, rtol=1e-5, atol=1e-5):
    jcells, cells = _cells()
    jo, jg = _run("jax", fn, jcells, arrays)
    po, pg = _run("port", fn, cells, arrays)
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert len(pg) == len(jg)
    for i, (a, b) in enumerate(zip(pg, jg)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {i}")
    return po, pg


def _rnn(C, cells, xs, h0):
    cx, ch = cells

    def body(x_t, h):
        h = (cx(x_t) + ch(h)).tanh()
        return h, h

    outs, h = C.foreach(body, xs, h0)
    return [outs, h]


def test_foreach_dense_cell_values_and_gradients():
    xs, h0 = _data()
    (outs, h), grads = _compare(_rnn, [xs, h0])
    assert outs.shape == (T, B, H)
    np.testing.assert_array_equal(outs[-1], h)
    assert all(np.abs(g).sum() > 0 for g in grads)


def test_foreach_states_and_outputs_lists():
    def fn(C, cells, xs, a0, b0):
        def body(x, states):
            a, b = states
            return [a + x.sum(), b * 2], [a + x.sum(), b * 2]

        outs, finals = C.foreach(body, xs, [a0, b0])
        return list(outs) + list(finals)

    xs, _ = _data(1)
    a0 = np.zeros((2,), np.float32)
    b0 = np.ones((2,), np.float32)
    out, _ = _compare(fn, [xs[:, 0, :2], a0, b0])
    assert out[0].shape == (T, 2)
    np.testing.assert_allclose(out[3], [2.0 ** T] * 2)


def _counting(C, cells, x, i0, h0, steps=4, max_iterations=7):
    cx, ch = cells

    def func(i, h):
        h = (cx(x) + ch(h)).tanh()
        return h, (i + 1, h)

    outs, (i, h) = C.while_loop(lambda i, h: i < steps, func, (i0, h0),
                                max_iterations=max_iterations)
    return [outs, i, h]


@pytest.mark.parametrize("steps", [0, 4, 7, 9])
def test_while_loop_masked_steps_and_zero_rows(steps):
    xs, h0 = _data(2)
    i0 = np.zeros((1,), np.float32)

    def fn(C, cells, x, i, h):
        return _counting(C, cells, x, i, h, steps=steps)

    (outs, i, h), _ = _compare(fn, [xs[0], i0, h0])
    ran = min(steps, 7)
    assert outs.shape == (7, B, H)
    np.testing.assert_array_equal(outs[ran:], 0.0)
    assert float(i[0]) == ran
    if ran:
        np.testing.assert_array_equal(outs[ran - 1], h)


def test_while_loop_power_gradient_as_the_reference():
    def fn(C, cells, x, i0, a0):
        _, (i, acc) = C.while_loop(lambda i, a: i < 3,
                                   lambda i, a: (a, (i + 1, a * x)),
                                   (i0, a0), max_iterations=5)
        return [acc]

    out, grads = _compare(fn, [np.array([2.0], np.float32),
                               np.array([0.0], np.float32),
                               np.array([1.0], np.float32)])
    np.testing.assert_allclose(out[0], [8.0])
    np.testing.assert_allclose(grads[0], [2 * 8.0 * 3 * 4.0])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_runs_one_branch_and_its_gradient(sign):
    """The other branch's NaN gradient (``sqrt`` of a negative) does not
    leak, as under ``lax.cond``."""
    def fn(C, cells, x):
        cx, _ = cells
        out = C.cond(lambda x: (x.sum() > 0),
                     lambda x: cx(x).tanh() * 2.0,
                     lambda x: cx((-x).sqrt()), [x])
        return [out]

    x = sign * np.abs(_data(3)[1][:, :D]) + sign * 0.1
    out, grads = _compare(fn, [x])
    assert np.isfinite(out[0]).all()
    assert all(np.isfinite(g).all() for g in grads)


def test_cond_without_inputs_runs_only_the_chosen_branch():
    ran = []
    a = mx.nd.array([2.0], ctx=mx.cpu())
    out = contrib.cond(lambda: (a > 1.0).sum() > 0,
                       lambda: (ran.append("then"), a * 3.0)[1],
                       lambda: (ran.append("else"), a)[1])
    np.testing.assert_allclose(out.asnumpy(), [6.0])
    assert ran == ["then"]
    assert mx.nd.contrib.foreach is contrib.foreach
    assert mx.nd.contrib.while_loop is contrib.while_loop
    assert mx.nd.contrib.cond is contrib.cond
