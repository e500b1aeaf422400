"""Port parity: the autograd tape API, custom ops and the imperative step.

The same program runs in the JAX package and in the port (on the CPU),
on the same numpy inputs, and the results are compared:

* ``autograd.backward``/``grad`` on NDArrays, ``mark_variables``,
  ``grad_req`` ``write``/``add``, head gradients, higher-order gradients,
  and a custom ``autograd.Function``;
* ``mx.operator`` custom ops through ``mx.nd.Custom``, among them the
  softmax cross entropy that the port's ``"softmax_ce_rtc"`` op computes
  with two runtime-compiled CUDA kernels on the card (its plain version
  here), held against the same op written with the JAX package's NDArray
  ops;
* the slice at small size: one imperative training step of a 2-layer,
  64-unit GPT (vocab 97), ``autograd.record`` -> ``net(tokens)`` ->
  ``mx.nd.Custom(..., op_type=...)`` -> ``backward`` ->
  ``gluon.Trainer.step``, with the weights carried across by
  ``load_jax_params``.

Tolerances: 1e-5 relative and 1e-6 absolute for the small programs; the
GPT step's loss, gradients and updated weights 1e-4 relative and 1e-5
absolute (fp32 on both sides, sums in other orders over 12 layers of
matrix products).
"""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import operator as jop
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, operator
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.ops import rtc_kernels

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _np(x):
    return np.asarray(x.asnumpy())


# ---------------------------------------------------------------------------
# the autograd tape API: each program runs on either package
# ---------------------------------------------------------------------------
def _simple(pkg):
    x = pkg.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x * 2).sum()
    y.backward()
    return [y, x.grad]


def _branches(pkg):
    x = pkg.nd.array([[1.0, 2.0], [3.0, 4.0]])
    x.attach_grad()
    with pkg.autograd.record():
        a = x * 2
        b = a + x
        y = (b * b).sum()
    y.backward()
    return [x.grad]


def _head_gradient(pkg):
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 3
    y.backward(pkg.nd.array([1.0, 10.0]))
    return [x.grad]


def _grad_req_add(pkg):
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
    return [x.grad]


def _grad_req_write(pkg):
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad()
    for _ in range(3):
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
    return [x.grad]


def _multiple_heads(pkg):
    x = pkg.nd.array([2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y1 = x * 2
        y2 = x * 3
    pkg.autograd.backward([y1, y2])
    return [x.grad]


def _grad_api(pkg):
    x = pkg.nd.array([3.0, -1.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
    (gx,) = pkg.autograd.grad(y, [x])
    return [gx, x.grad]                  # .grad untouched by grad()


def _higher_order(pkg):
    x = pkg.nd.array([2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
        gx = pkg.autograd.grad(y, [x], create_graph=True)[0]
        z = gx.sum()
    z.backward()
    return [gx, x.grad]


def _mark_variables(pkg):
    x = pkg.nd.array([1.0, 2.0])
    y = pkg.nd.array([4.0, -1.0])
    gx, gy = pkg.nd.zeros((2,)), pkg.nd.zeros((2,))
    pkg.autograd.mark_variables([x, y], [gx, gy], grad_reqs=["write", "add"])
    for _ in range(2):
        with pkg.autograd.record():
            z = (x * 5 * y + y).sum()
        z.backward()
    return [x.grad, y.grad, gx, gy]      # the buffers given are the grads


def _pause(pkg):
    x = pkg.nd.array([1.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 2
        with pkg.autograd.pause():
            c = y * 100
        z = (y + c.detach() * 0).sum()
    z.backward()
    return [x.grad]


def _custom_function(pkg):
    class ScaledProduct(pkg.autograd.Function):
        """(a * b, a + 2 b) with a hand-written backward."""

        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + 2 * b

        def backward(self, d_prod, d_sum):
            a, b = self.saved_tensors
            return d_prod * b + d_sum, d_prod * a + 2 * d_sum

    rs = np.random.RandomState(3)
    a = pkg.nd.array(rs.randn(3).astype(np.float32))
    b = pkg.nd.array(rs.randn(3).astype(np.float32))
    a.attach_grad()
    b.attach_grad()
    f = ScaledProduct()
    with pkg.autograd.record():
        p, s = f(a, b)
        loss = (p * 3 + s * s).sum()
    loss.backward()
    return [p, s, a.grad, b.grad]


PROGRAMS = [_simple, _branches, _head_gradient, _grad_req_add,
            _grad_req_write, _multiple_heads, _grad_api, _higher_order,
            _mark_variables, _pause, _custom_function]


@pytest.mark.parametrize("program", PROGRAMS,
                         ids=[p.__name__.lstrip("_") for p in PROGRAMS])
def test_autograd_program_matches_jax(program):
    got, want = program(mx), program(jmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_no_record_no_grad_in_both():
    for pkg in (mx, jmx):
        x = pkg.nd.array([1.0])
        x.attach_grad()
        y = x * 2                                   # outside record
        with pytest.raises(ValueError):
            y.backward()
        with pytest.raises(ValueError):
            pkg.autograd.grad((pkg.nd.array([1.0]) * 2), [pkg.nd.array([1.])])


def test_function_without_recording_runs_forward_only():
    class Double(mx.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            raise AssertionError("no backward outside record")

    out = Double()(mx.nd.array([1.0, 2.0]))
    np.testing.assert_array_equal(out.asnumpy(), [2.0, 4.0])


# ---------------------------------------------------------------------------
# custom ops
# ---------------------------------------------------------------------------
def _square_prop(pkg_op):
    class SquareProp(pkg_op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Square(pkg_op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.0 * in_data[0] * out_grad[0])

            return Square()
    return SquareProp


def _softmax_ce_prop(pkg, pkg_op):
    """The softmax cross entropy of ``"softmax_ce_rtc"``, written with
    NDArray ops."""

    class SoftmaxCE(pkg_op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], pkg.nd.softmax(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - pkg.nd.one_hot(in_data[1], y.shape[1]))

    class SoftmaxCEProp(pkg_op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def infer_type(self, in_type):
            return in_type, [in_type[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxCE()

    return SoftmaxCEProp


jop.register("torch_parity_square")(_square_prop(jop))
operator.register("torch_parity_square")(_square_prop(operator))
jop.register("torch_parity_softmax_ce")(_softmax_ce_prop(jmx, jop))
operator.register("torch_parity_softmax_ce")(_softmax_ce_prop(mx, operator))


def test_custom_op_square_matches_jax():
    res = {}
    for pkg in (jmx, mx):
        x = pkg.nd.array(np.array([1.0, -2.0, 3.0], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(x, op_type="torch_parity_square")
        y.backward(pkg.nd.array([1.0, 0.5, -1.0]))
        res[pkg] = [y, x.grad]
    for g, w in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    np.testing.assert_allclose(_np(res[mx][1]), [2.0, -2.0, -6.0])


def test_custom_op_unknown_type_raises():
    for pkg in (mx, jmx):
        with pytest.raises(ValueError):
            pkg.nd.Custom(pkg.nd.array([1.0]), op_type="no_such_op")


@pytest.mark.parametrize("labels", [3, 5])
def test_custom_op_refuses_inputs_that_infer_shape_does_not_accept(labels):
    """Four rows of logits with ``labels`` labels: ``infer_shape`` wants
    (4,), so the call raises before the op's body writes anything."""
    x = mx.nd.zeros((4, 9))
    x.attach_grad()
    lab = mx.nd.zeros((labels,), dtype="int32")
    with pytest.raises(ValueError, match="infer_shape wants"):
        with mx.autograd.record():
            mx.nd.Custom(x, lab, op_type="softmax_ce_rtc")


@pytest.mark.parametrize("op_type", ["softmax_ce_rtc",
                                     "torch_parity_softmax_ce"])
def test_softmax_ce_custom_op_matches_jax(op_type):
    rs = np.random.RandomState(4)
    logits = (3 * rs.randn(6, 11)).astype(np.float32)
    labels = rs.randint(0, 11, (6,)).astype(np.int32)
    res = {}
    for pkg, name in ((jmx, "torch_parity_softmax_ce"), (mx, op_type)):
        x = pkg.nd.array(logits)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(x, pkg.nd.array(labels), op_type=name)
        y.backward()               # head of ones: ignored, need_top_grad=False
        res[pkg] = [y, x.grad]
    for g, w in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    # the gradient of the summed cross entropy, as the plain loss gives it
    want = np.exp(logits - logits.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    want[np.arange(6), labels] -= 1
    np.testing.assert_allclose(_np(res[mx][1]), want, **TOL)


def test_softmax_ce_rtc_forward_alone_and_req():
    rs = np.random.RandomState(5)
    x = mx.nd.array(rs.randn(3, 7).astype(np.float32))
    y = mx.nd.Custom(x, mx.nd.array(np.array([0, 6, 3])),
                     op_type="softmax_ce_rtc")
    np.testing.assert_allclose(y.asnumpy().sum(1), np.ones(3), rtol=1e-6)
    # req "add" and "null" through the wrappers
    acc = mx.nd.ones((3, 7))
    rtc_kernels.softmax_ce_fwd(x, acc, "add")
    np.testing.assert_allclose(acc.asnumpy(), y.asnumpy() + 1, **TOL)
    rtc_kernels.softmax_ce_fwd(x, acc, "null")
    np.testing.assert_allclose(acc.asnumpy(), y.asnumpy() + 1, **TOL)
    dst = mx.nd.zeros((2,))
    operator.CustomOp().assign(dst, "write", mx.nd.array([1.0, 2.0]))
    operator.CustomOp().assign(dst, "add", mx.nd.array([1.0, 2.0]))
    operator.CustomOp().assign(dst, "null", mx.nd.array([9.0, 9.0]))
    np.testing.assert_array_equal(dst.asnumpy(), [2.0, 4.0])


# ---------------------------------------------------------------------------
# the slice at small size: one imperative GPT step
# ---------------------------------------------------------------------------
VOCAB, B, T = 97, 4, 12


def _gpt_pair():
    np.random.seed(0)
    jmx.random.seed(0)
    jnet = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=64,
                       num_layers=2, max_length=32, dropout=0.0)
    jnet.initialize(init="xavier")
    jnet(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=64,
                  num_layers=2, max_length=32, dropout=0.0)
    return jnet, load_jax_params(net, params, ctx=mx.cpu())


def _step(pkg, net, trainer, params, op_type, tokens, labels):
    """One imperative step; returns the loss (summed cross entropy) and
    every gradient by name."""
    with pkg.autograd.record():
        logits = net(pkg.nd.array(tokens))
        probs = pkg.nd.Custom(logits.reshape((-1, VOCAB)),
                              pkg.nd.array(labels), op_type=op_type)
    probs.backward()
    p = probs.asnumpy()
    loss = -np.log(p[np.arange(labels.size), labels]).sum()
    grads = {n: _np(q.grad()) if pkg is jmx else q.grad.numpy()
             for n, q in params.items()}
    trainer.step(labels.size)
    return loss, grads


def test_imperative_gpt_step_matches_jax():
    jnet, net = _gpt_pair()
    rs = np.random.RandomState(6)
    tokens = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    labels = rs.randint(0, VOCAB, (B * T,)).astype(np.int32)
    hyper = {"learning_rate": 0.5, "momentum": 0.9}
    jparams = collect_params(jnet)
    want_loss, want_grads = _step(
        jmx, jnet, jgluon.Trainer(jnet.collect_params(), "sgd", dict(hyper)),
        jparams, "torch_parity_softmax_ce", tokens, labels)
    got_loss, got_grads = _step(
        mx, net, gluon.Trainer(net.collect_params(), "sgd", dict(hyper)),
        tensors_of(net), "softmax_ce_rtc", tokens, labels)
    np.testing.assert_allclose(got_loss, want_loss, **STEP_TOL)
    assert set(got_grads) == set(want_grads) and len(got_grads) == 29
    for n in want_grads:
        assert np.abs(want_grads[n]).max() > 0, n
        np.testing.assert_allclose(got_grads[n], want_grads[n], err_msg=n,
                                   **STEP_TOL)
    for n, p in tensors_of(net).items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[n].data().asnumpy(), err_msg=n,
                                   **STEP_TOL)


def test_block_takes_ndarrays_and_tensors():
    """NDArray in, NDArray out, recorded only under record(); tensors in
    still give tensors out (slices 1-3 unchanged)."""
    import torch

    _, net = _gpt_pair()
    tokens = np.arange(10, dtype=np.int32).reshape(2, 5)
    out = net(mx.nd.array(tokens))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (2, 5, VOCAB)
    assert out.as_torch().grad_fn is None
    with mx.autograd.record():
        assert net(mx.nd.array(tokens)).as_torch().grad_fn is not None
    t = net(torch.from_numpy(tokens))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_allclose(t.detach().numpy(), out.asnumpy(), **TOL)
