"""Port parity: AMP (``amp/``) and fp16 flash attention.

* The cast policy: under ``amp.init("bfloat16")`` and
  ``amp.init("float16")`` each op class gives the output type the JAX
  package's does on the same inputs (target ops, fp32 ops, the
  conditional ``softrelu``, the widest-type casts of ``mx.nd``'s ``+``,
  ``broadcast_add`` and ``concat``); the policy applies once per outermost
  op call; gradients come back in the parameter's type; the port never
  calls ``torch.autocast``.
* The loss scaler: growth after its window, halving on an overflow,
  between 1 and 2^24; an overflow step through ``gluon.Trainer`` skips the
  update and halves the scale; ``unscale``; ``convert_model``.
* A two-layer GPT (32 units, 4 heads, vocab 61, B=8, T=12) takes two AMP
  steps (``init_trainer``, ``scale_loss``, SGD) in each package from the
  same fp32 weights: the bf16 losses agree to 2e-2 relative (two bf16
  forwards that round at different places), the parameters after the
  steps to 1e-3 absolute (updates of lr 0.1 times gradients that agree to
  bf16 precision).
* fp16 flash attention: the route rules send fp16 where bf16 goes (the
  tensor-core kernels; before the repair fp16 had no kernel and raised on
  the card), and the plain fp16 forward and backward equal the JAX
  Pallas kernels run in interpret mode on the same fp16 inputs to 1e-2
  absolute (fp16 outputs of fp32 sums; both round p to fp16 differently).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.ops import pallas_attention as pa
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import amp, gluon
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import nn as nn_ops
from incubator_mxnet_tpu_torch.ops import registry

VOCAB, B, T = 61, 8, 12


@pytest.fixture(autouse=True)
def _clean_policy():
    with mx.cpu():
        yield
    jamp.deinit()
    amp.deinit()


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


X, W, BIAS = _np(0, 4, 8), _np(1, 3, 8), np.zeros(3, np.float32)

# (name, JAX call, port call) on fp32 X unless the call casts first
CASES = [
    ("target_fc", lambda nd, dt: nd.FullyConnected(
        nd.array(X), nd.array(W), nd.array(BIAS), num_hidden=3)),
    ("target_dot", lambda nd, dt: nd.dot(nd.array(X), nd.array(W.T.copy()))),
    ("fp32_softmax", lambda nd, dt: nd.softmax(nd.array(X).astype(dt))),
    ("fp32_sum", lambda nd, dt: nd.sum(nd.array(X).astype(dt))),
    ("fp32_exp", lambda nd, dt: nd.exp(nd.array(X).astype(dt))),
    ("conditional_softrelu", lambda nd, dt: nd.Activation(
        nd.array(X).astype(dt), act_type="softrelu")),
    ("conditional_relu", lambda nd, dt: nd.Activation(
        nd.array(X).astype(dt), act_type="relu")),
    ("widest_add", lambda nd, dt: nd.array(X).astype(dt) + nd.array(X)),
    ("widest_broadcast_add", lambda nd, dt: nd.broadcast_add(
        nd.array(X).astype(dt), nd.array(X))),
    ("widest_concat", lambda nd, dt: nd.concat(
        nd.array(X).astype(dt), nd.array(X), dim=0)),
    ("unlisted_tanh", lambda nd, dt: nd.tanh(nd.array(X).astype(dt))),
]


def _dtype_name(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
@pytest.mark.parametrize("name, call", CASES, ids=[c[0] for c in CASES])
def test_each_op_class_gives_the_jax_output_type(name, call, target):
    jamp.init(target)
    amp.init(target)
    want = call(jmx.nd, target)
    got = call(mx.nd, target)
    assert _dtype_name(got.dtype) == _dtype_name(want.dtype)
    np.testing.assert_allclose(got.asnumpy().astype(np.float32),
                               want.asnumpy().astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_without_a_policy_the_types_are_the_inputs():
    x = torch.from_numpy(X)
    assert registry._amp_policy is None
    assert nn_ops.fully_connected(x, torch.from_numpy(W), num_hidden=3,
                                  no_bias=True).dtype == torch.float32


def test_policy_applies_once_per_outermost_call():
    """An op called inside another op's body runs as called: softmax
    (fp32 class) inside a target op keeps the target op's type."""
    seen = []
    real = nn_ops.softmax

    @registry.register("amp_probe_outer")
    def outer(x):
        y = real(x)
        seen.append(y.dtype)
        return y

    try:
        amp.init("bfloat16", target_precision_ops=["amp_probe_outer"])
        out = outer(torch.from_numpy(X))
        assert seen == [torch.bfloat16] and out.dtype == torch.bfloat16
        assert real(torch.from_numpy(X).bfloat16()).dtype == torch.float32
    finally:
        registry._OPS.pop("amp_probe_outer", None)


def test_gradients_come_back_in_the_parameter_type():
    amp.init("bfloat16")
    w = torch.from_numpy(W).requires_grad_()
    y = nn_ops.fully_connected(torch.from_numpy(X), w, num_hidden=3,
                               no_bias=True)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32


def test_the_port_never_calls_torch_autocast():
    root = pathlib.Path(mx.__file__).resolve().parent
    call = re.compile(r"autocast\s*\(|torch\.(cuda\.)?amp\b")
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if call.search(p.read_text())]
    assert hits == []


def test_loss_scaler_grows_halves_and_stays_in_bounds():
    s, js = amp.LossScaler(), jamp.LossScaler()
    assert s.loss_scale == js.loss_scale == 2.0 ** 16
    s._scale_window = js._scale_window = 3
    pattern = [False] * 7 + [True] * 20 + [False] * 80
    for ov in pattern:
        s.update_scale(ov)
        js.update_scale(ov)
        assert s.loss_scale == js.loss_scale
    assert s.loss_scale == 2.0 ** 24        # capped
    for _ in range(40):
        s.update_scale(True)
    assert s.loss_scale == 1.0              # floored
    assert amp.LossScaler()._scale_window == 2000


def test_has_overflow_is_one_device_check():
    p = [torch.nn.Parameter(torch.ones(3)) for _ in range(3)]
    for q in p:
        q.grad = torch.ones(3)
    assert not amp.LossScaler.has_overflow(p)
    p[1].grad[2] = float("inf")
    assert amp.LossScaler.has_overflow(p)
    p[1].grad[2] = float("nan")
    assert amp.LossScaler.has_overflow(p)
    assert not amp.LossScaler.has_overflow([torch.nn.Parameter(
        torch.ones(2))])


def _dense():
    net = gluon.nn.Dense(3, in_units=8)
    net.initialize(ctx=mx.cpu())
    return net


def test_overflow_step_is_skipped_and_the_scale_halves():
    net = _dense()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    scaler = amp.init_trainer(tr)
    x = mx.nd.array(X, ctx=mx.cpu())
    before = net.weight.detach().clone()
    with mx.autograd.record():
        loss = net(x).sum()
    with amp.scale_loss(loss, tr) as scaled:
        scaled.backward()
    assert tr._scale == 1.0 / 2.0 ** 16
    net.weight.grad[0, 0] = float("inf")
    tr.step(4)
    assert torch.equal(net.weight.detach(), before)
    assert scaler.loss_scale == 2.0 ** 15
    # the next clean step updates (no stale-gradient error)
    with mx.autograd.record():
        loss = net(x).sum()
    with amp.scale_loss(loss, tr) as scaled:
        scaled.backward()
    tr.step(4)
    assert not torch.equal(net.weight.detach(), before)
    # the update equals an unscaled SGD step
    g = torch.from_numpy(X).sum(0).expand(3, 8) / 4
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               (before - 0.1 * g).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_unscale_divides_the_gradients_now():
    net = _dense()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr)
    with mx.autograd.record():
        loss = net(mx.nd.array(X, ctx=mx.cpu())).sum()
    with amp.scale_loss(loss, tr) as scaled:
        scaled.backward()
    scaled_grad = net.weight.grad.clone()
    amp.unscale(tr)
    torch.testing.assert_close(net.weight.grad, scaled_grad / 2.0 ** 16)
    assert tr._scale == 1.0


def test_convert_model_casts_for_inference():
    net = amp.convert_model(_dense(), "float16")
    assert all(p.dtype == torch.float16 for p in net.parameters())
    out = net(mx.nd.array(X, ctx=mx.cpu(), dtype="float16"))
    assert out.dtype == np.float16


def _gpt_pair(seed=4):
    np.random.seed(seed)
    jmx.random.seed(seed)
    jnet = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                       num_layers=2, max_length=48, dropout=0.0)
    jnet.initialize(init="xavier")
    jnet(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                  num_layers=2, max_length=48, dropout=0.0)
    return jnet, load_jax_params(net, params, ctx=mx.cpu())


def test_two_layer_gpt_amp_steps_match_jax():
    jnet, net = _gpt_pair()
    jamp.init("bfloat16")
    amp.init("bfloat16")
    hyper = {"learning_rate": 0.1}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(hyper))
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(hyper))
    jamp.init_trainer(jtr)
    amp.init_trainer(tr)
    jce, ce = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(2):
        rs = np.random.RandomState(10 + i)
        x = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
        y = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
        # the reference's usage: the scaled backward inside record()
        with jmx.autograd.record():
            jl = jce(jnet(jmx.nd.array(x, dtype="int32")), jmx.nd.array(y))
            with jamp.scale_loss(jl, jtr) as s:
                jmx.autograd.backward(s)
        jtr.step(B)
        with mx.autograd.record():
            logits = net(torch.from_numpy(x))
            tl = ce(logits, torch.from_numpy(y))
            with amp.scale_loss(tl, tr) as s:
                mx.autograd.backward(s)
        assert logits.dtype == torch.bfloat16     # the LM head's FC
        tr.step(B)
        np.testing.assert_allclose(tl.detach().float().numpy(),
                                   jl.asnumpy().astype(np.float32),
                                   rtol=2e-2)
    want = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    for n, p in net.named_parameters():
        assert p.dtype == torch.float32, n
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-3,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# fp16 flash attention (the repair)
# ---------------------------------------------------------------------------
def _qkv(seed, b, h, tq, tk, d, dtype):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, t, d).astype(np.float32) for t in (tq, tk, tk)]


@pytest.mark.parametrize("d", [64, 128])
def test_fp16_takes_the_tensor_core_routes_as_bf16(d):
    q, k, v = (torch.zeros(2, 3, 70, d, dtype=torch.float16)
               for _ in range(3))
    assert fa.flash_fwd_route(q, k, v) == "tc"
    assert fa.flash_bwd_route(q, k, v, q) == "tc"
    assert fa.flash_fwd_route(q[:, :, :1], k, v) == "split"
    # what bf16 takes, fp16 takes: D = 32 and misaligned views are SIMT
    q32 = torch.zeros(2, 3, 70, 32, dtype=torch.float16)
    assert fa.flash_fwd_route(q32, q32, q32) == "simt"
    fa._check_cuda(q, k, v, None)          # no TypeError: a kernel type


@pytest.mark.parametrize("causal, lengths", [(True, None),
                                             (False, (64, 17))],
                         ids=["causal", "lengths"])
def test_plain_fp16_flash_equals_the_pallas_kernel(causal, lengths):
    b, h, t, d = 2, 2, 64, 64
    q, k, v = _qkv(0, b, h, t, t, d, np.float16)
    g = np.random.RandomState(1).randn(b, h, t, d).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in (q, k, v, g))

    def jfwd(q_, k_, v_):
        return pa.flash_attention(q_, k_, v_,
                                  None if lens is None else jnp.asarray(lens),
                                  causal=causal, interpret=True)

    want, vjp = jax.vjp(jfwd, jq, jk, jv)
    want_grads = vjp(jg)
    tq, tk, tv = (torch.from_numpy(a).half().requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv,
                             None if lens is None else torch.from_numpy(lens),
                             causal=causal)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(g).half())
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), atol=2e-2)
