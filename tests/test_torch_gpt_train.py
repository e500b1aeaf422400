"""Port parity: training the GPT decoder.

The tiny GPT of ``tests/test_decode.py`` (2 layers, 32 units, 4 heads,
vocab 61), dropout 0, is drawn in the JAX package and carried into the
port with ``load_jax_params``; batches of B=8 sequences of T=12 tokens are
made with numpy (B=8 splits evenly over the tests' 8-device CPU mesh, which
the JAX ``SPMDTrainer`` shards over). On the CPU the port's attention and
its backward are the plain versions of the CUDA kernels.

Tolerances: losses and gradients 1e-5 abs / 1e-4 rel (fp32 on both sides,
different summation order); parameters after 3 steps the same; bf16 losses
1e-2 rel (both round an fp32 result to bf16, so they differ by at most one
bf16 ulp). Adam runs with epsilon 1e-4: the gradient of the key bias is
zero in exact arithmetic (a per-row constant in the scores), so each side
carries rounding noise of ~1e-9 there, which epsilon 1e-8 would turn into
steps of lr/10 that differ between the two.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.ndarray import NDArray
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, parallel, serving
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

VOCAB, B, T = 61, 8, 12
TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_net(seed=0, dropout=0.0):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                      num_layers=2, max_length=48, dropout=dropout)
    net.initialize(init="xavier")
    net(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    return net


def _jax_params(jnet):
    return {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}


def _port_net(jnet, dropout=0.0):
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                  num_layers=2, max_length=48, dropout=dropout)
    return load_jax_params(net, _jax_params(jnet), ctx=mx.cpu())


def _batch(seed):
    rs = np.random.RandomState(100 + seed)
    return (rs.randint(0, VOCAB, (B, T)).astype(np.int32),
            rs.randint(0, VOCAB, (B, T)).astype(np.float32))


def _assert_params(net, want, **tol):
    got = {n: p.detach().numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **(tol or TOL))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_ce_matches_jax_including_bf16(dtype):
    rs = np.random.RandomState(1)
    logits = (3 * rs.randn(4, 5, 7)).astype(np.float32)
    labels = rs.randint(0, 7, (4, 5)).astype(np.float32)
    jl = NDArray(jmx.nd.array(logits)._data.astype(dtype))
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(jl, jmx.nd.array(labels))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = gluon.loss.SoftmaxCrossEntropyLoss()(tl, torch.from_numpy(labels))
    assert got.shape == (4,) and got.dtype == tl.dtype
    assert str(want.dtype) == dtype
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._data, np.float32), **tol)
    # dense (distribution) labels and a sample weight
    dist = rs.dirichlet(np.ones(7), (4, 5)).astype(np.float32)
    sw = rs.rand(4, 1).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        jmx.nd.array(logits), jmx.nd.array(dist), jmx.nd.array(sw))
    got = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        torch.from_numpy(logits), torch.from_numpy(dist),
        torch.from_numpy(sw))
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)


@pytest.mark.parametrize("name", ["L2Loss", "L1Loss"])
def test_l1_l2_losses_match_jax(name):
    rs = np.random.RandomState(2)
    pred = rs.randn(6, 3, 4).astype(np.float32)
    label = rs.randn(6, 12).astype(np.float32)        # reshaped like pred
    sw = rs.rand(6, 1, 1).astype(np.float32)
    want = getattr(jgluon.loss, name)(weight=0.5)(
        jmx.nd.array(pred), jmx.nd.array(label), jmx.nd.array(sw))
    got = getattr(gluon.loss, name)(weight=0.5)(
        torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(sw))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)


# ---------------------------------------------------------------------------
# eager gradients and gluon.Trainer
# ---------------------------------------------------------------------------
def _jax_record_backward(jnet, x, y):
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        loss = ce(jnet(jmx.nd.array(x, dtype="int32")), jmx.nd.array(y))
    loss.backward()
    return loss.asnumpy()


def _port_record_backward(net, x, y):
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = ce(net(torch.from_numpy(x)), torch.from_numpy(y))
    mx.autograd.backward(loss)           # (B,) loss: head gradient of ones
    return loss.detach().float().numpy()


def test_record_backward_gradients_match_jax():
    jnet = _jax_net()
    net = _port_net(jnet)
    x, y = _batch(0)
    want_loss = _jax_record_backward(jnet, x, y)
    got_loss = _port_record_backward(net, x, y)
    assert got_loss.shape == (B,)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    want = {n: p.grad().asnumpy() for n, p in collect_params(jnet).items()}
    got = {n: p.grad.numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


TRAINER_CASES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 0.05}),
    ("adam", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adamw", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-2}),
    # the optax rules torch.optim lacks (parallel.spmd.OptaxRule)
    ("lamb", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-2,
              "clip_gradient": 0.05}),
    ("rmsprop", {"learning_rate": 0.01, "gamma1": 0.8, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.05, "eps": 1e-6, "wd": 1e-3}),
]


@pytest.mark.parametrize("opt, hyper", TRAINER_CASES,
                         ids=[c[0] for c in TRAINER_CASES])
def test_gluon_trainer_three_steps_match_jax(opt, hyper):
    jnet = _jax_net(seed=1)
    net = _port_net(jnet)
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(hyper))
    tr = gluon.Trainer(net.collect_params(), opt, dict(hyper))
    for i in range(3):
        x, y = _batch(i)
        _jax_record_backward(jnet, x, y)
        jtr.step(B)
        _port_record_backward(net, x, y)
        tr.step(B)
    _assert_params(net, _jax_params(jnet))


# ---------------------------------------------------------------------------
# parallel.SPMDTrainer
# ---------------------------------------------------------------------------
def _lm_losses():
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    return (lambda lg, lb: jce(lg, lb).mean(),
            lambda lg, lb: ce(lg, lb).mean())


SPMD_CASES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-3,
              "clip_gradient": 0.05}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adamw", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-2}),
    # the optax rules torch.optim lacks (parallel.spmd.OptaxRule)
    ("lamb", {"learning_rate": 0.01, "epsilon": 1e-4, "wd": 1e-2,
              "clip_gradient": 0.05}),
    ("rmsprop", {"learning_rate": 0.01, "gamma1": 0.8, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.05, "eps": 1e-6, "wd": 1e-3}),
]


@pytest.mark.parametrize("opt, hyper", SPMD_CASES,
                         ids=[c[0] for c in SPMD_CASES])
def test_spmd_trainer_three_steps_match_jax(opt, hyper):
    jnet = _jax_net(seed=2)
    net = _port_net(jnet)
    jloss, loss = _lm_losses()
    jst = jparallel.SPMDTrainer(jnet, jloss, opt, dict(hyper))
    st = parallel.SPMDTrainer(net, loss, opt, dict(hyper))
    before = {n: p.detach().clone() for n, p in tensors_of(net).items()}
    for i in range(3):
        x, y = _batch(i)
        want = float(jst.step(x, y))
        got = st.step(x, y)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, **TOL)
    # the trainer owns its copy: the net moves only at sync_to_net
    for n, p in tensors_of(net).items():
        assert torch.equal(p.detach(), before[n]), n
    st.sync_to_net()
    _assert_params(net, {n: np.asarray(v) for n, v in jst.params.items()})


def test_spmd_run_steps_is_n_steps_on_one_batch():
    jnet = _jax_net(seed=3)
    _, loss = _lm_losses()
    x, y = _batch(0)
    a, b = _port_net(jnet), _port_net(jnet)
    sa = parallel.SPMDTrainer(a, loss, "sgd", {"learning_rate": 0.1})
    sb = parallel.SPMDTrainer(b, loss, "sgd", {"learning_rate": 0.1})
    last = sa.run_steps(3, x, y)
    for _ in range(3):
        want = sb.step(x, y)
    assert torch.equal(last, want)
    for n, v in sa.params.items():
        assert torch.equal(v, sb.params[n]), n


def test_spmd_trainer_refuses_what_waits_for_multi_gpu():
    net = _port_net(_jax_net())
    _, loss = _lm_losses()
    for kw in (dict(mesh=object()), dict(zero_stage=1),
               dict(collective_quant="int8"),
               dict(shard_weight_update=True)):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            parallel.SPMDTrainer(net, loss, "sgd", **kw)
    # lamb, rmsprop and adagrad are ported (SPMD_CASES): no longer refused
    for name in ("lamb", "rmsprop", "adagrad"):
        assert isinstance(parallel.SPMDTrainer(net, loss, name).tx,
                          parallel.spmd.OptaxRule)
    with pytest.raises(ValueError, match="no optax mapping"):
        parallel.SPMDTrainer(net, loss, "bogus")


def test_bf16_net_gives_bf16_loss_and_fp32_mean():
    net = _port_net(_jax_net()).cast("bfloat16")
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for p in net.parameters())
    x, y = _batch(0)
    logits = net(torch.from_numpy(x))
    assert logits.dtype == torch.bfloat16
    per = gluon.loss.SoftmaxCrossEntropyLoss()(logits, torch.from_numpy(y))
    assert per.dtype == torch.bfloat16
    _, loss = _lm_losses()
    st = parallel.SPMDTrainer(net, loss, "sgd", {"learning_rate": 1e-4,
                                                 "momentum": 0.9})
    got = st.step(x, y)
    assert got.dtype == torch.float32 and torch.isfinite(got)
    assert st.params["head.weight"].dtype == torch.bfloat16


def test_block_cast_round_trip():
    net = _port_net(_jax_net())
    want = {n: p.detach().clone() for n, p in tensors_of(net).items()}
    tensors_of(net)["ln_f.gamma"].grad_req = "add"
    net.cast("bfloat16").cast(torch.float32)
    assert tensors_of(net)["ln_f.gamma"].grad_req == "add"
    for n, p in tensors_of(net).items():
        assert p.dtype == torch.float32
        torch.testing.assert_close(p.detach(), want[n], rtol=8e-3, atol=0)
    with pytest.raises(TypeError, match="unknown dtype"):
        net.cast("float77")


def test_trainer_made_before_cast_trains_the_cast_weights():
    """``cast`` keeps each parameter object (JAX ``Parameter.cast``), so a
    Trainer made before it updates the bf16 weights. Tolerance: one bf16
    ulp (2**-8 relative) on both sides' bf16 rounding."""
    jnet = _jax_net(seed=4)
    net = _port_net(jnet)
    hyper = {"learning_rate": 0.5, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(hyper))
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(hyper))
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    cast = {n: p.detach().float().clone()
            for n, p in tensors_of(net).items()}
    for i in range(2):
        x, y = _batch(i)
        _jax_record_backward(jnet, x, y)
        jtr.step(B)
        _port_record_backward(net, x, y)
        tr.step(B)
    got = tensors_of(net)
    assert all(p.dtype == torch.bfloat16 for p in got.values())
    assert not torch.equal(got["head.weight"].detach().float(),
                           cast["head.weight"])
    want = {n: np.asarray(v, np.float32)
            for n, v in _jax_params(jnet).items()}
    for n in want:
        np.testing.assert_allclose(got[n].detach().float().numpy(), want[n],
                                   rtol=2 ** -7, atol=2e-3, err_msg=n)


# ---------------------------------------------------------------------------
# training semantics that differ between the frameworks
# ---------------------------------------------------------------------------
def test_gradients_are_written_not_accumulated():
    net = _port_net(_jax_net())
    (x0, y0), (x1, y1) = _batch(0), _batch(1)
    _port_record_backward(net, x0, y0)
    _port_record_backward(net, x1, y1)
    second = {n: p.grad.clone() for n, p in tensors_of(net).items()}
    fresh = _port_net(_jax_net())
    _port_record_backward(fresh, x1, y1)
    for n, p in tensors_of(fresh).items():
        torch.testing.assert_close(second[n], p.grad, rtol=0, atol=0)
    # grad_req 'add' accumulates instead
    p = tensors_of(net)["head.weight"]
    p.grad_req = "add"
    _port_record_backward(net, x1, y1)
    torch.testing.assert_close(p.grad, 2 * second["head.weight"])


def test_stale_gradients_raise_unless_ignored_and_rescale_grad():
    net = _port_net(_jax_net())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    w0 = tensors_of(net)["head.weight"].detach().clone()
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(B)                                   # no backward yet
    assert torch.equal(tensors_of(net)["head.weight"], w0)
    x, y = _batch(0)
    _port_record_backward(net, x, y)
    g = tensors_of(net)["head.weight"].grad.clone()
    tr.step(4)
    assert tr.optimizer.rescale_grad == 1 / 4
    torch.testing.assert_close(tensors_of(net)["head.weight"].detach(),
                               w0 - 0.5 * g / 4)
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(B)                                   # grads already used
    w1 = tensors_of(net)["head.weight"].detach().clone()
    tr.step(B, ignore_stale_grad=True)               # skips every param
    assert torch.equal(tensors_of(net)["head.weight"], w1)
    # a torch-native backward that adds in place also counts as new
    with mx.autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x)), torch.from_numpy(y))
    loss.sum().backward()
    tr.step(B)


@pytest.mark.parametrize("name, kw", [
    ("FactorScheduler", dict(step=3, factor=0.5, warmup_steps=2)),
    ("MultiFactorScheduler", dict(step=[2, 5], factor=0.1)),
    ("PolyScheduler", dict(max_update=8, pwr=2, warmup_steps=2,
                           warmup_mode="constant", warmup_begin_lr=0.01)),
    ("CosineScheduler", dict(max_update=8, final_lr=0.001)),
], ids=["factor", "multifactor", "poly", "cosine"])
def test_lr_schedulers_match_jax_and_drive_the_optimizer(name, kw):
    from incubator_mxnet_tpu import lr_scheduler as jsched

    want = getattr(jsched, name)(base_lr=0.2, **kw)
    got = getattr(mx.lr_scheduler, name)(base_lr=0.2, **kw)
    for n in range(10):
        assert got(n) == pytest.approx(want(n), rel=1e-12, abs=0), n
    opt = mx.optimizer.create("sgd", learning_rate=0.2, lr_scheduler=got)
    opt.num_update = 6
    assert opt.learning_rate == pytest.approx(want(6))


def test_lr_and_wd_multipliers_per_parameter():
    net = _port_net(_jax_net())
    params = tensors_of(net)
    params["head.weight"].lr_mult = 0.0
    params["ln_f.gamma"].wd_mult = 0.0
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.5, "wd": 0.1})
    frozen = params["head.weight"].detach().clone()
    gamma = params["ln_f.gamma"].detach().clone()
    _port_record_backward(net, *_batch(0))
    g = params["ln_f.gamma"].grad.clone()
    tr.step(B)
    assert torch.equal(params["head.weight"].detach(), frozen)
    torch.testing.assert_close(params["ln_f.gamma"].detach(),
                               gamma - 0.5 * g / B)


def test_trainer_states_round_trip(tmp_path):
    net = _port_net(_jax_net())
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    x, y = _batch(0)
    _port_record_backward(net, x, y)
    tr.step(B)
    tr.save_states(str(tmp_path / "t.states"))
    tr2 = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    tr2.load_states(str(tmp_path / "t.states"))
    assert tr2.optimizer._index_update_count == \
        tr.optimizer._index_update_count
    for i, (m, v) in tr._updater.states.items():
        m2, v2 = tr2._updater.states[i]
        assert torch.equal(m, m2) and torch.equal(v, v2)


def test_dropout_follows_autograd_training_flag():
    jnet = _jax_net()
    net, plain = _port_net(jnet, dropout=0.5), _port_net(jnet)
    x = torch.from_numpy(_batch(0)[0])
    with torch.no_grad():
        want = plain(x)
        torch.testing.assert_close(net(x), want, rtol=0, atol=0)
    assert not mx.autograd.is_training()
    with mx.autograd.record():
        assert mx.autograd.is_training() and mx.autograd.is_recording()
        assert torch.is_grad_enabled()
        a = net(x)
        with mx.autograd.predict_mode():
            torch.testing.assert_close(net(x), want, rtol=0, atol=0)
        with mx.autograd.pause():
            assert not torch.is_grad_enabled()
            assert not mx.autograd.is_training()
    assert not (a - want).abs().max() < 1e-6, "dropout was not active"
    with mx.autograd.train_mode():
        assert not torch.equal(net(x).detach(), want)
    prompt = np.arange(1, 8)
    with serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=32,
                               prefill_buckets=(8,)) as sess:
        got = sess.generate(prompt, max_new_tokens=6)
    with serving.DecodeSession(plain, ctx=mx.cpu(), max_slots=1, max_len=32,
                               prefill_buckets=(8,)) as sess:
        assert got == sess.generate(prompt, max_new_tokens=6)


# ---------------------------------------------------------------------------
# train -> decode in one run
# ---------------------------------------------------------------------------
def test_train_then_decode_matches_full_forward_oracle():
    net = _port_net(_jax_net(seed=5))
    _, loss = _lm_losses()
    st = parallel.SPMDTrainer(net, loss, "sgd", {"learning_rate": 0.05,
                                                 "momentum": 0.9})
    losses = [float(st.step(*_batch(i))) for i in range(4)]
    assert np.isfinite(losses).all()
    st.sync_to_net()
    prompt = np.random.RandomState(6).randint(1, VOCAB, (7,))
    seq, want = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(6):
            tok = int(torch.argmax(net(torch.tensor([seq]))[0, -1]))
            want.append(tok)
            seq.append(tok)
    with serving.DecodeSession(net, ctx=mx.cpu(), max_slots=2, max_len=32,
                               prefill_buckets=(8,)) as sess:
        assert sess.generate(prompt, max_new_tokens=6) == want
    assert fa.flash_fwd_launches == 0 or torch.cuda.is_available()
