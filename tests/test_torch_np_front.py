"""Port parity: the ``mx.np`` front (with ``linalg``, ``fft``,
``random``), ``mx.npx``, the registry's size, and a GPT forward written in
``mx.np`` names.

Every public name of the JAX package's ``mx.np``, ``mx.np.linalg``,
``mx.np.fft``, ``mx.np.random`` and ``mx.npx`` exists in the port. The
port registers 458 ops: the JAX package's 461 less the 3 of
``ops/rnn_op.py`` and ``ops/moe.py``, which later slices port (the 14 of
``ops/detection.py`` came with slice 24). ``chip_smoke.np_gpt_logits`` (the forward ``chip_smoke.py``
runs on the card at GPT-117M's width, in ``mx.np``/``mx.npx`` names and
``mx.nd.flash_attention``) runs once with each package at 2 layers, 64
units, 4 heads, vocabulary 97, B=2, T=16, on the same weights (the JAX
package's through one jitted ``jax.value_and_grad``): logits, loss and
gradients to 1e-5 relative, the arrays by relative L2 (fp32 in another
order of operations). The samplers of ``mx.np.random`` are held by their shape,
type, device and range (their statistics are
``tests/test_torch_nd_random.py``'s).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
from incubator_mxnet_tpu_torch.ops import registry

_spec = importlib.util.spec_from_file_location(
    "torch_np_reference",
    pathlib.Path(__file__).resolve().parent / "torch_np_reference.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
cs = R.cs
LAYERS, UNITS, HEADS, VOCAB, B, T = 2, 64, 4, 97, 2, 16
RTOL = 1e-5
# the ops later slices port: the fused RNN (item 8) and the mixture of
# experts (item 10)
LATER = {"rnn_op": 1, "moe": 2}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("sub", ["np", "np.linalg", "np.fft", "np.random",
                                 "npx"])
def test_every_public_name_of_the_reference_exists(sub):
    ref, got = (functools.reduce(getattr, sub.split("."), pkg)
                for pkg in (jmx, mx))
    names = [n for n in dir(ref) if not n.startswith("_")]
    assert names
    assert [n for n in names if not hasattr(got, n)] == []


def test_registry_holds_the_reference_less_the_later_slices():
    later = {n for n in jregistry.list_ops()
             if jregistry.get(n).fn.__module__.rsplit(".", 1)[-1] in LATER}
    assert len(later) == sum(LATER.values()) == 3
    assert len(jregistry.list_ops()) == 461
    assert len(registry.list_ops()) == 458
    assert set(registry.list_ops()) == set(jregistry.list_ops()) - later


def _weights(seed=0):
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=UNITS,
                  num_layers=LAYERS, num_heads=HEADS, max_length=T,
                  dropout=0.0)
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in net.named_parameters():
        w = rs.randn(*p.shape).astype(np.float32)
        out[name] = 1 + 0.1 * w if name.endswith("gamma") else 0.1 * w
    return out


def _jax_step(params, tokens, labels):
    """The JAX package's ``np_gpt_logits`` and loss (as ``np_gpt_step``
    writes it) in one jitted ``jax.value_and_grad``: loss, logits and the
    gradients by name."""
    np_, npx = jmx.np, jmx.npx
    names = sorted(params)

    def loss_fn(datas):
        ps = {n: jmx.nd.NDArray(d) for n, d in zip(names, datas)}
        logits = cs.np_gpt_logits(jmx, ps, jmx.nd.array(tokens), LAYERS,
                                  HEADS)
        loss = -np_.mean(np_.take_along_axis(
            npx.log_softmax(logits),
            np_.expand_dims(jmx.nd.array(labels, dtype="int32"), -1),
            axis=-1))
        return loss._data, logits._data

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))([jnp.asarray(params[n]) for n in names])
    return float(loss), np.asarray(logits), {
        n: np.asarray(g) for n, g in zip(names, grads)}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_np_gpt_logits_and_step_match_jax():
    weights = _weights()
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
    labels = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    want_loss, want_logits, want_grads = _jax_step(weights, tokens, labels)
    params = {n: mx.nd.array(w) for n, w in weights.items()}
    logits = cs.np_gpt_logits(mx, params, mx.nd.array(tokens), LAYERS,
                              HEADS).asnumpy()
    for p in params.values():
        p.attach_grad()
    loss = cs.np_gpt_step(mx, params, mx.nd.array(tokens),
                          mx.nd.array(labels, dtype="int32"), LAYERS, HEADS)
    assert logits.shape == (B, T, VOCAB)
    assert _rel(logits, want_logits) <= RTOL
    assert np.isfinite(loss) and abs(loss - want_loss) <= RTOL * want_loss
    assert len(params) == 29
    for name, p in params.items():
        err = _rel(p.grad.asnumpy(), want_grads[name])
        assert err <= RTOL, (name, err)


def test_np_random_draws_on_ctx_with_its_shape_and_type():
    r = mx.np.random
    mx.np.random.seed(3)
    for draw, dtype in ((r.uniform(-1, 2, size=(4, 5)), np.float32),
                        (r.normal(1, 2, size=(4, 5)), np.float32),
                        (r.randint(3, 9, size=(4, 5)), np.int32),
                        (r.rand(4, 5), np.float32), (r.randn(4, 5),
                                                     np.float32),
                        (r.exponential(2.0, size=(4, 5)), np.float32),
                        (r.gamma(2.0, 0.5, size=(4, 5)), np.float32),
                        (r.poisson(3.0, size=(4, 5)), np.float32)):
        assert draw.shape == (4, 5) and draw.dtype == dtype
        assert draw.ctx == mx.cpu()
    u = r.uniform(-1, 2, size=(1000,)).asnumpy()
    assert u.min() >= -1 and u.max() < 2
    assert r.randint(5, size=(100,)).asnumpy().max() < 5
    mx.np.random.seed(3)
    again = r.uniform(-1, 2, size=(4, 5)).asnumpy()
    mx.np.random.seed(3)
    np.testing.assert_array_equal(again, r.uniform(-1, 2, size=(4, 5))
                                  .asnumpy())


def test_np_random_shuffle_permutes_rows_in_the_array_s_own_tensor():
    x = mx.nd.array(np.arange(40, dtype=np.float32).reshape(10, 4))
    tensor = x.as_torch()
    assert mx.np.random.shuffle(x) is None
    assert x.as_torch() is tensor
    rows = sorted(map(tuple, x.asnumpy().tolist()))
    assert rows == [tuple(r) for r in np.arange(40).reshape(10, 4).tolist()]


def test_creators_take_ctx_and_the_like_creators_the_operand_s_device():
    for name, args in (("linspace", (0.0, 1.0, 5)), ("logspace", (0, 2, 3)),
                       ("geomspace", (1.0, 8.0, 4)), ("identity", (3,))):
        got = getattr(mx.np, name)(*args, ctx=mx.cpu())
        want = getattr(np, name)(*args)
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)
        assert got.ctx == mx.cpu() and got.dtype == np.float32
    a = mx.nd.array(cs._INTS)
    for like in (mx.np.full_like(a, 7), mx.np.empty_like(a),
                 mx.np.asarray(a)):
        assert like.ctx == a.ctx and like.dtype == np.int32
    assert mx.np.linspace(0, 10, 4, dtype="int32").asnumpy().tolist() == \
        np.linspace(0, 10, 4, dtype=np.int32).tolist()
    assert mx.np.geomspace(-1.0, -1000.0, 4).asnumpy().tolist() == \
        pytest.approx(np.geomspace(-1.0, -1000.0, 4).tolist())


def test_dtype_helpers_take_bfloat16():
    bf = mx.nd.zeros((2,), dtype="bfloat16")
    f32 = mx.nd.zeros((2,))
    assert bf.dtype == torch.bfloat16
    assert mx.np.result_type(bf, f32) == np.float32
    assert mx.np.result_type(bf, 2.0) == torch.bfloat16
    assert mx.np.promote_types(torch.bfloat16, np.float16) == np.float32
    assert mx.np.can_cast(bf, np.float32)
    assert not mx.np.can_cast(f32, torch.bfloat16)
    assert mx.np.can_cast(f32, torch.bfloat16, casting="same_kind")
    assert mx.np.issubdtype(torch.bfloat16, np.floating)
    assert not mx.np.issubdtype(torch.bfloat16, np.integer)
    assert mx.np.result_type(f32, np.int32) == np.result_type(np.float32,
                                                              np.int32)
    assert (mx.np.shape(f32), mx.np.ndim(f32), mx.np.size(f32)) == \
        ((2,), 1, 2)


def test_npx_flags_and_names():
    assert mx.npx.is_np_array() is False
    mx.npx.set_np()
    assert mx.npx.is_np_array() and mx.npx.is_np_shape()
    mx.npx.reset_np()
    assert not mx.npx.is_np_array()
    f = lambda: 1                                          # noqa: E731
    assert mx.npx.use_np(f) is f
    assert mx.npx.layer_norm is mx.nd.LayerNorm
    assert mx.np.ndarray is mx.nd.NDArray
    assert mx.np.pi == np.pi and mx.np.newaxis is None


def test_the_numpy_subpackage_imports_the_real_numpy():
    import incubator_mxnet_tpu_torch.numpy as port_np

    assert port_np._onp is np
    assert mx.np is port_np and mx.npx.__name__.endswith("numpy_extension")
