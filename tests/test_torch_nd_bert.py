"""Port parity: a BERT pretraining step written the GluonNLP 1.x way.

``chip_smoke.nd_bert_step`` (the function ``chip_smoke.py`` runs on the
card at BERT-base's width) is written against the ``mx`` API alone:
token, segment and position ``Embedding``, ``LayerNorm``, time-major
layers whose query, key and value weights are interleaved per head into
one ``FullyConnected``, ``interleaved_matmul_selfatt_qk``, a key mask from
``valid_length`` built with ``arange_like`` and ``broadcast_like`` and
repeated per head, ``masked_softmax``, ``interleaved_matmul_selfatt_valatt``,
the tanh ``gelu`` FFN, the pooler and the MLM and NSP heads, and the
pretraining loss (MLM plus NSP mean cross entropy) under
``autograd.record()``. A small BERT (2 layers, 64 units, 4 heads, vocab
97, T=16, B=4, mixed segments, lengths 16, 1, 9 and 5), dropout 0, is drawn
in the JAX package and carried into the port with ``load_jax_params``; the
step runs once with each package on those weights, and in the port also
against the port's gluon BERT (``attention_impl="pallas"``: the flash
kernels' plain versions on the CPU, with key lengths). The loss agrees to
1e-5 relative and every gradient to 1e-4 relative L2 (fp32, the dense
masked softmax against the flash path's blocked sums), the key bias
against its layer's key weight gradient (it has no gradient in exact
arithmetic); then ``nd_bert_update`` (``multi_sum_sq``,
``adamw_update(out=w)``), given the same gradients, moves both packages'
weights alike (1e-5 relative).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, models
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAYERS, UNITS, HEADS, VOCAB, B, T = 2, 64, 4, 97, 4, 16
LENGTHS = np.array([16, 1, 9, 5], np.int32)
SPEC = dict(vocab_size=VOCAB, units=UNITS, hidden_size=2 * UNITS,
            num_layers=LAYERS, num_heads=HEADS, max_length=T, dropout=0.0)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def weights():
    """The JAX package's BERT drawn from a seed: parameters by name."""
    jmx.random.seed(0)
    jnet = jmodels.get_bert("bert_12_768_12", attention_impl="xla", **SPEC)
    jnet.initialize(init="xavier")
    z = jmx.nd.array(np.zeros((2, T), np.int32), dtype="int32")
    jnet(z, z, jmx.nd.array(np.full((2,), T, np.int32), dtype="int32"))
    return {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}


def _batch():
    rs = np.random.RandomState(5)
    tok = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    seg = (np.arange(T)[None, :] >= rs.randint(1, T, (B, 1))).astype(
        np.int32)
    mlm = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
    nsp = rs.randint(0, 2, (B,)).astype(np.float32)
    return (tok, seg, LENGTHS), (mlm, nsp)


def _nd_step(pkg, weights):
    """The 1.x step in ``pkg`` on ``weights``: (loss, gradients by name,
    the parameters' NDArrays)."""
    data, labels = _batch()
    params = {n: pkg.nd.array(w) for n, w in weights.items()}
    for p in params.values():
        p.attach_grad()
    loss = cs.nd_bert_step(
        pkg, params, [pkg.nd.array(a, dtype=a.dtype) for a in data],
        [pkg.nd.array(a) for a in labels], LAYERS, HEADS)
    return loss, {n: p.grad.asnumpy() for n, p in params.items()}, params


def _assert_grads(grads, want):
    names = sorted(want)
    assert sorted(grads) == names and len(names) == 15 + 16 * LAYERS
    cs._worst_grad("nd_bert_step", names,
                   [torch.from_numpy(grads[n]) for n in names],
                   [torch.from_numpy(np.array(want[n])) for n in names],
                   GRAD_RTOL)


def test_nd_bert_step_matches_jax(weights):
    loss, grads, _ = _nd_step(mx, weights)
    want_loss, want_grads, _ = _nd_step(jmx, weights)
    assert np.isfinite(loss)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads(grads, want_grads)


def test_nd_bert_step_matches_the_port_gluon_bert(weights):
    net = load_jax_params(models.get_bert("bert_12_768_12",
                                          attention_impl="pallas", **SPEC),
                          weights, ctx=mx.cpu())
    data, labels = _batch()
    loss_fn = cs.bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())
    named = list(tensors_of(net).items())
    with mx.autograd.record():
        ref = loss_fn(*net(*[torch.from_numpy(a) for a in data]),
                      *[torch.from_numpy(a) for a in labels])
    ref_grads = torch.autograd.grad(ref, [p for _, p in named])
    loss, grads, _ = _nd_step(mx, weights)
    ref = float(ref.detach())
    assert abs(loss - ref) <= LOSS_RTOL * abs(ref)
    _assert_grads(grads, {n: g.numpy() for (n, _), g in zip(named,
                                                            ref_grads)})


def test_nd_bert_update_moves_both_packages_alike(weights):
    _, grads, _ = _nd_step(jmx, weights)
    after = {}
    for pkg in (jmx, mx):
        params = {n: pkg.nd.array(w) for n, w in weights.items()}
        states = {n: (pkg.nd.zeros(p.shape), pkg.nd.zeros(p.shape))
                  for n, p in params.items()}
        norm = cs.nd_bert_update(
            pkg.nd, params, {n: pkg.nd.array(g) for n, g in grads.items()},
            states, lr=1e-3)
        assert np.isfinite(norm) and norm > 1
        after[pkg] = norm, {n: p.asnumpy() for n, p in params.items()}
    (norm, got), (want_norm, want) = after[mx], after[jmx]
    assert abs(norm - want_norm) <= 1e-5 * want_norm
    for n, w in want.items():
        assert not np.array_equal(w, weights[n]), n
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-7,
                                   err_msg=n)
