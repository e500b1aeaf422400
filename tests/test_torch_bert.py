"""Port parity: BERT (``models/transformer.py``, ``get_bert``).

A small BERT (2 layers, 32 units, 4 heads of 8, FFN 64, vocab 50, T=24,
B=8: B splits evenly over the tests' 8-device CPU mesh, which the JAX
``SPMDTrainer`` shards over), dropout 0, is drawn in the JAX package and
carried into the port with ``load_jax_params``. The same numpy tokens,
segments (mixed 0 and 1) and ``valid_length`` (mixed, 1 and T among them)
go through both. Each test runs under both ``attention_impl``s: ``"xla"``,
the dense chain with a key mask, and ``"pallas"``, the flash kernels' path
(on the CPU the port runs their plain versions, and the JAX package its
dense path below ``MXTPU_FLASH_MIN_SEQ``).

Tolerances: fp32 on both sides, different summation order: 1e-5 abs /
1e-4 rel (the GPT tests' ``TOL``) for outputs, losses, gradients and
parameters after three steps. The key bias gets no gradient in exact
arithmetic (a per-row constant in the scores), so both sides carry
rounding noise of ~1e-9 there, inside ``atol``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, models, parallel
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.ops import nn as pnn

VOCAB, B, T, UNITS, HEADS, HIDDEN, LAYERS = 50, 8, 24, 32, 4, 64, 2
TOL = dict(rtol=1e-4, atol=1e-5)
IMPLS = ["xla", "pallas"]
# valid_length per sample: 1 and T among them
LENGTHS = np.array([24, 1, 13, 7, 24, 19, 2, 10], np.int32)
SPEC = dict(vocab_size=VOCAB, units=UNITS, hidden_size=HIDDEN,
            num_layers=LAYERS, num_heads=HEADS, max_length=T, dropout=0.0)


def _nd(x, dtype=None):
    return jmx.nd.array(x, dtype=dtype or str(x.dtype))


def _jax_params(jnet):
    return {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}


def _jax_bert(impl, seed=0, **kw):
    np.random.seed(seed)
    jmx.random.seed(seed)
    spec = dict(SPEC, **kw)
    jnet = jmodels.get_bert("bert_12_768_12", attention_impl=impl, **spec)
    jnet.initialize(init="xavier")
    jnet(_nd(np.zeros((2, T), np.int32)), _nd(np.zeros((2, T), np.int32)),
         _nd(np.full((2,), T, np.int32)))
    return jnet


def _port_bert(jnet, impl, **kw):
    net = models.get_bert("bert_12_768_12", attention_impl=impl,
                          **dict(SPEC, **kw))
    return load_jax_params(net, _jax_params(jnet), ctx=mx.cpu())


def _batch(seed, lengths=LENGTHS):
    rs = np.random.RandomState(200 + seed)
    tok = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    seg = (np.arange(T)[None, :] >= rs.randint(1, T, (B, 1))).astype(
        np.int32)
    mlm = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
    nsp = rs.randint(0, 2, (B,)).astype(np.float32)
    return tok, seg, lengths, mlm, nsp


def _jax_forward(jnet, tok, seg, vl):
    out = jnet(_nd(tok), None if seg is None else _nd(seg), _nd(vl))
    outs = out if isinstance(out, tuple) else (out,)
    return [o.asnumpy() for o in outs]


def _port_forward(net, tok, seg, vl):
    out = net(torch.from_numpy(tok),
              None if seg is None else torch.from_numpy(seg),
              torch.from_numpy(vl))
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach().numpy() for o in outs]


def _pretrain_losses():
    """bench.py's BERT objective: MLM cross entropy plus NSP cross
    entropy, each a mean, in each package."""
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def jloss(seq, pooled, mlm_scores, nsp_scores, mlm_y, nsp_y):
        return jce(mlm_scores, mlm_y).mean() + jce(nsp_scores, nsp_y).mean()

    def loss(seq, pooled, mlm_scores, nsp_scores, mlm_y, nsp_y):
        return ce(mlm_scores, mlm_y).mean() + ce(nsp_scores, nsp_y).mean()

    return jloss, loss


def _assert_close(got, want, names=None):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=str(names and names[i]),
                                   **TOL)


# ---------------------------------------------------------------------------
# the attention core and the blocks
# ---------------------------------------------------------------------------
SDPA_CASES = {
    "mask": dict(tq=6, mask=True),
    "causal": dict(tq=7, causal=True),
    "causal_tq_lt_tk_with_mask": dict(tq=3, causal=True, mask=True),
    "scale": dict(tq=7, scale=0.3, mask=True),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_scaled_dot_product_attention_matches_jax(case):
    c = SDPA_CASES[case]
    rs = np.random.RandomState(1)
    q = rs.randn(2, 3, c["tq"], 8).astype(np.float32)
    k, v = (rs.randn(2, 3, 7, 8).astype(np.float32) for _ in range(2))
    kw = {n: c[n] for n in ("causal", "scale") if n in c}
    mask = None
    if c.get("mask"):
        mask = (np.arange(7)[None, None, None, :]
                < np.array([7, 4]).reshape(2, 1, 1, 1)).astype(np.float32)
    jmask = None if mask is None else _nd(mask)
    want = jmx.nd.scaled_dot_product_attention(
        _nd(q), _nd(k), _nd(v), mask=jmask, **kw).asnumpy()
    got = pnn.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with mx.cpu():              # the mx.nd front door, the same op
        nd = mx.nd.scaled_dot_product_attention(
            mx.nd.array(q), mx.nd.array(k), mx.nd.array(v),
            mask=None if mask is None else mx.nd.array(mask), **kw)
    assert torch.equal(nd._data, got)


def test_scaled_dot_product_attention_keeps_bf16_scores():
    """In bf16 the scores and their scale are bf16, the softmax fp32, the
    weights bf16 again (the reference's order), against the JAX op."""
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 2, 5, 8).astype(np.float32) for _ in range(3))
    want = jmx.nd.scaled_dot_product_attention(
        *(_nd(a).astype("bfloat16") for a in (q, k, v)), causal=True)
    got = pnn.scaled_dot_product_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype("float32").asnumpy(),
                               rtol=2 ** -7, atol=2 ** -8)


def _carry(jblock, block):
    params = {n: p.data().asnumpy() for n, p in collect_params(
        jblock).items()}
    return load_jax_params(block, params, ctx=mx.cpu())


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_head_attention_matches_jax(impl):
    np.random.seed(3)
    jmx.random.seed(3)
    jblock = jmodels.MultiHeadAttention(UNITS, HEADS, attention_impl=impl)
    jblock.initialize(init="xavier")
    x = np.random.RandomState(4).randn(B, T, UNITS).astype(np.float32)
    jblock(_nd(x), None, _nd(LENGTHS))
    block = _carry(jblock, models.MultiHeadAttention(
        UNITS, HEADS, attention_impl=impl))
    want = jblock(_nd(x), None, _nd(LENGTHS)).asnumpy()
    got = block(torch.from_numpy(x), None, torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # no lengths: every key
    want = jblock(_nd(x)).asnumpy()
    np.testing.assert_allclose(block(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)


def test_positionwise_ffn_matches_jax():
    np.random.seed(5)
    jmx.random.seed(5)
    jblock = jmodels.PositionwiseFFN(UNITS, HIDDEN)
    jblock.initialize(init="xavier")
    x = np.random.RandomState(6).randn(B, T, UNITS).astype(np.float32)
    want = jblock(_nd(x)).asnumpy()
    block = _carry(jblock, models.PositionwiseFFN(UNITS, HIDDEN))
    np.testing.assert_allclose(block(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_cell_matches_jax(impl):
    np.random.seed(7)
    jmx.random.seed(7)
    jblock = jmodels.TransformerEncoderCell(UNITS, HIDDEN, HEADS,
                                            dropout=0.0, attention_impl=impl)
    jblock.initialize(init="xavier")
    x = np.random.RandomState(8).randn(B, T, UNITS).astype(np.float32)
    want = jblock(_nd(x), None, _nd(LENGTHS)).asnumpy()
    block = _carry(jblock, models.TransformerEncoderCell(
        UNITS, HIDDEN, HEADS, dropout=0.0, attention_impl=impl))
    got = block(torch.from_numpy(x), None, torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_ring_attention_waits_for_multi_gpu():
    with pytest.raises(NotImplementedError, match="item 10"):
        models.MultiHeadAttention(UNITS, HEADS, attention_impl="ring")
    with pytest.raises(ValueError, match="not divisible"):
        models.MultiHeadAttention(UNITS, 5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_bert_model_outputs_match_jax(impl):
    jnet = _jax_bert(impl, seed=9)
    net = _port_bert(jnet, impl)
    tok, seg, vl, _, _ = _batch(0)
    want = _jax_forward(jnet, tok, seg, vl)
    got = _port_forward(net, tok, seg, vl)
    assert [g.shape for g in got] == [(B, T, UNITS), (B, UNITS),
                                      (B, T, VOCAB), (B, 2)]
    _assert_close(got, want, ["seq", "pooled", "mlm", "nsp"])
    # no segment ids: segment 0 everywhere
    _assert_close(_port_forward(net, tok, None, vl),
                  _jax_forward(jnet, tok, None, vl))


@pytest.mark.parametrize("impl", IMPLS)
def test_bert_model_with_the_heads_off_matches_jax(impl):
    heads = dict(use_pooler=False, use_decoder=False, use_classifier=False)
    jnet = _jax_bert(impl, seed=10, **heads)
    net = _port_bert(jnet, impl, **heads)
    assert len(tensors_of(net)) == 5 + 16 * LAYERS
    tok, seg, vl, _, _ = _batch(1)
    got = _port_forward(net, tok, seg, vl)
    assert len(got) == 1 and got[0].shape == (B, T, UNITS)
    _assert_close(got, _jax_forward(jnet, tok, seg, vl))
    # the pooler alone
    jnet = _jax_bert(impl, seed=10, use_decoder=False, use_classifier=False)
    net = _port_bert(jnet, impl, use_decoder=False, use_classifier=False)
    _assert_close(_port_forward(net, tok, seg, vl),
                  _jax_forward(jnet, tok, seg, vl))
    with pytest.raises(ValueError, match="requires use_pooler"):
        models.BERTModel(use_pooler=False, use_classifier=True)


@pytest.mark.parametrize("impl", IMPLS)
def test_pretraining_gradients_match_jax(impl):
    jnet = _jax_bert(impl, seed=11)
    net = _port_bert(jnet, impl)
    tok, seg, vl, mlm, nsp = _batch(2)
    jloss, loss = _pretrain_losses()
    with jmx.autograd.record():
        jl = jloss(*jnet(_nd(tok), _nd(seg), _nd(vl)), _nd(mlm), _nd(nsp))
    jl.backward()
    with mx.autograd.record():
        pl = loss(*net(torch.from_numpy(tok), torch.from_numpy(seg),
                       torch.from_numpy(vl)),
                  torch.from_numpy(mlm), torch.from_numpy(nsp))
    mx.autograd.backward(pl)
    np.testing.assert_allclose(float(pl.detach()), float(jl.asnumpy()),
                               **TOL)
    want = {n: p.grad().asnumpy() for n, p in collect_params(jnet).items()}
    got = {n: p.grad.numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want) and len(got) == 15 + 16 * LAYERS
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.mark.parametrize("impl", IMPLS)
def test_spmd_trainer_three_steps_match_jax(impl):
    jnet = _jax_bert(impl, seed=12)
    net = _port_bert(jnet, impl)
    jloss, loss = _pretrain_losses()
    jst = jparallel.SPMDTrainer(jnet, jloss, "sgd", dict(SGD))
    st = parallel.SPMDTrainer(net, loss, "sgd", dict(SGD))
    for i in range(3):
        tok, seg, vl, mlm, nsp = _batch(3 + i)
        want = float(jst.step([tok, seg, vl], [mlm, nsp]))
        got = st.step([tok, seg, vl], [mlm, nsp])
        np.testing.assert_allclose(float(got), want, **TOL)
    st.sync_to_net()
    want = {n: np.asarray(v) for n, v in jst.params.items()}
    got = {n: p.detach().numpy() for n, p in tensors_of(net).items()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_run_superstep_equals_k_steps_and_jax(impl):
    """A window of K=3 distinct batches (``valid_length`` a (K, B) window
    too): on the CPU ``run_superstep`` runs the same step body K times, so
    its [K] losses and parameters equal K ``step()`` calls bit for bit,
    and the losses equal the JAX trainer's three steps."""
    jnet = _jax_bert(impl, seed=13)
    _, loss = _pretrain_losses()
    jloss, _ = _pretrain_losses()
    batches = [_batch(6 + i, lengths=np.roll(LENGTHS, i)) for i in range(3)]
    window = [np.stack([b[j] for b in batches]) for j in range(5)]
    graph = parallel.SPMDTrainer(_port_bert(jnet, impl), loss, "sgd",
                                 dict(SGD))
    eager = parallel.SPMDTrainer(_port_bert(jnet, impl), loss, "sgd",
                                 dict(SGD))
    got = graph.run_superstep(window[:3], window[3:])
    assert got.shape == (3,) and graph.superstep_window == 3
    want = torch.stack([eager.step(list(b[:3]), list(b[3:]))
                        for b in batches])
    assert torch.equal(got, want)
    for n, v in graph.params.items():
        assert torch.equal(v, eager.params[n]), n
    jst = jparallel.SPMDTrainer(jnet, jloss, "sgd", dict(SGD))
    jax_losses = [float(jst.step(list(b[:3]), list(b[3:]))) for b in batches]
    np.testing.assert_allclose(got.numpy(), jax_losses, **TOL)


def test_get_bert_specs_and_unknown_name():
    for name, (layers, units, heads) in {
            "bert_12_768_12": (12, 768, 12),
            "bert_24_1024_16": (24, 1024, 16)}.items():
        net = models.get_bert(name)
        params = dict(net.named_parameters())
        assert len(params) == 15 + 16 * layers
        assert params["word_embed.weight"].shape == (30522, units)
        assert params["position_embed.weight"].shape == (512, units)
        assert params["encoder.layer0.ffn.ffn1.weight"].shape == \
            (4 * units, units)
        assert params["mlm_decoder.2.weight"].shape == (30522, units)
        assert hasattr(net.encoder, f"layer{layers - 1}")
        assert net.encoder.layer0.attention._heads == heads
    # BERT-base's values: the embeddings and their norm, 12 layers, the
    # pooler, the NSP classifier and the MLM decoder
    c, v = 768, 30522
    layer = 4 * (c * c + c) + 2 * c + 2 * (4 * c * c) + 4 * c + c + 2 * c
    assert sum(p.numel() for p in models.get_bert().parameters()) == \
        (v + 2 + 512) * c + 2 * c + 12 * layer + (c * c + c) \
        + (2 * c + 2) + (c * c + c + 2 * c + v * c + v) == 133_547_324
    with pytest.raises(ValueError, match="unknown bert spec"):
        models.get_bert("bert_6_512_8")
    with pytest.raises(ValueError, match="unknown bert spec"):
        jmodels.get_bert("bert_6_512_8")


@pytest.mark.parametrize("impl", IMPLS)
def test_padding_does_not_reach_the_valid_positions(impl):
    """Every token at or beyond a sample's ``valid_length`` changed: the
    sequence output at the valid positions stays bit for bit, the MLM
    scores there and the pooled and NSP outputs too, and the changed
    batch agrees with the JAX package."""
    jnet = _jax_bert(impl, seed=14)
    net = _port_bert(jnet, impl)
    tok, seg, vl, _, _ = _batch(9)
    pad = np.arange(T)[None, :] >= vl[:, None]
    tok2 = np.where(pad, (tok + 17) % VOCAB, tok).astype(np.int32)
    seg2 = np.where(pad, 1 - seg, seg).astype(np.int32)
    a = _port_forward(net, tok, seg, vl)
    b = _port_forward(net, tok2, seg2, vl)
    keep = ~pad
    assert np.array_equal(a[0][keep], b[0][keep])
    assert np.array_equal(a[2][keep], b[2][keep])
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[3], b[3])
    assert not np.array_equal(a[0][pad], b[0][pad])
    _assert_close(b, _jax_forward(jnet, tok2, seg2, vl))


@pytest.mark.parametrize("impl", IMPLS)
def test_non_integer_float_lengths_match_jax_per_impl(impl):
    """A float ``valid_length`` with fractions: the "xla" impl compares
    positions with the float (9.7 admits 10 keys), the "pallas" impl
    truncates it (9 keys), in the JAX package and in the port alike; an
    integral float equals the int32 call."""
    jnet = _jax_bert(impl, seed=15)
    net = _port_bert(jnet, impl)
    tok, seg, _, _, _ = _batch(10)
    vl = np.array([9.7, 1.0, 24.0, 1.5, 3.2, 12.9, 23.5, 6.0], np.float32)
    got = _port_forward(net, tok, seg, vl)
    _assert_close(got, _jax_forward(jnet, tok, seg, vl))
    keys = np.floor(vl) if impl == "pallas" else np.ceil(vl)
    as_int = _port_forward(net, tok, seg, keys.astype(np.int32))
    for g, w in zip(got, as_int):
        assert np.array_equal(g, w)
