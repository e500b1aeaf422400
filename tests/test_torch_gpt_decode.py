"""Port parity: the GPT decoder and KV-cache decode serving.

A tiny GPT (2 layers, 32 units, 4 heads, vocab 61, max_length 48, as in
``tests/test_decode.py``) is drawn in the JAX package and carried into the
port with ``load_jax_params``. On the CPU the port's attention is the plain
version of its CUDA kernel. Logits, prefill planes and decode-step caches
agree to 1e-5 (both sides are fp32 and differ only in summation order);
greedy streams are compared for equality.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params

VOCAB = 61
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_net(seed=0, max_length=48):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                      num_layers=2, max_length=max_length, dropout=0.1)
    net.initialize(init="xavier")
    net(jmx.nd.array(np.ones((1, 2)), dtype="int32"))
    return net


def _port_net(jnet, max_length=48):
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                  num_layers=2, max_length=max_length, dropout=0.1)
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    return load_jax_params(net, params, ctx=mx.cpu())


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net()
    return jnet, _port_net(jnet)


def _prompts(ns, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB, (int(n),)).astype(np.int32) for n in ns]


def _jax_oracle(net, prompt, n_new):
    """Greedy reference: re-run the JAX full causal forward per token. The
    sequence rides a fixed (1, 48) zero-padded buffer, so every call has
    one shape (one set of XLA compiles); causality keeps the padding out
    of the logits read at the last real position."""
    seq, out = [int(t) for t in prompt], []
    for _ in range(n_new):
        buf = np.zeros((1, 48), np.int32)
        buf[0, :len(seq)] = seq
        lg = net(jmx.nd.array(buf, dtype="int32")).asnumpy()
        tok = int(np.argmax(lg[0, len(seq) - 1]))
        out.append(tok)
        seq.append(tok)
    return out


def _port_oracle(net, prompt, n_new, eos=None):
    seq, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n_new):
            tok = int(torch.argmax(net(torch.tensor([seq]))[0, -1]))
            out.append(tok)
            seq.append(tok)
            if eos is not None and tok == eos:
                break
    return out


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step against the JAX package
# ---------------------------------------------------------------------------
def test_forward_logits_match_jax(nets):
    jnet, net = nets
    tokens = np.random.RandomState(1).randint(0, VOCAB, (2, 13))
    want = jnet(jmx.nd.array(tokens, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 13, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_logits_and_kv_planes_match_jax(nets):
    jnet, net = nets
    tokens = np.random.RandomState(2).randint(0, VOCAB, (1, 16))
    want = [a.asnumpy() for a in jnet.prefill(jmx.nd.array(tokens,
                                                           dtype="int32"))]
    got = [t.numpy() for t in net.prefill(torch.from_numpy(tokens))]
    assert got[1].shape == (2, 1, 4, 16, 8)        # (L, B, H, T, D)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_decode_step_logits_and_caches_match_jax(nets):
    jnet, net = nets
    rs = np.random.RandomState(3)
    shape = (2, 4, 4, 48, 8)                       # (L, S, H, T, D)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    cache_len = np.array([5, 0, 17, 47], np.int32)
    tokens = rs.randint(0, VOCAB, (4,)).astype(np.int32)
    want = jnet.decode_step(jmx.nd.array(tokens, dtype="int32"),
                            jmx.nd.array(k), jmx.nd.array(v),
                            jmx.nd.array(cache_len, dtype="int32"))
    got = net.decode_step(torch.from_numpy(tokens), torch.from_numpy(k.copy()),
                          torch.from_numpy(v.copy()),
                          torch.from_numpy(cache_len))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.asnumpy(), **TOL)
    # the new rows landed at cache_len and nothing else moved
    changed = np.any(got[1].numpy() != k, axis=(0, 2, 4))    # (S, T)
    assert [list(np.flatnonzero(c)) for c in changed] == [[5], [0], [17],
                                                          [47]]


def test_load_jax_params_checks_names_and_shapes(nets):
    jnet, _ = nets
    params = {n: p.data().asnumpy() for n, p in collect_params(jnet).items()}
    fresh = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                    num_layers=2, max_length=48)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(fresh, {k: v for k, v in params.items()
                                if k != "ln_f.beta"}, ctx=mx.cpu())
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_params(fresh, dict(params, extra=np.zeros(1)), ctx=mx.cpu())
    bad = dict(params)
    bad["head.weight"] = np.zeros((VOCAB, 31), np.float32)
    with pytest.raises(ValueError, match="head.weight"):
        load_jax_params(fresh, bad, ctx=mx.cpu())
    assert fresh.device.type == "meta"      # nothing changed on a refusal


def test_initialize_is_seeded_xavier_with_name_dispatch():
    def draw():
        mx.random.seed(11)
        return get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                       num_layers=2, max_length=48).initialize(
                           "xavier", ctx=mx.cpu())

    a, b = draw(), draw()
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.device.type == "cpu" and p.dtype == torch.float32
    pa = tensors_of(a)
    assert torch.all(pa["layer0.attn.qkv.bias"] == 0)
    assert torch.all(pa["ln_f.beta"] == 0)
    assert torch.all(pa["layer1.ln2.gamma"] == 1)
    w = pa["layer0.ffn1.weight"].detach()              # (128, 32)
    bound = np.sqrt(3.0 / ((128 + 32) / 2.0))
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3


# ---------------------------------------------------------------------------
# serving: greedy streams against the JAX session and oracle
# ---------------------------------------------------------------------------
def test_greedy_streams_equal_jax_session_and_oracle_across_churn(nets):
    jnet, net = nets
    prompts = _prompts([5, 11, 3, 16, 7, 9, 13, 4])
    news = [6, 9, 4, 7, 12, 5, 8, 10]
    jsess = jserving.DecodeSession(jnet, max_slots=4, max_len=48,
                                   prefill_buckets=(8, 16), name="tparity")
    try:
        jsess.warmup()
        want = [h.result(120) for h in
                [jsess.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]]
    finally:
        jsess.close()
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=4, max_len=48,
                                 prefill_buckets=(8, 16), name="churn")
    try:
        sess.warmup()
        got = [h.result(120) for h in
               [sess.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]]
        s = sess.stats()
        assert sess.drain(60)
    finally:
        sess.close()
    for i, (p, n) in enumerate(zip(prompts, news)):
        assert got[i] == want[i], f"request {i}: port != JAX session"
        assert got[i] == _jax_oracle(jnet, p, n), f"request {i}: != oracle"
    # 8 ragged sequences over 4 slots: continuous batching overlapped them
    assert s["finished"] == len(prompts)
    assert s["mean_step_occupancy"] > 1.0
    assert s["tokens"] == sum(len(g) for g in got)
    assert 0.0 < s["prefill_frac"] < 1.0


def test_eos_and_cache_capacity_end_generation(nets):
    _, net = nets
    prompt = _prompts([9], seed=3)[0]
    eos = _port_oracle(net, prompt, 8)[3]
    want = _port_oracle(net, prompt, 8, eos=eos)
    long_prompt = _prompts([20])[0]
    with serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=24,
                               prefill_buckets=(16, 20), name="ends") as sess:
        assert sess.generate(prompt, max_new_tokens=8, eos_id=eos) == want
        got = sess.generate(long_prompt, max_new_tokens=100)
        # prefill fills 20 of 24; the step that fills the last position
        # still emits its token
        assert got == _port_oracle(net, long_prompt, 24 - 20 + 1)
        assert len(sess.generate(_prompts([4])[0], max_new_tokens=3)) == 3


def test_defaults_come_from_config_knobs(nets):
    _, net = nets
    knobs = {"MXTPU_DECODE_SLOTS": 3, "MXTPU_DECODE_MAX_LEN": 32,
             "MXTPU_DECODE_BUCKETS": "8,16,64",
             "MXTPU_DECODE_MAX_NEW_TOKENS": 4}
    for k, v in knobs.items():
        config.set(k, v)
    try:
        with serving.DecodeSession(net, ctx=mx.cpu(), name="knobs") as sess:
            assert (sess.max_slots, sess.max_len) == (3, 32)
            assert sess.prefill_buckets == (8, 16)  # 64 > max_len drops
            assert len(sess.generate(_prompts([5])[0])) == 4
    finally:
        for k in knobs:
            config.unset(k)


def test_prefill_through_the_cache_matches_the_jax_session(nets):
    """Prefill through the session's ``BucketedExecutorCache`` (one
    executable per prompt bucket, the true length passed as an int32
    scalar): the first token and the K/V planes of several true lengths in
    one bucket against the JAX session's ``_prefill_apply``; one
    executable serves them all, and the prefill cache counts them."""
    import jax.numpy as jnp

    jnet, net = nets
    jsess = jserving.DecodeSession(jnet, max_slots=1, max_len=48,
                                   prefill_buckets=(16,), name="jprefill")
    jsess.close()
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=48,
                                 prefill_buckets=(8, 16), name="prefill")
    try:
        for n, prompt in zip((9, 13, 16), _prompts([9, 13, 16], seed=11)):
            padded = np.zeros((16,), np.int32)
            padded[:n] = prompt
            want = [np.asarray(a) for a in jsess._prefill_apply(
                jsess._params, jnp.asarray(padded), jnp.int32(n))]
            with sess._exec_lock:
                got = [t.numpy() for t in sess._prefill(prompt)]
            assert int(got[0]) == int(want[0]), n
            assert got[1].shape == want[1].shape == (2, 4, 16, 8)
            # the planes past n are the padding's: both sides compute them
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, **TOL)
        stats = sess.stats()["prefill_cache"]
        assert (stats["misses"], stats["hits"], stats["compiles"]) \
            == (1, 2, 0)
    finally:
        sess.close()


# ---------------------------------------------------------------------------
# front door: backpressure, deadline shedding, lifecycle
# ---------------------------------------------------------------------------
def test_backpressure_queue_full(nets):
    _, net = nets
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=48,
                                 prefill_buckets=(8,), max_queue=4,
                                 name="bp")
    try:
        handles = [sess.submit(p, max_new_tokens=20)
                   for p in _prompts([5, 5])]
        with pytest.raises(serving.QueueFullError) as ei:
            for _ in range(30):                # queue capacity is 4
                handles.append(sess.submit(_prompts([5])[0],
                                           max_new_tokens=20))
        assert ei.value.retry_after > 0
        assert sess.stats()["rejected"] >= 1
        for h in handles:
            assert len(h.result(120)) == 20
    finally:
        sess.close()


def test_deadline_shed_while_queued():
    mx.random.seed(0)
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=32,
                  num_layers=2, max_length=448).initialize("xavier",
                                                           ctx=mx.cpu())
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=448,
                                 prefill_buckets=(8,), deadline_ms=30.0,
                                 name="shed")
    try:
        first = sess.submit(_prompts([6])[0], max_new_tokens=400)
        next(iter(first))             # the slot is now provably occupied
        late = [sess.submit(p, max_new_tokens=2)
                for p in _prompts([4, 4], seed=9)]
        for h in late:
            with pytest.raises(serving.DeadlineExceededError) as ei:
                h.result(120)
            assert ei.value.retry_after > 0
        # the sweep runs at every step boundary: expired requests fail
        # while the single slot is still mid-generation
        assert not first.done(), "shed should not wait for a free slot"
        assert len(first.result(300)) == 400
        assert sess.stats()["shed"] == len(late)
    finally:
        sess.close()


def test_submit_validation_and_lifecycle(nets):
    _, net = nets
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=16,
                                 prefill_buckets=(8,), name="val")
    with pytest.raises(ValueError, match="empty"):
        sess.submit([])
    with pytest.raises(ValueError, match="bucket"):
        sess.submit(np.arange(9))              # > largest bucket
    with pytest.raises(ValueError, match=r"\[0, 61\)"):
        sess.submit([1, VOCAB])
    sess2 = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=8,
                                  prefill_buckets=(8,), name="val2")
    try:
        with pytest.raises(ValueError, match="cache room"):
            sess2.submit(np.arange(8))         # prompt == max_len
    finally:
        sess2.close()
    h = sess.healthz()
    assert h["ready"] and h["state"] == "running"
    assert h["slots"] == {"active": 0, "total": 1}
    assert sess.drain(30)
    with pytest.raises(serving.ServerClosedError):
        sess.submit([1, 2])
    assert not sess.healthz()["ready"]
    sess.close()
    assert not sess._worker.is_alive()


def test_close_fails_queued_and_active_requests(nets):
    _, net = nets
    sess = serving.DecodeSession(net, ctx=mx.cpu(), max_slots=1, max_len=48,
                                 prefill_buckets=(8,), name="close")
    running = sess.submit(_prompts([5])[0], max_new_tokens=40)
    next(iter(running))
    queued = sess.submit(_prompts([5])[0], max_new_tokens=5)
    sess.close()
    for h in (running, queued):
        assert isinstance(h.exception(10), serving.ServerClosedError)
    assert not sess._worker.is_alive()
