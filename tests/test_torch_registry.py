"""Port parity: weight hot-swap, the model registry and the artifact store.

The cases of the JAX package's ``tests/test_registry.py`` (and the
hot-swap cases of ``tests/test_serving.py``) on the port's entry points on
the CPU, where an executable is the eager apply and nothing is captured.
Weights are drawn in the JAX package and carried across with
``load_jax_params`` or published as its ``collect_params`` dict:

* a Dense net served by both packages' ``ModelServer`` through the same
  sequence of publishes (dict, partial, positional, unchanged): the swap
  stats (``params``/``aliased``/``updated``/``carried``) equal, every
  served row within 1e-6; the refusals raise what the reference raises;
* the miniature fused ResNet: a JAX-named dict publishes straight into
  the port's server, the stats equal the JAX cache's staging, and the
  served rows equal the eager forward of the new weights (1e-5);
* a tiny GPT (2 layers, 16 units): decode streams before and after a
  publish equal the JAX full-forward oracle of each version;
* the registry (LRU within a budget, never evicting an in-flight model,
  SLO admission, deferred and resident publishes, the published version
  surviving an eviction, a lone over-budget model). The JAX registry's own
  runs of two of these fail on the 8-device CPU mesh (its artifact path),
  so the port's served rows are held against the JAX block's plain
  forward instead;
* the artifact store: round trip, a stale guard field refused and
  repersisted, a corrupt file, the eager scan, the knob. On the CPU a
  stored artifact's payload (the kernel libraries) is empty: the store's
  contract is what is tested here, and the kernel libraries' round trip
  on an empty build directory in ``chip_smoke.py``'s registry phase.

The card's cases (a swap then a replay equal to eager on the new weights,
eviction returning the graph memory) are in
``tests/test_torch_graph_capture.py``.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.config import config as jconfig
from incubator_mxnet_tpu.gluon.model_zoo import get_gpt as jax_get_gpt
from incubator_mxnet_tpu.gluon.model_zoo.vision import fused_resnet as jfr
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import FusedResNetV1
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.serving import artifacts
from incubator_mxnet_tpu_torch.serving.artifacts import ArtifactStore

CPU = mx.cpu()
VOCAB = 37
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _knobs():
    yield
    for k in ("MXTPU_SERVING_ARTIFACT_DIR", "MXTPU_REGISTRY_BUDGET_MB",
              "MXTPU_REGISTRY_MAX_RESIDENT"):
        config.unset(k)


def _weights(jnet):
    return {k: p.data().asnumpy() for k, p in collect_params(jnet).items()}


def _jax_dense(seed, out=3, inp=4):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jmx.gluon.nn.Dense(out, in_units=inp)
    net.initialize(jmx.initializer.Xavier(rnd_type="gaussian"))
    return net


def _port_dense(jnet, out=3, inp=4):
    return load_jax_params(mx.gluon.nn.Dense(out, in_units=inp),
                           _weights(jnet), ctx=CPU)


def _jax_forward(jnet, x):
    return jnet(jmx.nd.array(x[None])).asnumpy()[0]


def _jax_gpt(seed):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jax_get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=16,
                      num_layers=2, max_length=32, dropout=0.0)
    net.initialize(init="xavier")
    return net


def _port_gpt(jnet):
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=16,
                  num_layers=2, max_length=32, dropout=0.0)
    return load_jax_params(net, _weights(jnet), ctx=CPU)


def _jax_oracle(net, prompt, n_new):
    """Greedy reference: the JAX full causal forward per token, on one
    (1, 32) zero-padded buffer (causality keeps the padding out)."""
    seq, out = [int(t) for t in prompt], []
    for _ in range(n_new):
        buf = np.zeros((1, 32), np.int32)
        buf[0, :len(seq)] = seq
        lg = net(jmx.nd.array(buf, dtype="int32")).asnumpy()
        tok = int(np.argmax(lg[0, len(seq) - 1]))
        out.append(tok)
        seq.append(tok)
    return out


@pytest.fixture(scope="module")
def gpts():
    ja, jb = _jax_gpt(0), _jax_gpt(1)
    prompt = np.random.RandomState(6).randint(1, VOCAB, (5,)).astype(
        np.int32)
    return dict(ja=ja, jb=jb, prompt=prompt,
                want_a=_jax_oracle(ja, prompt, 4),
                want_b=_jax_oracle(jb, prompt, 4))


SWAP_KEYS = ("params", "aliased", "updated", "carried")


# ---------------------------------------------------------------------------
# hot-swap: the stats and the served rows against the JAX server
# ---------------------------------------------------------------------------
def test_swap_stats_and_rows_equal_the_jax_server_over_a_publish_sequence():
    ja, jb, jc = _jax_dense(0), _jax_dense(1), _jax_dense(2)
    wb, wc = _weights(jb), _weights(jc)
    publishes = [
        ("dict", wb, "v1"),
        ("partial", {"weight": wc["weight"]}, None),
        ("positional", [wc["weight"], wc["bias"]], 7),
        ("unchanged", dict(wc), None),
    ]
    xs = np.random.RandomState(3).rand(5, 4).astype(np.float32)
    jsrv = jserving.ModelServer(ja, buckets=(1, 2, 4), max_wait_ms=1.0,
                                artifact_dir="")
    srv = serving.ModelServer(_port_dense(ja), buckets=(1, 2, 4),
                              max_wait_ms=1.0, ctx=CPU, artifact_dir="")
    try:
        jsrv.warmup((4,), "float32")
        srv.warmup((4,), "float32")
        assert srv._cache.param_names == list(collect_params(ja))
        for label, source, version in publishes:
            want = jsrv.publish_weights(source, version=version)
            got = srv.publish_weights(source, version=version)
            assert {k: got[k] for k in SWAP_KEYS} \
                == {k: want[k] for k in SWAP_KEYS}, label
            assert got["version"] == want["version"], label
            jrows = np.stack([np.asarray(jsrv.predict(x)) for x in xs])
            rows = np.stack([srv.predict(x) for x in xs])
            np.testing.assert_allclose(rows, jrows, **TOL, err_msg=label)
        assert srv.weights_version == jsrv.weights_version == 8
        assert srv.stats()["swaps"] == 4
        assert srv.healthz()["weights_version"] == 8
    finally:
        jsrv.close()
        srv.close()


def test_positional_weight_publish_and_version_autobump():
    """As the reference's: versions count up from 0, zeros serve zeros, an
    identical publish leaves every parameter alone."""
    srv = serving.ModelServer(_port_dense(_jax_dense(0)), buckets=(1,),
                              ctx=CPU, artifact_dir="")
    try:
        srv.warmup((4,), "float32")
        x = np.ones(4, np.float32)
        before = srv.predict(x)
        new = [np.zeros(tuple(p.shape), np.float32)
               for p in srv._cache._params]
        stats = srv.publish_weights(new)
        assert stats["version"] == 1 and srv.weights_version == 1
        np.testing.assert_array_equal(srv.predict(x), np.zeros_like(before))
        stats = srv.publish_weights(new)
        assert stats["version"] == 2
        assert stats["aliased"] == len(new)
    finally:
        srv.close()


def test_fused_resnet_publishes_a_jax_named_dict():
    """The miniature fused ResNet: a dict of the JAX package's
    ``collect_params`` names goes straight in; the stats equal the JAX
    cache's staging of the same dict; the served rows equal the eager
    forward of a net loaded with the new weights (1e-5, as the serving
    tests hold a fused ResNet)."""
    jnet = jfr.FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256],
                             classes=10)
    jnet.initialize(init="xavier")
    rs = np.random.RandomState(8)
    v0 = {k: (rs.randn(*v.shape) * 0.1).astype(np.float32)
          for k, v in _weights(jnet).items()}
    for k in v0:
        if k.endswith(("running_var", "gamma")):
            v0[k] = np.abs(v0[k]) + 0.5
    v1 = {k: (v * 1.25 if k.endswith("weight") else v)
          for k, v in v0.items()}

    def port(ws):
        net = FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256], classes=10)
        return load_jax_params(net, ws, ctx=CPU)

    for k, p in collect_params(jnet).items():
        p.set_data(jmx.nd.array(v0[k]))
    want_stats = jserving.BucketedExecutorCache.from_block(
        jnet, buckets=(1,), artifact_dir="").stage_params(v1).stats
    srv = serving.ModelServer(port(v0), buckets=(1, 2), max_wait_ms=1.0,
                              ctx=CPU, artifact_dir="")
    try:
        srv.warmup((3, 32, 32), "float32")
        stats = srv.publish_weights(v1)
        x = np.random.RandomState(9).rand(2, 3, 32, 32).astype(np.float32)
        rows = np.stack([srv.predict(r) for r in x])
    finally:
        srv.close()
    assert {k: stats[k] for k in SWAP_KEYS} == dict(want_stats)
    assert stats["updated"] > 0 and stats["aliased"] > 0
    with torch.no_grad(), mx.autograd.pause():
        want = port(v1)(torch.from_numpy(x)).numpy()
    err = np.linalg.norm(rows - want) / np.linalg.norm(want)
    assert err <= 1e-5, err


def _refusal_cases(tmp_path):
    other = mx.gluon.nn.Dense(2, in_units=3).initialize(ctx=CPU)
    ckpt = str(tmp_path / "other.params")
    # a Sequential's names ("0.weight") match nothing a bare Dense serves
    seq = mx.gluon.nn.Sequential()
    seq.add(other)
    seq.save_parameters(ckpt)
    sharded = str(tmp_path / "step0")
    with open(sharded + ".manifest.json", "w") as f:
        f.write("{}")
    return {
        "unknown": ({"nope": np.zeros((3, 4), np.float32)}, {},
                    ValueError, "unknown parameter"),
        "shape": ({"weight": np.zeros((7, 9), np.float32)}, {},
                  ValueError, "signature-frozen"),
        "dtype": ({"weight": np.zeros((3, 4), np.float64)}, {},
                  ValueError, "signature-frozen"),
        "partial": ({"weight": np.zeros((3, 4), np.float32)},
                    {"allow_partial": False}, ValueError,
                    "partial weight publish refused"),
        "positional": ([np.zeros((3, 4), np.float32)], {}, ValueError,
                       "positional publish must cover all"),
        "zero_match": (ckpt, {}, ValueError, "no tensors matching"),
        "sharded": (sharded, {}, NotImplementedError, "item 10"),
    }


@pytest.mark.parametrize("case", ["unknown", "shape", "dtype", "partial",
                                  "positional", "zero_match", "sharded"])
def test_publish_refusals_match_the_reference(tmp_path, case):
    """Each refusal raises before anything changes: the version stays 0 and
    the rows stay the old ones. The JAX server refuses the same sources
    with the same message (its sharded reader exists, so that case is
    the port's alone)."""
    source, kwargs, exc, match = _refusal_cases(tmp_path)[case]
    ja = _jax_dense(0)
    srv = serving.ModelServer(_port_dense(ja), buckets=(1,), ctx=CPU,
                              artifact_dir="")
    x = np.ones(4, np.float32)
    try:
        srv.warmup((4,), "float32")
        before = srv.predict(x)
        with pytest.raises(exc, match=match):
            srv.publish_weights(source, **kwargs)
        assert srv.weights_version == 0
        np.testing.assert_array_equal(srv.predict(x), before)
    finally:
        srv.close()
    if case == "sharded":
        return
    if case == "zero_match":
        source = str(tmp_path / "other_jax.params")
        jseq = jmx.gluon.nn.HybridSequential()
        jseq.add(jmx.gluon.nn.Dense(2, in_units=3))
        jseq.initialize()
        jseq.save_parameters(source)
    jsrv = jserving.ModelServer(ja, buckets=(1,), artifact_dir="")
    try:
        with pytest.raises(exc, match=match):
            jsrv.publish_weights(source, **kwargs)
    finally:
        jsrv.close()


def test_bf16_parameter_takes_a_bf16_tensor_and_refuses_float32():
    net = _port_dense(_jax_dense(0)).cast("bfloat16")
    cache = serving.BucketedExecutorCache.from_block(net, buckets=(1,),
                                                     ctx=CPU, artifact_dir="")
    w = torch.full((3, 4), 0.5, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        cache.swap_params({"weight": w.float().numpy()})
    stats = cache.swap_params({"weight": w})
    assert stats == {"params": 2, "aliased": 0, "updated": 1, "carried": 1}
    assert torch.equal(net.weight, w)
    # the same bytes again (as a tensor or through ml_dtypes' numpy bf16)
    assert cache.swap_params({"weight": w.clone()})["aliased"] == 1
    bf16_np = jmx.nd.array(w.float().numpy()).astype("bfloat16").asnumpy()
    assert bf16_np.dtype.name == "bfloat16"
    assert cache.swap_params({"weight": bf16_np})["aliased"] == 1


def test_commit_copies_in_place_and_never_rebinds():
    """The resident tensors keep their identity and storage across a swap
    (what keeps a captured graph reading the new values), and the staged
    copies are dropped after the commit."""
    net = _port_dense(_jax_dense(0))
    cache = serving.BucketedExecutorCache.from_block(net, buckets=(1,),
                                                     ctx=CPU, artifact_dir="")
    ids = [(id(p), p.data_ptr()) for p in net.parameters()]
    staged = cache.stage_params(_weights(_jax_dense(1)))
    assert [i for i, _ in staged.updates] == [0]      # both biases are 0
    cache.commit_params(staged)
    assert staged.updates == []
    assert [(id(p), p.data_ptr()) for p in net.parameters()] == ids
    assert [id(p) for p in cache._params] == [i for i, _ in ids]
    np.testing.assert_array_equal(net.weight.detach().numpy(),
                                  _weights(_jax_dense(1))["weight"])


def test_hot_swap_atomic_under_concurrent_predict():
    """Concurrent predict traffic across a publish: every answer equals
    exactly one version's forward, nothing drops, the unchanged bias is
    left alone, and the server stays ready."""
    ja, jb = _jax_dense(0), _jax_dense(1)
    new = _weights(jb)
    new["bias"] = _weights(ja)["bias"]
    net = _port_dense(ja)
    srv = serving.ModelServer(net, buckets=(1, 2, 4), max_wait_ms=0.5,
                              ctx=CPU, name="swap", artifact_dir="")
    try:
        srv.warmup((4,), "float32")
        x = np.random.RandomState(2).rand(4).astype(np.float32)
        out_a = srv.predict(x)
        out_b = x @ new["weight"].T + new["bias"]
        assert not np.allclose(out_a, out_b)
        bias = net.bias
        results, errors = [], []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    results.append(srv.predict(x, timeout=10))
                except Exception as e:   # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        stats = srv.publish_weights(new, version="v2")
        time.sleep(0.15)
        stop.set()
        for t in threads:
            t.join(10)
        assert not errors, errors[:3]
        # a row may ride a batch of 2 or 4, whose sums may round apart
        # from the lone request's: each row is one version's, to 1e-6
        n_a = n_b = 0
        for r in results:
            is_a = np.allclose(r, out_a, rtol=1e-6, atol=1e-6)
            is_b = np.allclose(r, out_b, rtol=1e-6, atol=1e-6)
            assert is_a != is_b, (r, out_a, out_b)
            n_a, n_b = n_a + is_a, n_b + is_b
        assert n_a > 0 and n_b > 0
        assert stats["aliased"] == 1 and stats["updated"] == 1
        assert net.bias is bias and srv.weights_version == "v2"
        assert srv.healthz()["ready"]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# decode: per-version streams against the JAX oracle
# ---------------------------------------------------------------------------
def _session(net, **kw):
    kw.setdefault("artifact_dir", "")
    return serving.DecodeSession(net, ctx=CPU, max_slots=2, max_len=32,
                                 prefill_buckets=(8,), name="hs", **kw)


def test_decode_hot_swap_per_version_streams(gpts):
    """A stream served before the flip equals version 0's JAX oracle, one
    admitted after it version 1's; a sequence in flight across the flip
    finishes; the stats equal the JAX session's for the same dict."""
    ja, jb, prompt = gpts["ja"], gpts["jb"], gpts["prompt"]
    jsess = jserving.DecodeSession(ja, max_slots=2, max_len=32,
                                   prefill_buckets=(8,), artifact_dir="")
    try:
        want_stats = jsess.publish_weights(_weights(jb), version=2)
    finally:
        jsess.close()
    sess = _session(_port_gpt(ja))
    try:
        sess.warmup()
        assert sess.generate(prompt, max_new_tokens=4) == gpts["want_a"]
        h = sess.submit(prompt, max_new_tokens=12)
        first = next(iter(h))
        assert first == gpts["want_a"][0]
        stats = sess.publish_weights(_weights(jb), version=2)
        assert {k: stats[k] for k in SWAP_KEYS} \
            == {k: want_stats[k] for k in SWAP_KEYS}
        full = h.result(60)
        assert len(full) == 12 and full[0] == first
        assert sess.generate(prompt, max_new_tokens=4) == gpts["want_b"]
        assert sess.weights_version == 2
        assert sess.stats()["weights_version"] == 2
        assert sess.stats()["engine_cache"]["compiles"] == 0
        assert sess.engine_metrics.swaps == 1
        assert sess.healthz()["ready"]
    finally:
        sess.close()


def test_decode_publish_withdrawn_on_timeout(gpts):
    """A publish the scheduler never applies times out and is withdrawn:
    it can never flip in later."""
    sess = _session(_port_gpt(gpts["ja"]))
    try:
        sess._apply_pending_swap = lambda: None
        with pytest.raises(TimeoutError, match="not applied"):
            sess.publish_weights(_weights(gpts["jb"]), timeout=0.2)
        assert sess._pending_swap is None and sess.weights_version == 0
    finally:
        sess.close()


def test_decode_handle_done_callbacks(gpts):
    sess = _session(_port_gpt(gpts["ja"]))
    try:
        seen = []
        h = sess.submit(gpts["prompt"], max_new_tokens=3)
        h.add_done_callback(lambda hd: seen.append(hd.result(0)))
        toks = h.result(30)
        h.add_done_callback(lambda hd: seen.append("late"))
        assert seen == [toks, "late"]
    finally:
        sess.close()


def test_decode_resident_bytes_wait_and_donate(gpts):
    net = _port_gpt(gpts["ja"])
    sess = _session(net, donate=True)
    try:
        params = sum(p.numel() * p.element_size() for p in net.parameters())
        assert sess.resident_bytes() == params + sess._kv.nbytes
        assert sess.estimated_wait_s() == 0.0
    finally:
        sess.close()


def test_decode_cost_analysis_against_the_jax_session(gpts):
    """The port counts the matmuls (QKV, output, FFN, QK^T, PV, the head)
    from the model's dimensions; XLA's cost model of the JAX session also
    counts the elementwise work (layer norms, softmax, GELU, the masks):
    at this size the port's count is 0.762 of XLA's for a decode step and
    0.824 for a prefill of 8 tokens."""
    jsess = jserving.DecodeSession(gpts["ja"], max_slots=2, max_len=32,
                                   prefill_buckets=(8,), artifact_dir="")
    try:
        want = (jsess.decode_cost_analysis(), jsess.prefill_cost_analysis(8))
    finally:
        jsess.close()
    sess = _session(_port_gpt(gpts["ja"]))
    try:
        got = (sess.decode_cost_analysis(), sess.prefill_cost_analysis(8))
    finally:
        sess.close()
    assert got == (35136.0, 115968.0)
    assert got[0] / want[0] == pytest.approx(0.762, abs=0.02)
    assert got[1] / want[1] == pytest.approx(0.824, abs=0.02)


# ---------------------------------------------------------------------------
# the model registry
# ---------------------------------------------------------------------------
def _register_three(reg, ja, jb, jgpt, gate=None):
    """Two Dense servers and a decode session; each builder makes its own
    block (what lets an eviction free the parameters too). ``gate``: the
    decode steps wait on it."""
    def gpt(ad):
        sess = _session(_port_gpt(jgpt), artifact_dir=ad)
        if gate is not None:
            step = sess._step
            sess._step = lambda: (gate.wait(30), step())
        return sess

    reg.register("a", lambda ad: serving.ModelServer(
        _port_dense(ja), buckets=(1, 2), ctx=CPU, artifact_dir=ad,
        name="a"), warmup=lambda s: s.warmup((4,), "float32"))
    reg.register("b", lambda ad: serving.ModelServer(
        _port_dense(jb), buckets=(1, 2), ctx=CPU, artifact_dir=ad,
        name="b"), warmup=lambda s: s.warmup((4,), "float32"))
    reg.register("gpt", gpt, kind="decode", warmup=lambda s: s.warmup())


def test_registry_serves_three_models_within_budget_with_lru(tmp_path, gpts):
    """Three models (one a DecodeSession) behind one front door and a
    budget that fits the session and one Dense model: using the third
    evicts the least recently used idle one; the evicted model re-admits
    from its artifacts and serves bit-equal rows; every row is held
    against the JAX block's plain forward."""
    ja, jb = _jax_dense(0), _jax_dense(1)
    d = str(tmp_path / "art")
    x = np.random.RandomState(7).rand(4).astype(np.float32)
    prompt = gpts["prompt"]
    with serving.ModelRegistry(artifact_dir=d, name="probe") as reg:
        _register_three(reg, ja, jb, gpts["ja"])
        out_a = reg.predict("a", x)
        out_b = reg.predict("b", x)
        assert reg.generate("gpt", prompt, max_new_tokens=4) \
            == gpts["want_a"]
        sizes = {n: e.bytes for n, e in reg._entries.items()}
    np.testing.assert_allclose(out_a, _jax_forward(ja, x), **TOL)
    np.testing.assert_allclose(out_b, _jax_forward(jb, x), **TOL)
    assert sizes["a"] == sizes["b"] == (3 * 4 + 3) * 4
    budget = sizes["gpt"] + sizes["a"] + sizes["b"] // 2

    reg = serving.ModelRegistry(budget_bytes=budget, artifact_dir=d,
                                name="lru")
    try:
        _register_three(reg, ja, jb, gpts["ja"])
        np.testing.assert_array_equal(reg.predict("a", x), out_a)
        assert reg.generate("gpt", prompt, max_new_tokens=4) \
            == gpts["want_a"]
        assert sorted(reg.resident_models()) == ["a", "gpt"]
        assert reg.resident_bytes() <= budget
        np.testing.assert_array_equal(reg.predict("b", x), out_b)
        assert sorted(reg.resident_models()) == ["b", "gpt"]
        assert reg.metrics.evictions == 1
        assert reg.resident_bytes() <= budget
        np.testing.assert_array_equal(reg.predict("a", x), out_a)
        srv_a = reg.server("a")
        assert srv_a.metrics.compiles == 0
        assert srv_a.metrics.artifact_hits == 2
        assert reg.metrics.admissions >= 4
        assert reg.metrics.snapshot()["per_model"]["a"]["admissions"] == 2
        assert set(reg.metrics.snapshot()) \
            == set(jserving.RegistryMetrics("keys").snapshot())
        h = reg.healthz()
        assert h["ready"] and h["budget_bytes"] == budget
        # a's re-admission evicted gpt, now the least recently used
        assert sorted(reg.resident_models()) == ["a", "b"]
        assert h["models"]["a"]["resident"] and not \
            h["models"]["gpt"]["resident"]
        assert set(reg.stats()["models"]) == {"a", "b", "gpt"}
    finally:
        reg.close()
    assert reg.resident_models() == []


def test_registry_never_evicts_in_flight_model(tmp_path, gpts):
    """Every resident model in flight and no room: admission raises
    ``QueueFullError(retry_after)`` instead of evicting under a live
    request; the in-flight model finishes untouched; then the eviction
    goes through."""
    gate = threading.Event()
    reg = serving.ModelRegistry(max_resident=1,
                                artifact_dir=str(tmp_path / "art"),
                                name="inflight")
    try:
        _register_three(reg, _jax_dense(0), _jax_dense(1), gpts["ja"], gate)
        h = reg.submit("gpt", gpts["prompt"], max_new_tokens=6)
        next(iter(h))             # the prefill's token; the steps wait
        with pytest.raises(serving.QueueFullError) as ei:
            reg.predict("a", np.zeros(4, np.float32), timeout=5)
        assert ei.value.retry_after > 0
        assert reg.resident_models() == ["gpt"]
        assert not reg.evict("gpt")
        gate.set()
        assert len(h.result(60)) == 6
        reg.predict("a", np.zeros(4, np.float32))
        assert reg.resident_models() == ["a"]
    finally:
        gate.set()
        reg.close()


def test_registry_slo_admission_control(tmp_path):
    """A request whose estimated wait already exceeds the model's deadline
    is rejected at the front door and counted."""
    gate = threading.Event()

    def slow_build(ad):
        srv = serving.ModelServer(_port_dense(_jax_dense(0)), buckets=(1,),
                                  max_wait_ms=0.1, max_queue=64, ctx=CPU,
                                  artifact_dir=ad, name="slow")
        srv.warmup((4,), "float32")
        inner = srv._batcher._runner

        def blocked(batch):
            gate.wait(10)
            return inner(batch)

        srv._batcher._runner = blocked
        return srv

    reg = serving.ModelRegistry(artifact_dir=str(tmp_path / "a"), name="slo")
    try:
        reg.register("slow", slow_build, deadline_ms=1.0)
        x = np.zeros(4, np.float32)
        rejected = None
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and rejected is None:
            try:
                reg.submit("slow", x)
            except serving.DeadlineExceededError as e:
                rejected = e
            except serving.QueueFullError:
                break
            time.sleep(0.005)
        assert rejected is not None and rejected.retry_after > 0
        assert reg.metrics.slo_rejections >= 1
        assert reg.metrics.per_model["slow"]["slo_rejections"] >= 1
    finally:
        gate.set()
        reg.close()


def test_registry_publish_weights_resident_and_deferred(tmp_path):
    ja, jb = _jax_dense(0), _jax_dense(5)
    x = np.random.RandomState(1).rand(4).astype(np.float32)
    reg = serving.ModelRegistry(artifact_dir=str(tmp_path / "a"), name="pub")
    try:
        reg.register("m", lambda ad: serving.ModelServer(
            _port_dense(ja), buckets=(1,), ctx=CPU, artifact_dir=ad,
            name="m"), warmup=lambda s: s.warmup((4,), "float32"))
        res = reg.publish_weights("m", _weights(jb), version=3)
        assert res == {"deferred": True, "version": 3}
        np.testing.assert_allclose(reg.predict("m", x), _jax_forward(jb, x),
                                   **TOL)
        assert reg.server("m").weights_version == 3
        stats = reg.publish_weights("m", _weights(ja), version=4)
        assert stats["version"] == 4 and not stats.get("deferred")
        np.testing.assert_allclose(reg.predict("m", x), _jax_forward(ja, x),
                                   **TOL)
        assert reg.metrics.swaps >= 2
    finally:
        reg.close()


def test_published_version_survives_eviction(tmp_path):
    """Weights published to a resident model survive its eviction: the
    re-admission applies the latest publish again, never reverting to the
    builder's weights."""
    ja, jb, jc = _jax_dense(0), _jax_dense(6), _jax_dense(7)
    x = np.random.RandomState(2).rand(4).astype(np.float32)
    reg = serving.ModelRegistry(max_resident=1,
                                artifact_dir=str(tmp_path / "a"),
                                name="surv")
    try:
        reg.register("m", lambda ad: serving.ModelServer(
            _port_dense(ja), buckets=(1,), ctx=CPU, artifact_dir=ad,
            name="m"), warmup=lambda s: s.warmup((4,), "float32"))
        reg.register("other", lambda ad: serving.ModelServer(
            _port_dense(jc), buckets=(1,), ctx=CPU, artifact_dir=ad,
            name="other"), warmup=lambda s: s.warmup((4,), "float32"))
        reg.predict("m", x)
        stats = reg.publish_weights("m", _weights(jb), version=2)
        assert not stats.get("deferred")
        reg.predict("other", x)
        assert reg.resident_models() == ["other"]
        np.testing.assert_allclose(reg.predict("m", x), _jax_forward(jb, x),
                                   **TOL)
        assert reg.server("m").weights_version == 2
    finally:
        reg.close()


def test_lone_over_budget_model_still_serves(tmp_path):
    reg = serving.ModelRegistry(budget_bytes=1,
                                artifact_dir=str(tmp_path / "a"),
                                name="tiny")
    try:
        reg.register("m", lambda ad: serving.ModelServer(
            _port_dense(_jax_dense(0)), buckets=(1,), ctx=CPU,
            artifact_dir=ad, name="m"),
            warmup=lambda s: s.warmup((4,), "float32"))
        out = reg.predict("m", np.zeros(4, np.float32))
        assert out.shape == (3,) and reg.resident_models() == ["m"]
    finally:
        reg.close()


def test_eviction_drops_the_executables_and_the_kv_cache(tmp_path, gpts):
    reg = serving.ModelRegistry(artifact_dir="", name="drop")
    try:
        _register_three(reg, _jax_dense(0), _jax_dense(1), gpts["ja"])
        reg.predict("a", np.zeros(4, np.float32))
        reg.generate("gpt", gpts["prompt"], max_new_tokens=2)
        srv, sess = reg.server("a"), reg.server("gpt")
        assert srv.compiled_signatures() and sess._kv.k is not None
        assert reg.evict("a") and reg.evict("gpt")
        assert srv.compiled_signatures() == [] and sess._kv.k is None
        assert reg.resident_models() == [] and reg.resident_bytes() == 0
        with pytest.raises(KeyError, match="not registered"):
            reg.predict("nope", np.zeros(4, np.float32))
        with pytest.raises(ValueError, match="already registered"):
            reg.register("a", lambda ad: None)
    finally:
        reg.close()


def test_registry_knobs_registered_with_the_reference_defaults():
    for knob in ("MXTPU_SERVING_ARTIFACT_DIR", "MXTPU_REGISTRY_BUDGET_MB",
                 "MXTPU_REGISTRY_MAX_RESIDENT"):
        assert knob in config._knobs, knob
        assert config._knobs[knob].default == jconfig._knobs[knob].default
    config.set("MXTPU_REGISTRY_BUDGET_MB", 2.0)
    config.set("MXTPU_REGISTRY_MAX_RESIDENT", 3)
    reg = serving.ModelRegistry()
    try:
        assert (reg.budget_bytes, reg.max_resident) == (2 << 20, 3)
        assert reg.artifact_dir is None
    finally:
        reg.close()


# ---------------------------------------------------------------------------
# the artifact store
# ---------------------------------------------------------------------------
def _cache(d, name="model", **kw):
    return serving.BucketedExecutorCache.from_block(
        _port_dense(_jax_dense(0)), ctx=CPU, artifact_dir=d, name=name, **kw)


def test_artifact_roundtrip_bit_identical(tmp_path):
    d = str(tmp_path / "art")
    c1 = _cache(d, buckets=(2, 4))
    c1.warmup((4,), "float32")
    assert (c1.metrics.artifact_misses, c1.metrics.artifact_hits) == (2, 0)
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    out1 = c1(x)
    c2 = _cache(d, buckets=(2, 4))
    c2.warmup((4,), "float32")
    for n in (1, 2, 3, 4, 3, 1):
        np.testing.assert_array_equal(c2(x[:n]), out1[:n])
    m = c2.metrics
    assert (m.compiles, m.captures, m.artifact_hits) == (0, 0, 2)
    assert m.deserialize_seconds > 0.0
    snap = m.snapshot()["executor_cache"]
    assert snap["artifact_hits"] == 2 and snap["artifact_misses"] == 0


@pytest.mark.parametrize("field", ["torch", "cuda", "device_kind", "kernels",
                                   "fingerprint"])
def test_stale_fingerprint_refused_falls_back_and_repersists(tmp_path,
                                                             field):
    d = str(tmp_path / "art")
    c1 = _cache(d, buckets=(2,))
    c1.warmup((4,), "float32")
    path = ArtifactStore(d).path_for(c1.name, {
        "component": "bucket", "bucket": 2, "features": (4,),
        "dtype": "float32"})
    with open(path, "rb") as f:
        rec = pickle.load(f)
    assert field in rec["guard"]
    rec["guard"][field] = "something-else"
    with open(path, "wb") as f:
        pickle.dump(rec, f)
    c2 = _cache(d, buckets=(2,))
    c2.warmup((4,), "float32")
    assert (c2.metrics.artifact_refused, c2.metrics.artifact_hits) == (1, 0)
    c3 = _cache(d, buckets=(2,))
    c3.warmup((4,), "float32")
    assert c3.metrics.artifact_hits == 1


def test_corrupt_artifact_falls_back(tmp_path):
    d = str(tmp_path / "art")
    c1 = _cache(d, buckets=(2,))
    c1.warmup((4,), "float32")
    path = ArtifactStore(d).path_for(c1.name, {
        "component": "bucket", "bucket": 2, "features": (4,),
        "dtype": "float32"})
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    c2 = _cache(d, buckets=(2,))
    c2.warmup((4,), "float32")
    m = c2.metrics
    assert (m.artifact_hits, m.artifact_misses, m.artifact_refused) \
        == (0, 1, 0)
    x = np.ones((2, 4), np.float32)
    np.testing.assert_array_equal(c2(x), c1(x))


def test_load_artifacts_eager_scan_needs_no_signature(tmp_path):
    d = str(tmp_path / "art")
    _cache(d, buckets=(2, 4)).warmup((4,), "float32")
    c2 = _cache("", buckets=(2, 4))
    with pytest.raises(RuntimeError, match="no artifact store"):
        c2.load_artifacts()
    assert c2.load_artifacts(d) == 2
    assert c2.compiled_signatures() == [(2, (4,), "float32"),
                                        (4, (4,), "float32")]
    assert c2.metrics.artifact_hits == 2 and c2.metrics.compiles == 0
    assert c2.save_artifacts(str(tmp_path / "again")) == 2


def test_artifact_dir_knob_engages_store(tmp_path):
    config.set("MXTPU_SERVING_ARTIFACT_DIR", str(tmp_path / "knob"))
    _cache(None, buckets=(2,)).warmup((4,), "float32")
    c2 = _cache(None, buckets=(2,))
    c2.warmup((4,), "float32")
    assert c2.metrics.artifact_hits == 1


def test_decode_session_artifacts_and_guard_of_the_cache_shape(tmp_path,
                                                               gpts):
    """The prefill buckets and the decode step store their artifacts and
    warm back from them with the JAX oracle's stream; a session with
    another slot count refuses the decode step's (``kv_shape`` rides the
    guard)."""
    d = str(tmp_path / "art")
    s1 = _session(_port_gpt(gpts["ja"]), artifact_dir=d)
    try:
        s1.warmup()
        assert s1.engine_metrics.artifact_misses == 1
        assert s1._prefill_cache.metrics.artifact_misses == 1
        assert s1.save_artifacts() == 2
    finally:
        s1.close()
    s2 = _session(_port_gpt(gpts["ja"]), artifact_dir=d)
    try:
        s2.warmup()
        assert s2.engine_metrics.artifact_hits == 1
        assert s2._prefill_cache.metrics.artifact_hits == 1
        assert s2.generate(gpts["prompt"], max_new_tokens=4) \
            == gpts["want_a"]
    finally:
        s2.close()
    s3 = serving.DecodeSession(_port_gpt(gpts["ja"]), ctx=CPU, max_slots=4,
                               max_len=32, prefill_buckets=(8,), name="hs",
                               artifact_dir=d)
    try:
        s3.warmup()
        assert s3.engine_metrics.artifact_refused == 1
    finally:
        s3.close()


def test_kernel_payload_installs_into_an_empty_build_dir(tmp_path,
                                                         monkeypatch):
    """The payload is the kernel libraries as bytes: stored from one build
    directory, installed into another under this checkout's names; a
    library of another build of the source is refused."""
    built = tmp_path / "built"
    monkeypatch.setenv("MXTPU_KERNEL_BUILD_DIR", str(built))
    lib = _build.lib_path("fused_conv_f32")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"\x7fELF a library")
    payload = artifacts.kernel_payload(["fused_conv_f32", "flash_fwd"])
    assert payload == {"fused_conv_f32": (lib.name, b"\x7fELF a library")}
    store = ArtifactStore(str(tmp_path / "art"))
    guard = artifacts.environment_fingerprint()
    store.save("m", {"component": "bucket"}, guard, payload)
    monkeypatch.setenv("MXTPU_KERNEL_BUILD_DIR", str(tmp_path / "empty"))
    got, reason = store.load("m", {"component": "bucket"}, guard)
    assert reason == "ok" and got == payload
    assert _build.lib_path("fused_conv_f32").read_bytes() \
        == b"\x7fELF a library"
    with pytest.raises(ValueError, match="not this checkout's build"):
        artifacts.install_payload(
            {"fused_conv_f32": ("libfused_conv_f32-0.so", b"")})
    assert store.load("m", {"component": "other"}, guard) == (None, "absent")
    assert artifacts.serialization_supported()
    assert os.path.basename(store.path_for("a/b", {})).endswith(".mxart")
