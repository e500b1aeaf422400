"""Port parity: the batch-serving tier (``serving.DynamicBatcher``,
``BucketedExecutorCache``, ``ModelServer``, ``ServingMetrics``) and
``Block.save_parameters``/``load_parameters``.

The batcher, cache and server cases of the JAX package's
``tests/test_serving.py``, ported to the port's entry points on the CPU
(where an executable is the eager apply and nothing is captured); a Dense
net with the same weights served by both packages (every row within
1e-6); the miniature fused ResNet served by the port (each row within 1e-5
of its eager eval forward); checkpoints written by either package loaded
by the port. The card's cases (one CUDA graph a bucket, its replay
bit-equal to the eager forward, the kernel launches a replay counts) are
in ``tests/test_torch_graph_capture.py``, which imports no JAX.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serving as jserving

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import FusedResNetV1
from incubator_mxnet_tpu_torch.serving import (BucketedExecutorCache,
                                               DynamicBatcher, ModelServer,
                                               QueueFullError,
                                               ServerClosedError,
                                               ServingMetrics)

CPU = mx.cpu()


def _dense(out=3, inp=4, seed=0, ctx=CPU):
    mx.random.seed(seed)
    return mx.gluon.nn.Dense(out, in_units=inp).initialize("xavier", ctx=ctx)


def _eager(net, x):
    with torch.no_grad():
        return net(torch.as_tensor(x)).numpy()


# ---------------------------------------------------------------------------
# executor cache
# ---------------------------------------------------------------------------
def test_bucket_selection():
    cache = BucketedExecutorCache.from_block(_dense(), buckets=(4, 1, 8, 2),
                                             ctx=CPU)
    assert cache.buckets == (1, 2, 4, 8)       # sorted, deduped
    assert [cache.bucket_for(n) for n in (1, 2, 3, 8)] == [1, 2, 4, 8]
    with pytest.raises(ValueError):
        cache.bucket_for(9)                     # above the largest bucket
    with pytest.raises(ValueError):
        cache.bucket_for(0)
    with pytest.raises(ValueError):
        BucketedExecutorCache.from_block(_dense(), buckets=(), ctx=CPU)
    assert serving.DEFAULT_BUCKETS == (1, 2, 4, 8, 16, 32)


def test_cache_pad_depad_one_executable_per_bucket_no_capture_on_cpu():
    net = _dense()
    cache = BucketedExecutorCache.from_block(net, buckets=(2, 4), ctx=CPU)
    rs = np.random.RandomState(0)
    for n in (1, 2, 3, 4, 3, 2, 1):             # ragged repeat traffic
        x = rs.rand(n, 4).astype(np.float32)
        out = cache(x)
        assert out.shape == (n, 3)              # de-padded to true size
        np.testing.assert_allclose(out, _eager(net, x), rtol=1e-5,
                                   atol=1e-6)
    m = cache.metrics
    assert (m.cache_misses, m.cache_hits) == (2, 5)
    assert m.compiles == 0                      # the CPU captures nothing
    assert cache.compiled_signatures() == [(2, (4,), "float32"),
                                           (4, (4,), "float32")]
    assert cache.param_bytes() == (3 * 4 + 3) * 4


def test_cache_refuses_parameters_on_another_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: gpu(0) resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketedExecutorCache.from_block(_dense())     # default gpu(0)


class _TwoHead(mx.gluon.Block):
    def __init__(self):
        super().__init__()
        self.fc = mx.gluon.nn.Dense(3, in_units=4)

    def forward(self, x):
        h = self.fc(x)
        return h, h.sum(dim=1)


def test_cache_multi_output_block():
    net = _TwoHead().initialize(ctx=CPU)
    cache = BucketedExecutorCache.from_block(net, buckets=(4,), ctx=CPU)
    x = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    h, s = cache(x)
    assert h.shape == (3, 3) and s.shape == (3,)
    np.testing.assert_allclose(s, h.sum(axis=1), rtol=1e-5, atol=1e-6)


def test_pure_method_runner_is_inference_mode():
    """Dropout off, BatchNorm on its running statistics (left as they
    were), no autograd graph, whatever mode the caller is in."""
    net = mx.gluon.nn.Sequential()
    net.add(mx.gluon.nn.Dense(6, in_units=4), mx.gluon.nn.Dropout(0.5),
            mx.gluon.nn.BatchNorm(in_channels=6))
    net.initialize(ctx=CPU)
    run, params = serving.pure_method_runner(net)
    assert len(params) == len(list(net.parameters()))
    x = torch.from_numpy(np.random.RandomState(2).rand(5, 4)
                         .astype(np.float32))
    stats = [p.clone() for p in params if not p.requires_grad]
    with mx.autograd.record():
        (a,) = run(net, x)
        (b,) = run(net, x)
    assert not a.requires_grad and torch.equal(a, b)
    assert all(torch.equal(s, p) for s, p in
               zip(stats, [p for p in params if not p.requires_grad]))
    with mx.autograd.pause():
        np.testing.assert_array_equal(a.numpy(), net(x).numpy())


# ---------------------------------------------------------------------------
# dynamic batcher
# ---------------------------------------------------------------------------
def test_flush_on_full_does_not_wait():
    """A full batch flushes at once even under a huge max_wait."""
    batcher = DynamicBatcher(lambda b: b * 2.0, max_batch_size=4,
                             max_wait_ms=30_000.0, max_queue=16)
    try:
        t0 = time.monotonic()
        futs = [batcher.submit(np.full((2,), i, np.float32))
                for i in range(4)]
        rows = [f.result(timeout=10) for f in futs]
        assert time.monotonic() - t0 < 10      # nowhere near 30 s
        for i, r in enumerate(rows):
            np.testing.assert_allclose(r, np.full((2,), 2.0 * i))
        assert batcher.metrics.batches == 1    # one full batch, no splits
        assert batcher.metrics.mean_batch_occupancy() == 4.0
    finally:
        batcher.close()


def test_flush_on_timeout_serves_partial_batch():
    batcher = DynamicBatcher(lambda b: b + 1.0, max_batch_size=8,
                             max_wait_ms=30.0, max_queue=16)
    try:
        fut = batcher.submit(np.zeros((2,), np.float32))
        np.testing.assert_allclose(fut.result(timeout=10), np.ones((2,)))
        assert batcher.metrics.batches == 1
        assert batcher.metrics.mean_batch_occupancy() == 1.0
    finally:
        batcher.close()


def _blocked_batcher(release, **kwargs):
    def runner(batch):
        release.wait(timeout=30)
        return batch * 1.0

    return DynamicBatcher(runner, **kwargs)


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached in time")
        time.sleep(0.005)


def test_backpressure_rejects_with_retry_after():
    release = threading.Event()
    batcher = _blocked_batcher(release, max_batch_size=2, max_wait_ms=1.0,
                               max_queue=3)
    try:
        first = batcher.submit(np.zeros(2, np.float32))
        _wait_until(lambda: batcher.queue_depth == 0)   # worker holds it
        queued = [batcher.submit(np.zeros(2, np.float32))
                  for _ in range(3)]                    # queue now full
        with pytest.raises(QueueFullError) as ei:
            batcher.submit(np.zeros(2, np.float32))
        assert ei.value.retry_after > 0
        assert batcher.metrics.rejected == 1
        release.set()
        for f in [first] + queued:
            f.result(timeout=10)
    finally:
        release.set()
        batcher.close()


def test_graceful_drain_answers_queued_then_refuses():
    release = threading.Event()
    batcher = _blocked_batcher(release, max_batch_size=2, max_wait_ms=1.0,
                               max_queue=16)
    try:
        futs = [batcher.submit(np.full(2, i, np.float32)) for i in range(5)]
        release.set()
        assert batcher.drain(timeout=15)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(0), np.full(2, float(i)))
        with pytest.raises(ServerClosedError):
            batcher.submit(np.zeros(2, np.float32))
    finally:
        release.set()
        batcher.close()


def test_close_fails_queued_requests():
    release = threading.Event()
    batcher = _blocked_batcher(release, max_batch_size=1, max_wait_ms=1.0,
                               max_queue=16)
    first = batcher.submit(np.zeros(2, np.float32))
    _wait_until(lambda: batcher.queue_depth == 0)
    queued = batcher.submit(np.ones(2, np.float32))
    # release after close has failed the queue, while close joins the
    # worker, so the worker cannot serve `queued` first
    threading.Timer(0.2, release.set).start()
    batcher.close()
    first.result(timeout=10)                   # in-flight batch still lands
    with pytest.raises(ServerClosedError):
        queued.result(timeout=10)


def test_submit_signature_mismatch_rejected_up_front():
    batcher = DynamicBatcher(lambda b: b, max_batch_size=4, max_queue=8)
    try:
        batcher.expect_features((4,), "float32")
        with pytest.raises(ValueError):
            batcher.submit(np.zeros((5,), np.float32))   # wrong shape
        with pytest.raises(ValueError):
            batcher.submit(np.zeros((4,), np.float64))   # wrong dtype
        np.testing.assert_allclose(
            batcher.submit(np.arange(4, dtype=np.float32)).result(10),
            np.arange(4.0))
    finally:
        batcher.close()


def test_bad_runner_output_fails_caller_not_worker():
    calls = {"n": 0}

    def runner(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            return np.zeros((0, 2), np.float32)   # no rows for the batch
        return batch

    batcher = DynamicBatcher(runner, max_batch_size=1, max_wait_ms=1.0)
    try:
        with pytest.raises(IndexError):
            batcher.submit(np.zeros(2, np.float32)).result(timeout=10)
        np.testing.assert_allclose(                # worker still alive
            batcher.submit(np.ones(2, np.float32)).result(timeout=10),
            np.ones(2))
    finally:
        batcher.close()


def test_runner_failure_propagates_to_futures_and_worker_survives():
    calls = {"n": 0}

    def runner(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return batch

    batcher = DynamicBatcher(runner, max_batch_size=2, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.submit(np.zeros(2, np.float32)).result(timeout=10)
        np.testing.assert_allclose(
            batcher.submit(np.ones(2, np.float32)).result(timeout=10),
            np.ones(2))
    finally:
        batcher.close()


def test_deadline_sheds_aged_requests_with_retry_after():
    gate = threading.Event()

    def slow_runner(batch):
        gate.wait(0.4)                 # one slow in-flight batch
        return batch

    b = DynamicBatcher(slow_runner, max_batch_size=1, max_wait_ms=1.0,
                       max_queue=16, deadline_ms=50.0, name="shed")
    try:
        futs = [b.submit(np.ones(3, np.float32)) for _ in range(6)]
        served = shed = 0
        for f in futs:
            try:
                f.result(timeout=15)
                served += 1
            except serving.DeadlineExceededError as e:
                shed += 1
                assert e.retry_after >= 0.0
        assert served >= 1 and shed >= 1
        assert b.metrics.shed == shed
        gate.set()                     # fresh traffic is still served
        assert b.submit(np.ones(3, np.float32)).result(timeout=10) \
            .shape == (3,)
    finally:
        b.close()


def test_no_deadline_means_no_shedding():
    b = DynamicBatcher(lambda x: x, max_batch_size=4, max_wait_ms=1.0)
    try:
        assert b.deadline_ms is None
        for f in [b.submit(np.ones(2, np.float32)) for _ in range(4)]:
            f.result(timeout=10)
        assert b.metrics.shed == 0
    finally:
        b.close()


def test_batcher_estimated_wait_tracks_backlog():
    gate = threading.Event()

    def runner(batch):
        gate.wait(10)
        return batch * 2

    b = DynamicBatcher(runner, max_batch_size=2, max_wait_ms=1.0,
                       max_queue=64, name="wait")
    try:
        assert b.estimated_wait_s() == 0.0
        fut = b.submit(np.zeros(2, np.float32))
        gate.set()
        fut.result(10)                     # learn the service time
        gate.clear()
        for _ in range(9):                 # a batch of 2 in flight
            b.submit(np.zeros(2, np.float32))
        _wait_until(lambda: b.queue_depth == 7)
        assert b.estimated_wait_s() > 0.0
    finally:
        gate.set()
        b.close()


# ---------------------------------------------------------------------------
# ModelServer
# ---------------------------------------------------------------------------
def test_server_rejects_config_for_prebuilt_cache():
    cache = BucketedExecutorCache.from_block(_dense(), buckets=(1, 2),
                                             ctx=CPU)
    with pytest.raises(ValueError):
        ModelServer(cache, buckets=(4, 8))
    with pytest.raises(ValueError):
        ModelServer(cache, ctx=CPU)
    ModelServer(cache).close()               # no overrides: fine


def test_drain_timeout_force_closes_wedged_batch():
    stuck = threading.Event()
    srv = ModelServer(_dense(), buckets=(1,), max_wait_ms=1.0,
                      name="wedged", ctx=CPU)
    real_runner = srv._batcher._runner
    srv._batcher._runner = lambda batch: (stuck.wait(),
                                          real_runner(batch))[1]
    try:
        srv.submit(np.ones(4, np.float32))
        time.sleep(0.05)               # let the worker pick it up
        t0 = time.time()
        assert srv.drain(timeout=0.5) is False
        assert time.time() - t0 < 5.0  # no 5 s worker-join tail
        assert srv.metrics.forced_closes == 1
        with pytest.raises(ServerClosedError):
            srv.submit(np.ones(4, np.float32))
    finally:
        stuck.set()
        srv.close()


def test_healthz_flips_during_drain_and_maintenance():
    srv = ModelServer(_dense(), buckets=(1, 2), max_wait_ms=1.0,
                      name="probe", ctx=CPU)
    try:
        hz = srv.healthz()
        assert hz["ready"] is True and hz["state"] == "running"
        with srv.maintenance():
            hz = srv.healthz()
            assert hz["ready"] is False and hz["maintenance"] is True
            assert srv.predict(np.ones(4, np.float32)).shape == (3,)
        assert srv.healthz()["ready"] is True
        srv.drain(timeout=10.0)
        hz = srv.healthz()
        assert hz["ready"] is False and hz["state"] != "running"
    finally:
        srv.close()


def test_server_deadline_param_reaches_batcher():
    srv = ModelServer(_dense(), buckets=(1,), deadline_ms=125.0, name="dl",
                      ctx=CPU)
    srv.close()
    assert srv._batcher.deadline_ms == 125.0
    config.set("MXTPU_SERVING_DEADLINE_MS", 80.0)
    try:
        srv2 = ModelServer(_dense(), buckets=(1,), name="dl2", ctx=CPU)
        srv2.close()
        assert srv2._batcher.deadline_ms == 80.0
    finally:
        config.unset("MXTPU_SERVING_DEADLINE_MS")


def test_server_concurrent_clients_match_unbatched():
    net = _dense()
    srv = ModelServer(net, buckets=(1, 2, 4, 8), max_wait_ms=20.0,
                      max_queue=256, ctx=CPU)
    try:
        srv.warmup((4,), "float32")
        xs = np.random.RandomState(2).rand(48, 4).astype(np.float32)
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = list(pool.map(srv.submit, xs))
        got = np.stack([f.result(timeout=30) for f in futs])
        np.testing.assert_allclose(got, _eager(net, xs), rtol=1e-5,
                                   atol=1e-6)
        stats = srv.stats()
        assert stats["requests"] == 48
        assert stats["batch_occupancy"] > 1.0
        cache = stats["executor_cache"]
        assert (cache["misses"], cache["compiles"]) == (4, 0)
        assert cache["hits"] == stats["batches"]
        assert stats["latency_ms"]["p99"] >= stats["latency_ms"]["p50"] > 0
        assert srv.resident_bytes() == (3 * 4 + 3) * 4
    finally:
        srv.close()


def test_server_context_manager_drains():
    with ModelServer(_dense(), buckets=(1, 2), max_wait_ms=5.0,
                     ctx=CPU) as srv:
        fut = srv.submit(np.zeros(4, np.float32))
    assert fut.result(timeout=0).shape == (3,)   # drained on exit
    with pytest.raises(ServerClosedError):
        srv.submit(np.zeros(4, np.float32))


def test_server_max_batch_size_capped_by_buckets():
    with pytest.raises(ValueError):
        ModelServer(_dense(), buckets=(1, 2), max_batch_size=4, ctx=CPU)


def test_unported_loaders_name_their_roadmap_item(tmp_path):
    # from_exported is ported (item 6): without its files it raises the
    # missing file's error
    with pytest.raises(FileNotFoundError, match="serving.json"):
        ModelServer.from_exported(str(tmp_path / "net"))
    with pytest.raises(NotImplementedError, match="item 10"):
        serving.load_block_checkpoint(_dense(),
                                      str(tmp_path / "c.manifest.json"))
    with pytest.raises(NotImplementedError, match="item 12"):
        serving.load_block_checkpoint(_dense(), str(tmp_path / "c.params"),
                                      use_native=True)


def test_metrics_percentiles_and_snapshot():
    m = ServingMetrics("m", window=100)
    for v in range(1, 101):                    # 1..100 ms
        m.observe_latency(v / 1e3)
    assert m.latency_ms(50) == pytest.approx(50)
    assert m.latency_ms(99) == pytest.approx(99)
    two = ServingMetrics("two")
    two.observe_latency(0.001)
    two.observe_latency(0.002)
    assert two.latency_ms(50) == pytest.approx(1.0)   # not the upper rank
    m.observe_batch(4)
    m.observe_batch(2)
    snap = m.snapshot()
    assert snap["batch_occupancy"] == 3.0
    assert snap["requests"] == 100
    assert ServingMetrics("empty").snapshot()["latency_ms"]["p50"] == 0.0
    # the reference's keys, the artifact ones at 0; the cache's also counts
    # the CUDA-graph captures apart from its kernel builds ("compiles")
    want = jserving.ServingMetrics("keys").snapshot()
    assert set(snap) == set(want)
    assert set(snap["executor_cache"]) == set(want["executor_cache"]) | {
        "captures", "capture_seconds"}
    assert snap["executor_cache"]["artifact_hits"] == 0


# ---------------------------------------------------------------------------
# against the JAX package's ModelServer, and a fused ResNet served
# ---------------------------------------------------------------------------
def test_dense_served_by_both_packages_agrees(tmp_path):
    """A Dense net with the same weights (the JAX package's
    ``save_parameters`` file, loaded by the port's ``from_checkpoint``)
    through both servers: every row within 1e-6."""
    jmx.random.seed(3)
    jnet = jmx.gluon.nn.Dense(5, in_units=7)
    jnet.initialize(jmx.initializer.Xavier(rnd_type="gaussian"))
    path = str(tmp_path / "dense.params")
    jnet.save_parameters(path)
    xs = np.random.RandomState(4).rand(13, 7).astype(np.float32)
    jsrv = jserving.ModelServer(jnet, buckets=(1, 2, 4, 8), max_wait_ms=5.0)
    try:
        jsrv.warmup((7,), "float32")
        want = np.stack([f.result(60) for f in
                         [jsrv.submit(x) for x in xs]])
    finally:
        jsrv.close()
    srv = ModelServer.from_checkpoint(mx.gluon.nn.Dense(5, in_units=7),
                                      path, ctx=CPU, buckets=(1, 2, 4, 8),
                                      max_wait_ms=5.0)
    try:
        srv.warmup((7,), "float32")
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = list(pool.map(srv.submit, xs))
        got = np.stack([f.result(60) for f in futs])
    finally:
        srv.close()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


LAYERS, CHANNELS, CLASSES, HW = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10, 64


def _fused_net(ctx=CPU):
    """The miniature fused ResNet, its running statistics set by one
    training-mode forward (so eval reads statistics that are not the
    initial 0 and 1)."""
    mx.random.seed(5)
    net = FusedResNetV1(LAYERS, CHANNELS, classes=CLASSES).initialize(
        "xavier", ctx=ctx)
    x = torch.rand((4, 3, HW, HW), generator=torch.Generator().manual_seed(6))
    with torch.no_grad(), mx.autograd.train_mode():
        net(x.to(net.device))
    return net


def test_fused_resnet_served_rows_match_its_eager_eval_forward():
    net = _fused_net()
    xs = np.random.RandomState(7).rand(7, 3, HW, HW).astype(np.float32)
    with ModelServer(net, buckets=(1, 2, 4), max_wait_ms=20.0,
                     ctx=CPU) as srv:
        srv.warmup((3, HW, HW), "float32")
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = list(pool.map(srv.submit, xs))
        got = np.stack([f.result(120) for f in futs])
        stats = srv.stats()
    with mx.autograd.pause():
        for x, row in zip(xs, got):
            want = net(torch.from_numpy(x[None])).numpy()[0]
            err = np.linalg.norm(row - want) / np.linalg.norm(want)
            assert err <= 1e-5, err
    assert stats["requests"] == len(xs) and got.shape == (len(xs), CLASSES)
    assert [k[0] for k in srv.compiled_signatures()] == [1, 2, 4]


# ---------------------------------------------------------------------------
# save_parameters / load_parameters / from_checkpoint
# ---------------------------------------------------------------------------
def test_save_load_parameters_round_trip(tmp_path):
    net = _fused_net()
    path = str(tmp_path / "fused.params")
    net.save_parameters(path)
    fresh = FusedResNetV1(LAYERS, CHANNELS, classes=CLASSES)
    fresh.load_parameters(path, ctx=CPU)
    got = dict(fresh.named_parameters())
    for n, p in net.named_parameters():
        assert torch.equal(got[n], p), n
        assert got[n].requires_grad == p.requires_grad
    # an initialized block is written in place: the same tensor objects
    drawn = _dense(seed=8)
    before = {n: p for n, p in drawn.named_parameters()}
    _dense(seed=9).save_parameters(path)
    drawn.load_parameters(path)
    for n, p in drawn.named_parameters():
        assert p is before[n]
        assert torch.equal(p, dict(_dense(seed=9).named_parameters())[n])


def test_load_parameters_checks_names_and_shapes(tmp_path):
    path = str(tmp_path / "d.params")
    _dense(out=3).save_parameters(path)
    with pytest.raises(ValueError, match="shape"):
        _dense(out=4).load_parameters(path)
    with pytest.raises(KeyError, match="missing"):
        _TwoHead().load_parameters(path, ctx=CPU)
    net = _TwoHead()
    net.load_parameters(path, ctx=CPU, allow_missing=True,
                        ignore_extra=True)
    with pytest.raises(KeyError, match="extra"):
        mx.gluon.nn.Dense(3, in_units=4).initialize(ctx=CPU) \
            .load_parameters(_save_extra(tmp_path))


def _save_extra(tmp_path):
    path = str(tmp_path / "extra.params")
    with mx.cpu():
        mx.nd.save(path, {"weight": mx.nd.zeros((3, 4)),
                          "bias": mx.nd.zeros((3,)),
                          "other": mx.nd.zeros((1,))})
    return path


def test_port_checkpoint_loads_in_the_jax_package_and_back(tmp_path):
    """The port's file loads into the JAX package's Dense (the same
    container and names), and the JAX package's into the port's, which
    then serves it through ``from_checkpoint``."""
    net = _dense(out=5, inp=7, seed=10)
    path = str(tmp_path / "port.params")
    net.save_parameters(path)
    jnet = jmx.gluon.nn.Dense(5, in_units=7)
    jnet.initialize()
    jnet.load_parameters(path)
    x = np.random.RandomState(11).rand(3, 7).astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(_eager(net, x), want, rtol=1e-6, atol=1e-6)
    jpath = str(tmp_path / "jax.params")
    jnet.save_parameters(jpath)
    with ModelServer.from_checkpoint(mx.gluon.nn.Dense(5, in_units=7), jpath,
                                     ctx=CPU, buckets=(4,)) as srv:
        got = np.stack([srv.predict(r) for r in x])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decode_session_from_checkpoint(tmp_path):
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    def gpt():
        return get_gpt("gpt_decoder_tiny", vocab_size=23, units=32,
                       num_layers=1, max_length=32, dropout=0.0)

    mx.random.seed(12)
    net = gpt().initialize("xavier", ctx=CPU)
    path = str(tmp_path / "gpt.params")
    net.save_parameters(path)
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    with serving.DecodeSession(net, ctx=CPU, max_slots=2, max_len=32,
                               prefill_buckets=(8,)) as sess:
        want = sess.generate(prompt, max_new_tokens=6)
    with serving.DecodeSession.from_checkpoint(
            gpt(), path, ctx=CPU, max_slots=2, max_len=32,
            prefill_buckets=(8,)) as sess:
        assert sess.generate(prompt, max_new_tokens=6) == want
