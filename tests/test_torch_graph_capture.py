"""The step engines on CUDA graphs, on the card: capture against eager.

This file imports nothing of JAX, so it runs on a machine with a card and
no JAX (``python -m pytest --noconftest tests/test_torch_graph_capture.py``;
the repo's conftest imports JAX). Without a card every test skips: a CUDA
graph has no CPU mode (the CPU tests of the same engines are
``tests/test_torch_superstep.py`` and
``tests/test_torch_gluon_superstep.py``).

Each engine's graph path (``SPMDTrainer.run_superstep``/``run_steps``, the
gluon ``SuperStep``, the captured decode step) is held against the eager
path from the same state and seed, bit for bit: the same kernels run in
the same order on the same inputs, dropout draws included. The kernel
launch counters of a replay equal those of the K eager steps.
"""

import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, parallel, serving
from incubator_mxnet_tpu_torch.config import config
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.fused_resnet import \
    FusedResNetV1
from incubator_mxnet_tpu_torch.ops import fused_conv as fc
from incubator_mxnet_tpu_torch.ops import launches
from incubator_mxnet_tpu_torch.parallel.superstep import stack_window

K = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _knob():
    yield
    config.unset("MXTPU_SUPERSTEP")


NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _mlp(dtype):
    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=32, activation="relu"), nn.Dropout(0.3),
            nn.Dense(10, in_units=64))
    net.initialize("xavier", ctx=mx.gpu(0))
    net.cast(NAMES[dtype])
    return net


def _gpt(dtype):
    net = get_gpt("gpt_decoder_117m", vocab_size=97, units=128,
                  num_layers=2, num_heads=2, max_length=64, dropout=0.1)
    net.initialize("xavier", ctx=mx.gpu(0))
    net.cast(NAMES[dtype])
    return net


def _resnet(dtype):
    net = FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256], classes=10)
    net.initialize("xavier", ctx=mx.gpu(0))
    net.cast(NAMES[dtype])
    return net


def _ce():
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    return lambda out, y: ce(out, y).mean()


def _window(model, dtype, k, seed):
    rs = np.random.RandomState(seed)
    if model == "mlp":
        xs = [rs.rand(16, 32).astype(np.float32) for _ in range(k)]
        ys = [rs.randint(0, 10, (16,)).astype(np.float32)
              for _ in range(k)]
    elif model == "gpt":
        xs = [rs.randint(0, 97, (2, 64)).astype(np.int32) for _ in range(k)]
        ys = [rs.randint(0, 97, (2, 64)).astype(np.float32)
              for _ in range(k)]
    else:
        xs = [rs.rand(2, 3, 64, 64).astype(np.float32) for _ in range(k)]
        ys = [rs.randint(0, 10, (2,)).astype(np.float32) for _ in range(k)]
    x, y = stack_window(list(zip(xs, ys)))
    x = torch.from_numpy(x).cuda()
    if x.is_floating_point():
        x = x.to(dtype)
    return x, torch.from_numpy(y).cuda()


BUILD = {"mlp": _mlp, "gpt": _gpt, "resnet": _resnet}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("model,opt", [
    ("mlp", "sgd"), ("mlp", "adam"), ("gpt", "sgd"), ("resnet", "sgd")])
def test_run_superstep_graph_equals_eager_steps(cuda_device, model, opt,
                                                dtype):
    """One window through the graph (capture, one replay) and a second
    (replay only) against 2K eager ``step()`` calls from the same state
    and seed: losses, every parameter and running statistic, and the
    generator after, bit for bit; the launch counters: the first window
    counts K + 1 eager steps' launches (its warm-up step ran, the capture
    counted nothing), the second, a replay alone, K steps'."""
    mx.random.seed(0)
    net = BUILD[model](dtype)
    kw = {"learning_rate": 0.05, "momentum": 0.9} if opt == "sgd" \
        else {"learning_rate": 1e-3}
    eager = parallel.SPMDTrainer(net, _ce(), opt, kw)
    graph = parallel.SPMDTrainer(net, _ce(), opt, kw)
    wins = [_window(model, dtype, K, s) for s in (1, 2)]

    mx.random.seed(5)
    want, counts = [], []
    for x, y in wins:
        c0 = launches.snapshot()
        want += [eager.step(x[i], y[i]) for i in range(K)]
        counts.append(launches.delta(c0, launches.snapshot()))
    after_eager = mx.random.generator(mx.gpu(0)).get_state()

    mx.random.seed(5)
    got, replay_counts = [], []
    for x, y in wins:
        c0 = launches.snapshot()
        got.append(graph.run_superstep(x, y))
        replay_counts.append(launches.delta(c0, launches.snapshot()))
    assert torch.equal(torch.stack(want), torch.cat(got))
    for n in eager.params:
        assert torch.equal(eager.params[n], graph.params[n]), n
    assert torch.equal(after_eager,
                       mx.random.generator(mx.gpu(0)).get_state())
    assert replay_counts == [{n: v + v // K for n, v in counts[0].items()},
                             counts[1]]
    if model != "mlp":
        assert counts[0], "the path launched none of the port's kernels"
    (g,) = graph._graphs.graphs()
    assert g.replays == 2 and g.counted == counts[1]


def test_run_steps_graph_equals_eager(cuda_device):
    """``run_steps(n)``: one captured step replayed n times, against n
    eager steps on the same batch."""
    mx.random.seed(0)
    net = _gpt(torch.bfloat16)
    eager = parallel.SPMDTrainer(net, _ce(), "sgd", {"learning_rate": 0.05})
    graph = parallel.SPMDTrainer(net, _ce(), "sgd", {"learning_rate": 0.05})
    x, y = _window("gpt", torch.bfloat16, 1, 3)
    mx.random.seed(1)
    for _ in range(4):
        want = eager.step(x[0], y[0])
    mx.random.seed(1)
    got = graph.run_steps(4, x[0], y[0])
    assert torch.equal(want, got)
    for n in eager.params:
        assert torch.equal(eager.params[n], graph.params[n]), n


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_gluon_superstep_graph_equals_eager(cuda_device, opt, kw):
    """The gluon SuperStep's replay against its eager path
    (``MXTPU_SUPERSTEP=0``: forward, backward, ``Trainer.step(1)``) over
    two windows, bit for bit, one dispatch a window."""
    out = []
    for knob in ("auto", "0"):
        config.set("MXTPU_SUPERSTEP", knob)
        mx.random.seed(0)
        net = _mlp(torch.float32)
        tr = gluon.Trainer(net.collect_params(), opt, kw)
        eng = tr.superstep(net, _ce(), window=K)
        mx.random.seed(9)
        losses = torch.cat([eng.run_window(*_window("mlp", torch.float32,
                                                    K, s))
                            for s in (1, 2)])
        out.append((losses, [p.detach().clone() for p in net.parameters()],
                    eng.dispatch_count))
    (lf, pf, df), (le, pe, de) = out
    assert (df, de) == (2, 0)
    assert torch.equal(lf, le)
    for a, b in zip(pf, pe):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_capture_on_a_fresh_thread(cuda_device, dtype):
    """A thread that never ran an encode captures K3 (the weight gradient,
    fed by TMA) and K1 in a CUDA graph: the tensor-map encoder binds the
    thread's context with libcuda calls, which a capture allows (the
    runtime's ``cudaFree(nullptr)`` would invalidate it). The replay
    equals the eager calls bit for bit."""
    rs = np.random.RandomState(0)
    n, h, ci, co = 2, 28, 128, 128
    t = {k: torch.from_numpy(v.astype(np.float32)).to(cuda_device)
         for k, v in dict(x=rs.randn(n, h, h, ci),
                          w=rs.randn(3, 3, ci, co) / 34,
                          dy=rs.randn(n, h // 2, h // 2, co),
                          a=rs.rand(ci) + 0.5, b=rs.randn(ci) * 0.5,
                          ds=rs.randn(co) * 0.1,
                          dss=rs.randn(co) * 0.01).items()}
    for key in ("x", "w", "dy"):
        t[key] = t[key].to(dtype)
    y = t["x"][:, ::2, ::2, :].contiguous()
    args = (t["x"], t["w"], t["a"], t["b"], y, t["dy"], t["ds"], t["dss"],
            2, 1, True)
    want = (fc.conv_bwd_dw(*args), fc.fused_conv(*args[:4], 2, 1, True)[0])
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            side = torch.cuda.Stream()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                got = (fc.conv_bwd_dw(*args),
                       fc.fused_conv(*args[:4], 2, 1, True)[0])
            g.replay()
            torch.cuda.synchronize()
            out["got"] = got
        except Exception as e:  # re-raised on the test's thread
            out["err"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "err" in out:
        raise out["err"]
    for got, ref in zip(out["got"], want):
        assert torch.equal(got, ref)


def test_decode_graph_streams_equal_the_eager_session(cuda_device):
    """The captured decode step streams the same tokens as the same
    session stepping eagerly, and each replay counts 2 split-route K4
    launches (one a layer)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    mx.random.seed(0)
    net = _gpt(torch.float32)
    prompts = [np.random.RandomState(s).randint(1, 97, (n,)).astype(np.int32)
               for s, n in ((1, 5), (2, 17), (3, 30))]
    streams = []
    for captured in (True, False):
        sess = serving.DecodeSession(net, ctx=mx.gpu(0), max_slots=4,
                                     max_len=64, prefill_buckets=(16, 32))
        if not captured:
            sess._decode = lambda cl, tk, s=sess: s._decode_step(
                torch.from_numpy(tk).cuda(), torch.from_numpy(cl).cuda())
        sess.warmup()
        split0 = fa.flash_fwd_split_launches
        got = [sess.generate(p, max_new_tokens=6, timeout=120)
               for p in prompts]
        steps = sess.stats()["steps"]
        assert fa.flash_fwd_split_launches - split0 == 2 * steps
        assert len(sess._graphs) == int(captured)
        sess.close()
        streams.append(got)
    assert streams[0] == streams[1]
