"""Port parity: the fused ResNet v1 and its training.

A miniature ``FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256],
classes=10)`` (the shape family of ResNet-50: stride-2 stages, downsample
projections, the residual-epilogue chain) is drawn in the JAX package,
its parameters set from a numpy seed, and carried into the port with
``load_jax_params``. On a batch of two images both compute the eval
logits (running statistics), the training logits, the updated running
statistics and every gradient of the mean softmax cross entropy. The
images are 64x64, so the last stage still sees 2x2 pixels: at 16x16
stages 3 and 4 run at 1x1, where a BatchNorm over two values passes an
exact gradient near zero, and two fp32 computations that sum in other
orders disagree in the gradients below it far beyond the tolerance. The
JAX side runs its Pallas kernels in interpret mode on the CPU, which is
slow (about 40 s), so it is computed once for the module; the port runs
the plain versions of its CUDA kernels.

Tolerance: relative L2 error 1e-4 for every compared tensor (fp32 on both
sides; sixteen convs deep, the two differ in the order of sums only).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo.vision import fused_resnet as jfr
from incubator_mxnet_tpu.parallel.spmd import collect_params

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import gluon, parallel
from incubator_mxnet_tpu_torch.gluon.model_zoo import (get_model,
                                                       load_jax_params)
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
    FusedResNetV1, fused_resnet50_v1)
from incubator_mxnet_tpu_torch.ops import fused_conv as fc

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10
B, HW = 2, 64
RTOL = 1e-4


def _params(seed):
    """Parameter values by structural name (numpy): weights N(0, 0.1^2),
    gammas and running variances |N(0, 0.1^2)| + 0.5."""
    jnet = jfr.FusedResNetV1(LAYERS, CHANNELS, classes=CLASSES)
    jnet.initialize(init="xavier")
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in collect_params(jnet).items():
        arr = (rs.randn(*p.shape) * 0.1).astype(np.float32)
        if name.endswith(("running_var", "gamma")):
            arr = np.abs(arr) + 0.5
        out[name] = arr
    return jnet, out


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, 3, HW, HW).astype(np.float32),
            rs.randint(0, CLASSES, (B,)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_side():
    """Eval logits, then (under record) training logits, the running
    statistics after the step's forward and all gradients, from the JAX
    package; computed once."""
    jnet, params = _params(0)
    for name, p in collect_params(jnet).items():
        p.set_data(jmx.nd.array(params[name]))
    x, y = _batch(1)
    eval_logits = jnet(jmx.nd.array(x)).asnumpy()
    with jautograd.record():
        logits = jnet(jmx.nd.array(x))
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits, jmx.nd.array(y)).mean()
    loss.backward()
    objs = collect_params(jnet)
    return dict(
        params=params, x=x, y=y, eval_logits=eval_logits,
        logits=logits.asnumpy(), loss=float(loss.asnumpy()),
        grads={n: p.grad().asnumpy() for n, p in objs.items()
               if p.grad_req != "null"},
        stats={n: p.data().asnumpy() for n, p in objs.items()
               if p.grad_req == "null"})


def _port(params):
    net = FusedResNetV1(LAYERS, CHANNELS, classes=CLASSES)
    return load_jax_params(net, params, ctx=mx.cpu())


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


def _assert_rel(name, got, want, tol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    assert np.shape(got) == np.shape(want), name
    err = _rel(got, want)
    assert err <= tol, f"{name}: relative L2 error {err} > {tol}"


def test_eval_logits_match_jax(jax_side):
    net = _port(jax_side["params"])
    fc.fused_conv_launches = 0
    with mx.autograd.pause():
        got = net(torch.from_numpy(jax_side["x"]))
    assert got.shape == (B, CLASSES) and got.grad_fn is None
    _assert_rel("eval logits", got, jax_side["eval_logits"])
    assert fc.fused_conv_launches == 0        # CPU: the plain versions ran
    # eval leaves the running statistics alone
    for name, v in tensors_of(net).items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(v.detach().numpy(),
                                          jax_side["params"][name])


def test_training_logits_stats_and_gradients_match_jax(jax_side):
    net = _port(jax_side["params"])
    x = torch.from_numpy(jax_side["x"])
    y = torch.from_numpy(jax_side["y"])
    with mx.autograd.record():
        logits = net(x)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits, y).mean()
    mx.autograd.backward(loss)
    _assert_rel("training logits", logits, jax_side["logits"])
    assert abs(float(loss.detach()) - jax_side["loss"]) \
        <= RTOL * jax_side["loss"]
    own = tensors_of(net)
    assert set(jax_side["grads"]) == {n for n, p in own.items()
                                      if p.requires_grad}
    assert set(jax_side["stats"]) == {n for n, p in own.items()
                                      if not p.requires_grad}
    for name, want in jax_side["stats"].items():
        _assert_rel(name, own[name], want)
        assert own[name].grad is None
    for name, want in jax_side["grads"].items():
        _assert_rel("grad " + name, own[name].grad, want)


def test_spmd_step_matches_eager_trainer_step_with_running_stats():
    """One ``SPMDTrainer`` step (SGD, momentum) equals one eager
    ``autograd.record`` + ``gluon.Trainer`` step of the port: the same
    weights after the update and the same running statistics, which the
    SPMD step keeps in its own parameters and ``sync_to_net`` writes
    back."""
    _, params = _params(2)
    x, y = (torch.from_numpy(v) for v in _batch(3))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.1, "momentum": 0.9}

    eager = _port(params)
    tr = gluon.Trainer(eager.collect_params(), "sgd", opt)
    with mx.autograd.record():
        per_sample = ce(eager(x), y)
    mx.autograd.backward(per_sample)
    tr.step(B)

    net = _port(params)
    st = parallel.SPMDTrainer(net, lambda lg, lb: ce(lg, lb).mean(), "sgd",
                              opt)
    loss = st.step(x, y)
    assert abs(float(loss) - float(per_sample.detach().mean())) < 1e-6
    stat_names = [n for n in params if n.endswith(("running_mean",
                                                   "running_var"))]
    assert len(stat_names) == 2 * 17         # 17 BatchNorm sites
    for n in stat_names:                # the step's statistics persist
        assert not np.array_equal(st.params[n].numpy(), params[n]), n
        np.testing.assert_array_equal(tensors_of(net)[n].numpy(),
                                      params[n])
    st.sync_to_net()
    want = tensors_of(eager)
    for n, p in tensors_of(net).items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[n].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_fresh_model_initializes_running_stats_and_norm_params():
    """Names ending in running_mean/running_var take 0/1, gamma/beta 1/0,
    as the JAX initializer's name dispatch (never a Xavier draw)."""
    mx.random.seed(4)
    net = FusedResNetV1(LAYERS, CHANNELS, classes=CLASSES).initialize(
        "xavier", ctx=mx.cpu())
    seen = set()
    for name, p in tensors_of(net).items():
        v = p.detach().numpy()
        for suffix, want in (("running_mean", 0.0), ("running_var", 1.0),
                             ("gamma", 1.0), ("beta", 0.0), ("bias", 0.0)):
            if name.endswith(suffix):
                assert np.all(v == want), name
                seen.add(suffix)
        if name.endswith("weight"):
            assert np.std(v) > 0, name
    assert seen == {"running_mean", "running_var", "gamma", "beta", "bias"}


def test_resnet50_inventory_and_frozen_running_stats():
    net = fused_resnet50_v1()
    ps = dict(net.named_parameters())
    assert len(ps) == 267
    assert sum(p.numel() for p in ps.values()) == 25_610_152
    train = [n for n, p in ps.items() if p.requires_grad]
    frozen = [n for n, p in ps.items() if not p.requires_grad]
    assert len(train) == 161 and len(frozen) == 106
    assert sum(ps[n].numel() for n in train) == 25_557_032
    assert all(n.endswith(("running_mean", "running_var")) for n in frozen)
    assert all(getattr(ps[n], "grad_req", None) == "null" for n in frozen)
    assert list(ps)[:6] == ["conv0_weight", "bn0_gamma", "bn0_beta",
                            "bn0_running_mean", "bn0_running_var",
                            "stages.0.0.conv1_weight"]
    assert list(ps)[-2:] == ["output.weight", "output.bias"]
    assert tuple(ps["stages.1.0.convd_weight"].shape) == (1, 1, 256, 512)


def test_get_model_knows_the_fused_names_only():
    """``get_model`` knows the fused names and, since the gluon layer set
    is ported, the zoo ``resnet50_v1``; since the whole vision zoo is
    ported, only an unknown name raises, in the reference's words."""
    net = get_model("fused_resnet101_v1", classes=7)
    assert tuple(net.output.weight.shape) == (7, 2048)
    for name in ("fused_resnet50_v1", "fused_resnet152_v1"):
        assert isinstance(get_model(name, classes=3), FusedResNetV1)
    zoo = get_model("resnet50_v1", classes=7)
    assert not isinstance(zoo, FusedResNetV1)
    assert tuple(zoo.output.weight.shape) == (7, 2048)
    assert not isinstance(get_model("vgg16"), FusedResNetV1)
    with pytest.raises(ValueError, match="'vgg17' not found; available:"):
        get_model("vgg17")


def test_trainer_leaves_running_stats_alone():
    """``gluon.Trainer`` over all parameters: no stale-gradient error for
    the running statistics, which have no gradient and are not updated by
    the optimizer (only by the forward)."""
    _, params = _params(5)
    net = _port(params)
    x, y = (torch.from_numpy(v) for v in _batch(6))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with mx.autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    after_fwd = {n: p.detach().clone() for n, p in
                 tensors_of(net).items() if not p.requires_grad}
    mx.autograd.backward(loss)
    tr.step(B)
    for n, v in after_fwd.items():
        assert torch.equal(tensors_of(net)[n], v), n
