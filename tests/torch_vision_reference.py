"""Shared by the ``tests/test_torch_vision_*.py`` files: a vision model
of the port against the same model of the JAX package on the CPU.

The port's model is built first and its deferred shapes are filled by one
CPU forward (fast in torch). Every parameter is then drawn from a numpy
seed at those shapes (``draw``: weights N(0, 0.1^2), gammas and running
variances |N(0, 0.1^2)| + 0.5). The JAX package's model takes the same
values by structural name as the arguments of its traced pass
(``jax_pass``: the ``_Trace`` mechanism of its ``SPMDTrainer`` step), and
that pass is compiled once for eval and once for a training step. The
JAX package's eager path compiles and dispatches each op at each new
shape (tens of seconds to minutes a model); its hybridized path, after
``Parameter.set_data`` of every value, gives the same logits and
statistics bit for bit and the same gradients (but those 0 in exact
arithmetic and the stem BatchNorm's cancelling gamma, within rounding)
at the cost of a compile per parameter shape and a third compile. The
same values go into the port with ``load_jax_params``.

Both sides then compute the eval logits (running statistics), and with
every ``Dropout`` rate set to 0 (JAX and torch draws cannot be matched;
the rate is an attribute, no code changes) the training logits, the
running statistics after the training forward and every gradient of the
mean softmax cross entropy.

Tolerance: relative L2 error ``RTOL`` 1e-4 for every compared tensor (fp32
on both sides, the order of sums differs). A gradient past ``RTOL`` is held
by ``chip_smoke.hold_gradients``, the rule the card's vision phase holds
the card to against the CPU: each side within ``RTOL`` of the exact
backward of its own forward, the port's fp64 model fed that side's every
leaf output (``jax_pass`` takes the JAX package's from its traced pass),
on the scale of the larger of its norm and its sibling's. The JAX
package's side ties the rule to the reference: its gradient must be what
the port's backward gives at its forward. Every compared feature map
stays at 2x2 or more: at 1x1 a BatchNorm over two values makes fp32
gradients disagree between any two implementations far beyond the
tolerance. The port's side runs on one intra-op thread
(``one_torch_thread``).
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
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import random as _jrandom
from incubator_mxnet_tpu.gluon.block import _Trace
from incubator_mxnet_tpu.gluon.nn import Dropout as JDropout
from incubator_mxnet_tpu.gluon.parameter import _trace
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.ops import fused_conv as fc

ROOT = pathlib.Path(__file__).resolve().parent.parent
CLASSES = 10
RTOL = 1e-4
STATS = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: its ops are small, and
    beside the other test processes torch's thread team waits on its
    descheduled members (a test that takes seconds alone took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def rel(got, want):
    return cs._rel_l2(got, want)


def assert_rel(name, got, want, tol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    assert np.shape(got) == np.shape(want), name
    err = rel(got, want)
    assert err <= tol, f"{name}: relative L2 error {err} > {tol}"


def _jax_blocks(block):
    yield block
    for child in block._children.values():
        yield from _jax_blocks(child)


def batch(b, hw, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(b, 3, hw, hw).astype(np.float32),
            rs.randint(0, CLASSES, (b,)).astype(np.float32))


def draw(net, seed):
    """A value for every parameter of ``net`` from ``seed``, by name."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in tensors_of(net).items():
        arr = (rs.randn(*p.shape) * 0.1).astype(np.float32)
        if name.endswith(("running_var", "gamma")):
            arr = np.abs(arr) + 0.5
        out[name] = arr
    return out


def build_port(make, hw, params=None):
    """The port's model on the CPU, its deferred shapes filled by one
    forward, then ``params`` carried in, if given; every Dropout rate at
    0."""
    net = make(mx).initialize("xavier", ctx=mx.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 3, hw, hw))
    if params is not None:
        load_jax_params(net, params, ctx=mx.cpu())
    for m in net.modules():
        if isinstance(m, mx.gluon.nn.Dropout):
            m._rate = 0.0
    return net


def _jax_leaves(block, prefix=""):
    """Every block of ``block`` without children, by the structural name
    that the port's ``named_modules`` gives its counterpart."""
    for key, child in block._children.items():
        if child._children:
            yield from _jax_leaves(child, f"{prefix}{key}.")
        else:
            yield prefix + key, child


def _keep(acts, name, forward, *args):
    out = forward(*args)
    acts[name] = out._data
    return out


def jax_pass(jnet, params, x, y):
    """The JAX side: every Dropout rate at 0, then the eval logits and a
    training pass (logits, mean softmax cross entropy, running statistics,
    every leaf block's output and the gradient of every trainable
    parameter), each one compiled call. The parameter values go in by
    structural name as the traced pass's arguments (the JAX package's
    ``_Trace``, under the key provider, as
    ``parallel.spmd.make_functional_loss`` builds ``SPMDTrainer``'s step),
    so nothing runs on the eager path. A leaf's output is taken by its
    ``forward`` wrapped in an instance attribute for the trace (the JAX
    package's code is not changed)."""
    drops = [b for b in _jax_blocks(jnet) if isinstance(b, JDropout)]
    for b in drops:
        b._rate = 0.0
    objs = jnet._collect_params_with_prefix()
    assert list(objs) == list(params)
    names = {id(p): n for n, p in objs.items()}
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    leaves = dict(_jax_leaves(jnet))

    def run(values, training, key):
        trace = _Trace({id(p): JNDArray(values[n])
                        for n, p in objs.items()})
        acts = {}
        for n, b in leaves.items():     # shadows the method for this trace
            b.forward = functools.partial(_keep, acts, n, b.forward)
        _trace.stack.append(trace)
        try:
            with _jrandom.key_provider(key), \
                    jautograd._RecordingStateScope(False, training):
                logits = jnet.forward(JNDArray(jnp.asarray(x)))
                loss = ce(logits, JNDArray(jnp.asarray(y)))._data.mean()
        finally:
            _trace.stack.pop()
            for b in leaves.values():
                del b.forward
        return loss, (logits._data, {names[i]: v for i, (_, v)
                                     in trace.aux.items()}, acts)

    train = {n: jnp.asarray(params[n]) for n, p in objs.items()
             if p.grad_req != "null"}
    frozen = {n: jnp.asarray(params[n]) for n, p in objs.items()
              if p.grad_req == "null"}
    key = jax.random.PRNGKey(0)
    eval_logits = jax.jit(lambda v, k: run(v, False, k)[1][0])(
        {**train, **frozen}, key)
    (loss, (logits, stats, acts)), grads = jax.jit(jax.value_and_grad(
        lambda t, f, k: run({**t, **f}, True, k), has_aux=True))(
            train, frozen, key)
    return dict(eval_logits=np.asarray(eval_logits),
                logits=np.asarray(logits), loss=float(loss),
                dropouts=len(drops),
                grads={n: np.asarray(g) for n, g in grads.items()},
                stats={n: np.asarray(v) for n, v in stats.items()},
                acts={n: np.asarray(v) for n, v in acts.items()})


def pair(make, hw, b, seed=0):
    """Both sides of ``make(pkg)`` (the same model built from either
    package) at ``b`` images of ``hw`` x ``hw``, every Dropout rate at 0:
    the port's model with the drawn values and the JAX side's results."""
    net = build_port(make, hw)
    dropouts = sum(isinstance(m, mx.gluon.nn.Dropout)
                   for m in net.modules())
    params = draw(net, seed)
    x, y = batch(b, hw, seed + 1)
    want = jax_pass(make(jmx), params, x, y)
    assert want["dropouts"] == dropouts
    load_jax_params(net, params, ctx=mx.cpu())
    return dict(make=make, net=net, params=params, x=x, y=y, hw=hw, **want)


def check(p):
    """The port against the JAX side: eval logits, training logits and
    loss, running statistics after the training forward, and every
    gradient (``cs.hold_gradients`` at ``RTOL``, the exact backward of
    either side's forward from the port's fp64 model on the CPU); no fused
    conv kernel is counted. Returns the names held past ``RTOL``, by
    the scale that held them."""
    net = p["net"]
    x, y = torch.from_numpy(p["x"]), torch.from_numpy(p["y"])
    fc.fused_conv_launches = fc.conv_bwd_dx_launches = 0
    fc.conv_bwd_dw_launches = 0
    with mx.autograd.pause():
        assert_rel("eval logits", net(x), p["eval_logits"])
    for n, v in tensors_of(net).items():
        if n.endswith(STATS):
            np.testing.assert_array_equal(v.detach().numpy(),
                                          p["params"][n])
    seen = {}
    logits, loss, got = cs.train_grads(net, x, y, seen)
    assert_rel("training logits", logits, p["logits"])
    assert abs(float(loss) - p["loss"]) <= RTOL * abs(p["loss"])
    ps = tensors_of(net)
    assert sorted(p["stats"]) == sorted(n for n in ps if n.endswith(STATS))
    for n, want in p["stats"].items():
        assert not np.array_equal(want, p["params"][n]), n
        assert_rel(n, ps[n], want)
    assert sorted(p["acts"]) == sorted(seen)
    net64 = []                         # one fp64 copy for both sides

    def replay_of(leaf_outputs):
        def run():
            if not net64:
                net64.append(build_port(p["make"], p["hw"],
                                        p["params"]).cast("float64"))
            return cs.replayed_grads(net64[0], x, y, leaf_outputs)
        return run

    _, held = cs.hold_gradients(
        "vision", got, p["grads"], RTOL, replay_of(seen),
        replay_of({n: torch.from_numpy(v) for n, v in p["acts"].items()}))
    assert (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
            fc.conv_bwd_dw_launches) == (0, 0, 0)
    return held


def check_mobilenet(make):
    """A MobileNet at B=2, 64x64 against the JAX package (``check``): no
    Dropout, the depthwise weights ``(C, 1, k, k)`` as carried in, the head
    compared directly, only BatchNorm tensors held on their sibling's
    scale."""
    p = pair(make, 64, 2)
    assert p["dropouts"] == 0
    for name, w in tensors_of(p["net"]).items():
        if name.endswith("weight") and w.dim() == 4 and w.shape[1] == 1:
            assert tuple(w.shape) == p["params"][name].shape, name
    held = check(p)
    assert all(n.endswith((".beta", ".gamma")) for n in held["sibling"])
    head = [n for n in p["grads"] if n.endswith("weight")][-1]
    assert head not in held["replay"], held
    return held
