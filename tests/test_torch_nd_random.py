"""Port parity: the JAX package's ``ops/random_ops.py``, ``mx.nd.random``
and the RNG contract of the port's registry.

The samplers draw from the port's ``torch.Generator`` of a device, not
JAX's threefry, so they are held by their statistics:
``chip_smoke.sampler_checks`` on the CPU at 2^16 draws (the card runs it
at 2^20) through each package, every sampler's mean and variance within
5 standard errors of the distribution's, its support, and its dtype and
shape equal to the reference's on the same call; ``randint`` covering
[low, high), ``shuffle`` a permutation of the rows, ``multinomial``'s
frequencies by chi-squared, ``image.random_flip_left_right`` one coin for
the batch. ``mx.random.get_state``/``set_state`` replay the same draws.
An op with ``needs_rng`` gets the generator of its operands' device, or of
``ctx`` where it has none, never torch's default generator. The
``random_pdf_*`` ops are deterministic and differentiable: their cases
(``chip_smoke.MORE_CASES``, family ``pdf``) are held against the JAX
package to ``ND_TOL`` (1e-5 relative), the log-gamma ones to ``ND_LOOSE``
(1e-4: each library's own series).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2 ** 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
PDF_CASES = {c.id: c for c in cs.MORE_CASES if c.family == "pdf"}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def reference_draws():
    jmx.random.seed(3)
    return cs.sampler_checks(jmx, None, N)


def test_samplers_by_their_statistics(reference_draws):
    mx.random.seed(3)
    got = cs.sampler_checks(mx, mx.cpu(), N)
    assert sorted(got) == sorted(reference_draws) and len(got) == 23
    for name, (dtype, shape, z) in got.items():
        assert (dtype, shape) == reference_draws[name][:2], name
        assert z <= 5.0 and reference_draws[name][2] <= 5.0, name


@pytest.mark.parametrize("sampler, args", [
    ("uniform", (0.0, 2.0)), ("normal", (1.0, 0.5)), ("gamma", (2.0, 1.5)),
    ("exponential", (3.0,)), ("poisson", (4.0,)), ("randint", (2, 9)),
    ("bernoulli", (0.25,))])
def test_sampler_positional_order_and_types_match_the_reference(sampler,
                                                               args):
    got = getattr(mx.nd.random, sampler)(*args, shape=(2, 3))
    want = getattr(jmx.nd.random, sampler)(*args, shape=(2, 3))
    assert got.shape == want.shape == (2, 3)
    assert got.dtype == want.dtype
    half = getattr(mx.nd.random, sampler)(*args, shape=(4,),
                                          dtype="float16")
    assert half.dtype == np.float16


def test_multinomial_shape_and_unnormalised_rows():
    data = [[0.0, 2.0, 0.0], [1.0, 0.0, 0.0]]
    for pkg in (mx, jmx):
        out = pkg.nd.random.multinomial(pkg.nd.array(data), shape=3)
        assert out.shape == (2, 3) and out.dtype == np.int32
        np.testing.assert_array_equal(out.asnumpy(), [[1] * 3, [0] * 3])
        assert pkg.nd.sample_multinomial(pkg.nd.array(data)).shape == (2,)


def test_set_state_replays_the_draws():
    for pkg, ctx in ((mx, mx.cpu()), (jmx, None)):
        assert cs.state_replay_check(pkg, ctx) == 3


def test_set_state_resets_a_generator_made_after_the_snapshot():
    mx.random.seed(11)
    state = mx.random.get_state()
    first = mx.nd.random.uniform(shape=(5,), ctx=mx.cpu()).asnumpy()
    mx.random.set_state(state)
    again = mx.nd.random.uniform(shape=(5,), ctx=mx.cpu()).asnumpy()
    np.testing.assert_array_equal(first, again)
    assert isinstance(mx.random.get_state()["generators"], dict)


def test_needs_rng_dispatch_through_invoke():
    gen = mx.random.generator(mx.cpu())
    before = gen.get_state()
    torch_before = torch.get_rng_state()
    out = mx.nd.invoke_op("random_uniform", shape=(4,))
    assert out.ctx == mx.cpu()
    assert not torch.equal(gen.get_state(), before)
    # an explicit generator is honoured
    mine = torch.Generator().manual_seed(5)
    a = mx.nd.invoke_op("random_normal", shape=(3,), rng=mine).asnumpy()
    b = mx.nd.invoke_op("random_normal", shape=(3,),
                        rng=torch.Generator().manual_seed(5)).asnumpy()
    np.testing.assert_array_equal(a, b)
    # an operand's device picks the generator; a shuffle draws from it
    state = gen.get_state()
    mx.nd.random.shuffle(mx.nd.arange(10))
    assert not torch.equal(gen.get_state(), state)
    # no sampler draws from torch's default generator
    cs.sampler_checks(mx, mx.cpu(), 2 ** 10, sigmas=50.0)
    assert torch.equal(torch.get_rng_state(), torch_before)
    assert registry.get("random_uniform").needs_rng
    assert not registry.get("random_pdf_normal").needs_rng


def test_a_gpu_context_never_draws_on_the_cpu():
    # this machine has no card: a gpu context raises, never falls back
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.random.uniform(shape=(2,), ctx=mx.gpu(0))
    with mx.gpu(0), pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.invoke_op("random_normal", shape=(2,))


@pytest.mark.parametrize("case", list(PDF_CASES.values()), ids=list(PDF_CASES))
def test_pdf_matches_jax(case):
    cs.check_nd_case(case, cs.run_nd_case(mx, case),
                     cs.run_nd_case(jmx, case, raw_array_kwargs=True))


def test_pdf_of_a_sample_outside_the_support():
    out = mx.nd.random_pdf_uniform(mx.nd.array([-1.0, 0.5, 3.0]),
                                   mx.nd.array([0.0] * 3),
                                   mx.nd.array([2.0] * 3)).asnumpy()
    np.testing.assert_allclose(out, [0.0, 0.5, 0.0])
    log = mx.nd.random_pdf_uniform(mx.nd.array([-1.0]), mx.nd.array([0.0]),
                                   mx.nd.array([2.0]), is_log=True)
    assert log.asnumpy()[0] == -np.inf
