"""Port parity: the FFT family and the complex parts of the JAX package's
``ops/fft_ops.py`` (``mx.np.fft``), and autograd through complex
intermediates.

Every case of ``chip_smoke.NP_CASES`` in the families ``fft`` and
``complex`` goes through the JAX package and the port, the port on the CPU
(``tests/torch_np_reference.py``); a complex output enters the gradient's
head through its real and imaginary parts. FFT results are held within
``chip_smoke.fft_tol(n)``: 1e-5 relative and 1e-6 absolute times
log2(n) of the transform's length (fp32 rounding grows with the FFT's
depth); the complex parts within ``chip_smoke.ND_TOL``. The leaves are
real, as the reference's users keep them; a complex leaf's gradient in
PyTorch is the conjugate of JAX's, which one test shows.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry

_spec = importlib.util.spec_from_file_location(
    "torch_np_reference",
    pathlib.Path(__file__).resolve().parent / "torch_np_reference.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
cs = R.cs
CASES = R.cases("fft", "complex")

FFT_OPS = sorted(n for n in jregistry.list_ops()
                 if jregistry.get(n).fn.__module__.endswith("fft_ops")
                 and not n.startswith("linalg_"))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_fft_op_matches_jax(case):
    R.check(case)


@pytest.mark.parametrize("part", ["abs", "real", "imag", "angle"])
def test_autograd_through_a_complex_intermediate(part):
    """A real leaf -> ``fft`` -> a real part of the spectrum -> loss: the
    gradient equals the JAX package's."""
    x = cs._M
    w = cs._nd_rand(183, 3, 4)
    grads = []
    for pkg in (mx, jmx):
        nd = pkg.nd
        a = nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            spec = pkg.np.fft.fft(a, axis=1)
            y = {"abs": nd.invoke_op("absolute_complex", spec),
                 "real": nd.real(spec), "imag": nd.imag(spec),
                 "angle": nd.angle(spec)}[part]
            loss = (y * nd.array(w)).sum()
        loss.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_allclose(grads[0], grads[1], **cs.fft_tol(4))


def test_irfft_of_rfft_is_the_identity_with_its_gradient():
    x = cs._V
    a = mx.nd.array(x)
    a.attach_grad()
    with mx.autograd.record():
        y = mx.np.fft.irfft(mx.np.fft.rfft(a), n=8)
        loss = (y * mx.nd.array(cs._V[::-1].copy())).sum()
    loss.backward()
    np.testing.assert_allclose(y.asnumpy(), x, **cs.fft_tol(8))
    np.testing.assert_allclose(a.grad.asnumpy(), cs._V[::-1], **cs.fft_tol(8))


def test_a_complex_leaf_gradient_is_the_conjugate_of_jax_s():
    """PyTorch's convention for a complex leaf: the conjugate of what
    ``jax.grad`` gives for the same real loss."""
    z = cs._C8
    w = cs._nd_rand(184, 8)
    a = mx.nd.array(z)
    a.attach_grad()
    with mx.autograd.record():
        loss = (mx.nd.real(mx.np.fft.fft(a) * mx.np.fft.fft(a))
                * mx.nd.array(w)).sum()
    loss.backward()
    want = jax.grad(lambda t: jnp.sum(jnp.real(jnp.fft.fft(t) ** 2) * w))(
        jnp.asarray(z))
    np.testing.assert_allclose(a.grad.asnumpy(), np.conj(np.asarray(want)),
                               rtol=1e-4, atol=1e-4)


def test_every_fft_op_is_registered_and_has_a_case():
    assert len(FFT_OPS) == 15
    assert set(FFT_OPS) <= set(registry.list_ops())
    covered = set()
    for case in CASES.values():
        name = case.name.split(".")[-1] if case.name.startswith("np:") else \
            case.name[3:] if case.name.startswith("op:") else case.name
        covered.add(registry.get(name).name)
    assert set(FFT_OPS) <= covered, sorted(set(FFT_OPS) - covered)


def test_results_are_complex64():
    spec = mx.np.fft.fft(mx.nd.array(cs._V))
    assert spec.dtype == np.complex64 and spec.asnumpy().dtype == np.complex64
    assert mx.np.fft.irfft(spec).dtype == np.float32
    assert mx.np.fft.fft(mx.nd.array(cs._INTS)).dtype == np.complex64
