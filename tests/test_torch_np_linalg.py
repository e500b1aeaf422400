"""Port parity: the JAX package's ``ops/linalg.py`` (16 ``la_op`` ops,
``mx.nd.linalg``) and the 15 ``np.linalg`` ops of ``ops/fft_ops.py``
(``mx.np.linalg``).

Every case of ``chip_smoke.NP_CASES`` in the families ``la_op`` and
``np_linalg`` goes through the JAX package and the port, the port on the
CPU (``tests/torch_np_reference.py``), with gradients through ``potrf``,
``potri``, ``trsm``, ``trmm``, ``det``, ``slogdet``, ``inverse``,
``solve``, ``inv``, ``pinv``, ``cholesky``, ``matrix_power``,
``multi_dot``, ``tensorsolve``/``tensorinv``, and through ``eigh``, ``svd``
and ``qr`` under a loss that a vector's sign does not change (the
eigenvectors, singular vectors and Q squared). A factorization that is
unique only up to signs is held by its invariants (``chip_smoke.post_*``):
each vector signed by its largest entry (Q and R by R's diagonal), and the
reconstruction. Tolerances: ``chip_smoke.ND_TOL`` for the products and
packers; ``chip_smoke.LINALG_TOL`` (1e-4 relative, 1e-5 absolute) for
what goes through a factorization (LAPACK here in another order than
jnp's; cuSOLVER on the card).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

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
CASES = R.cases("la_op", "np_linalg")

LA_OPS = sorted(n for n in jregistry.list_ops()
                if jregistry.get(n).fn.__module__.endswith("ops.linalg"))
NP_LINALG_OPS = sorted(n for n in jregistry.list_ops()
                       if jregistry.get(n).fn.__module__.endswith("fft_ops")
                       and n.startswith("linalg_"))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_linalg_op_matches_jax(case):
    R.check(case)


def test_trap_lstsq_is_the_minimum_norm_solution_by_svd():
    a, b = cs._DEFICIENT, cs._V[:5]
    x, resid, rank, s = (r.asnumpy() for r in mx.np.linalg.lstsq(
        mx.nd.array(a), mx.nd.array(b)))
    assert rank == 2 and rank.dtype == np.int32 and s.shape == (3,)
    # the minimum-norm solution: the third singular value dropped
    np.testing.assert_allclose(x, np.linalg.pinv(a, rcond=1e-5) @ b,
                               rtol=1e-4, atol=1e-5)
    assert resid.shape == (1,)               # jnp computes it always
    jx, jresid, jrank, js = (r.asnumpy() for r in jmx.np.linalg.lstsq(
        jmx.nd.array(a), jmx.nd.array(b)))
    assert jrank == rank
    np.testing.assert_allclose(x, jx, **cs.LINALG_TOL)


def test_trap_pinv_default_cutoff_is_jnp_s():
    # a singular value between torch's default cutoff (eps * 5) and jnp's
    # (10 * eps * 5) relative to the largest
    u, _ = np.linalg.qr(cs._nd_rand(180, 5, 5).astype(np.float64))
    v, _ = np.linalg.qr(cs._nd_rand(181, 3, 3).astype(np.float64))
    a = (u[:, :3] * np.array([1.0, 0.5, 2e-6]) @ v.T).astype(np.float32)
    got = mx.np.linalg.pinv(mx.nd.array(a)).asnumpy()
    want = jmx.np.linalg.pinv(jmx.nd.array(a)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    plain = torch.linalg.pinv(torch.from_numpy(a)).numpy()
    assert np.abs(plain).max() > 1e4 > np.abs(got).max()


def test_trap_single_array_results():
    a = mx.nd.array(cs._TALL)
    assert mx.np.linalg.qr(a, mode="r").shape == (3, 3)
    assert mx.np.linalg.svd(a, compute_uv=False).shape == (3,)
    assert mx.np.linalg.matrix_rank(a).dtype == np.int32


def test_trap_gemm_refuses_another_axis():
    x = mx.nd.array(cs._SQB)
    with pytest.raises(NotImplementedError, match="axis=-2"):
        mx.nd.linalg.gemm(x, x, x, axis=-3)


def test_trap_maketrian_finds_n_from_the_packed_length():
    for kw, k, n in (({}, 10, 4), (dict(offset=-1), 6, 4),
                     (dict(offset=2, lower=False), 3, 4)):
        d = cs._nd_rand(182, k)
        got = mx.nd.linalg.maketrian(mx.nd.array(d), **kw).asnumpy()
        assert got.shape == (n, n), kw
        back = mx.nd.linalg.extracttrian(mx.nd.array(got), **kw).asnumpy()
        np.testing.assert_array_equal(back, d)


def test_trap_syevd_and_gelqf_conventions():
    a = cs._SYM4
    u, lam = (r.asnumpy() for r in mx.nd.linalg.syevd(mx.nd.array(a)))
    np.testing.assert_allclose(u.T @ np.diag(lam) @ u, a, rtol=1e-4,
                               atol=1e-5)                 # rows: vectors
    q, low = (r.asnumpy() for r in mx.nd.linalg.gelqf(mx.nd.array(
        cs._WIDE[0])))
    np.testing.assert_allclose(low @ q, cs._WIDE[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-5)
    assert np.allclose(low, np.tril(low))


def test_every_linalg_op_is_registered_and_has_a_case():
    assert len(LA_OPS) == 16 and len(NP_LINALG_OPS) == 15
    ops = set(LA_OPS + NP_LINALG_OPS)
    assert ops <= set(registry.list_ops())
    for name in ops:
        assert registry.get(name).differentiable == \
            jregistry.get(name).differentiable, name
    covered = set()
    for case in CASES.values():
        if case.name.startswith("np:linalg."):
            name = "linalg_" + case.name.split(".")[-1]
            name = {"linalg_inv": "linalg_inverse"}.get(name, name)
        elif case.name.startswith("op:"):
            name = case.name[3:]
        else:
            name = cs._nd_fn(mx, case.name).__name__
        covered.add(registry.get(name).name)
    assert ops - {"linalg_det", "linalg_slogdet", "linalg_inverse"} \
        <= covered | {"linalg_gemm2"}, sorted(ops - covered)


def test_mx_nd_linalg_has_the_reference_s_names():
    names = [n for n in dir(jmx.nd.linalg) if not n.startswith("_")]
    assert len(names) == 17
    assert [n for n in names if not hasattr(mx.nd.linalg, n)] == []
    assert mx.nd.linalg.gemm2 is mx.nd.linalg_gemm2
