"""Port parity: the JAX package's ``ops/optimizer_ops.py`` through
``mx.nd``.

Every case of ``chip_smoke.UPDATE_CASES`` (the table ``chip_smoke.py``
also runs on the card against the port on the CPU) runs three chained
steps in each package with ``wd``, ``rescale_grad`` and ``clip_gradient``
on: an update wrapper with ``out=`` its weight (its in-place rule carries
the states), an op functionally with its results fed back, the
``preloaded_multi_*`` ops with their ``lrs`` and ``wds`` as device arrays.
The AMP ops and the multi-tensor reductions are the ``amp`` family of
``chip_smoke.MORE_CASES``. Tolerance ``chip_smoke.ND_TOL`` (1e-5
relative, 1e-6 absolute: fp32 in another order of operations), types and
shapes equal. ``chip_smoke.update_inplace_checks`` holds each wrapper's
in-place rule in both packages: the weight written only through ``out=``,
the trailing states always, nothing else. The ``mp_*`` rules run on bf16
weights with fp32 masters.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
CASES = {c.id: c for c in cs.UPDATE_CASES}
AMP_CASES = {c.id: c for c in cs.MORE_CASES if c.family == "amp"}
# one bf16 ulp at 1: a master weight within fp32 rounding may round to
# the neighbouring bf16 value
BF16 = dict(rtol=2 ** -7, atol=0)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_update_matches_jax_over_three_steps(case):
    cs.check_update_case(case, cs.run_update_case(mx, case),
                         cs.run_update_case(jmx, case))


@pytest.mark.parametrize("case", list(AMP_CASES.values()),
                         ids=list(AMP_CASES))
def test_amp_op_matches_jax(case):
    cs.check_nd_case(case, cs.run_nd_case(mx, case),
                     cs.run_nd_case(jmx, case, raw_array_kwargs=True))


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_in_place_rule_of_every_wrapper(pkg):
    assert cs.update_inplace_checks(pkg, mx.cpu() if pkg is mx else None) \
        == 14


def test_trap_adam_update_writes_the_state_and_not_the_weight():
    """``mx.nd.adam_update(w, g, m, v, lr=0.1)`` without ``out=``: the new
    weight is returned, ``w`` stays 1; ``m`` takes 0.05 in place. No bias
    correction: the step is 0.1 * 0.05 / sqrt(0.00025), not 0.1."""
    for pkg in (mx, jmx):
        nd = pkg.nd
        w, g, m, v = (nd.array(np.full(3, x, np.float32))
                      for x in (1.0, 0.5, 0.0, 0.0))
        new = nd.adam_update(w, g, m, v, lr=0.1)
        np.testing.assert_array_equal(w.asnumpy(), 1.0)
        np.testing.assert_allclose(m.asnumpy(), 0.05, rtol=1e-6)
        np.testing.assert_allclose(v.asnumpy(), 0.00025, rtol=1e-6)
        np.testing.assert_allclose(new[0].asnumpy(), 1 - 0.1 / np.sqrt(0.1),
                                   rtol=1e-5)


def test_trap_adamw_decay_is_decoupled_and_scaled_by_eta():
    w, g = np.full(2, 2.0, np.float32), np.zeros(2, np.float32)
    for pkg in (mx, jmx):
        nd = pkg.nd
        arrs = [nd.array(a) for a in (w, g, g, g)]
        nd.adamw_update(*arrs, lr=0.1, wd=0.5, eta=0.4, out=arrs[0])
        # a zero gradient moves the weight by the decay alone: eta * wd * w
        np.testing.assert_allclose(arrs[0].asnumpy(), 2.0 - 0.4 * 0.5 * 2.0,
                                   rtol=1e-6)


def test_out_writes_the_weight_tensor_in_place():
    w = mx.nd.array(np.ones(4, np.float32))
    own = w.as_torch()
    mx.nd.sgd_update(w, mx.nd.array(np.ones(4, np.float32)), lr=0.5, out=w)
    assert w.as_torch() is own
    np.testing.assert_array_equal(own.numpy(), 0.5)


@pytest.mark.parametrize("name, arrays, kwargs", [
    ("mp_sgd_update", "w g w32", dict(lr=0.1, wd=0.01)),
    ("mp_sgd_mom_update", "w g m w32", dict(lr=0.1, momentum=0.9)),
    ("mp_nag_mom_update", "w g m w32", dict(lr=0.1, momentum=0.9)),
    ("multi_mp_sgd_update", "w g w32 w g w32",
     dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), num_weights=2)),
    ("mp_lamb_update_phase2", "w g r1 r2 w32", dict(lr=0.1)),
])
def test_mp_rules_on_bf16_weights_with_fp32_masters(name, arrays, kwargs):
    rs = np.random.RandomState(7)
    base = {"w": rs.uniform(-1, 1, (3, 4)).astype(np.float32),
            "g": rs.uniform(-1, 1, (3, 4)).astype(np.float32),
            "m": rs.uniform(-0.1, 0.1, (3, 4)).astype(np.float32),
            "r1": np.float32([2.0]), "r2": np.float32([0.5])}
    base["w32"] = base["w"] + np.float32(1e-3)
    res = {}
    for pkg in (mx, jmx):
        nd = pkg.nd
        xs = [nd.array(base[k]).astype("bfloat16") if k in ("w", "g")
              else nd.array(base[k]) for k in arrays.split()]
        out = nd.invoke_op(name, *xs, **kwargs)
        out = out if isinstance(out, (tuple, list)) else (out,)
        res[pkg] = [(str(o.dtype), o.astype("float32").asnumpy())
                    for o in out]
    for (dt, got), (want_dt, want) in zip(res[mx], res[jmx]):
        assert dt.endswith("bfloat16") == want_dt.endswith("bfloat16")
        tol = BF16 if dt.endswith("bfloat16") else cs.ND_TOL
        np.testing.assert_allclose(got, want, **tol)
    # the weight comes back in bf16, its fp32 master in fp32
    assert res[mx][0][0].endswith("bfloat16")
    assert res[mx][-1][0] == "float32"


def test_preloaded_takes_device_lrs_and_wds():
    rs = np.random.RandomState(8)
    ws = [rs.uniform(-1, 1, (5,)).astype(np.float32) for _ in range(4)]
    nd = mx.nd
    attr = nd.multi_sgd_update(*[nd.array(w) for w in ws], lrs=(0.1, 0.3),
                               wds=(0.01, 0.0), num_weights=2)
    dev = nd.invoke_op("preloaded_multi_sgd_update",
                       *[nd.array(w) for w in ws], nd.array([0.1, 0.3]),
                       nd.array([0.01, 0.0]), num_weights=2)
    for a, b in zip(attr, dev):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_reset_arrays_zeroes_in_place_and_multi_writes_nothing():
    for pkg in (mx, jmx):
        nd = pkg.nd
        a, b = nd.array(np.ones(3, np.float32)), nd.array(
            np.full((2, 2), 4.0, np.float32))
        nd.reset_arrays(a, b, num_arrays=2)
        assert not a.asnumpy().any() and not b.asnumpy().any()
