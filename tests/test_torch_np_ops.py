"""Port parity: the JAX package's ``ops/numpy_ops.py`` (108 ops) and the
``mx.np`` shims and creators.

Every case of ``chip_smoke.NP_CASES`` in the families ``numpy``, ``np``
and ``np_creators`` (numpy inputs from a seed, the table ``chip_smoke.py``
also runs on the card against the port on the CPU) goes through the JAX
package and the port, the port on the CPU, with the gradient of a seeded
head where the case names inputs to differentiate
(``tests/torch_np_reference.py``). Tolerance ``chip_smoke.ND_TOL`` (1e-5
relative, 1e-6 absolute: fp32 in another order of operations); integer,
bool and index results bit for bit, with their dtypes. Each place where
jnp's answer is not PyTorch's default is a test of its own.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXTPUError
from incubator_mxnet_tpu_torch.ops import numpy_ops, registry

_spec = importlib.util.spec_from_file_location(
    "torch_np_reference",
    pathlib.Path(__file__).resolve().parent / "torch_np_reference.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
cs = R.cs
CASES = R.cases("numpy", "np", "np_creators")

# the JAX package's ops/numpy_ops.py
NUMPY_OPS = sorted(n for n in jregistry.list_ops()
                   if jregistry.get(n).fn.__module__.endswith("numpy_ops"))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_numpy_op_matches_jax(case):
    R.check(case)


def _port(name, *arrays, **kwargs):
    return getattr(mx.nd, name)(*[mx.nd.array(a, dtype=a.dtype)
                                  for a in arrays], **kwargs)


def test_trap_median_of_an_even_count_averages_the_middle_pair():
    x = np.array([4.0, 1.0, 3.0, 2.0], np.float32)
    got = _port("median", x).asnumpy()
    assert got == 2.5 == float(jmx.nd.median(jmx.nd.array(x)).asnumpy())
    assert float(torch.median(torch.from_numpy(x))) == 2.0   # the lower one


def test_trap_quantile_of_more_than_2_to_the_24_elements():
    # torch.quantile refuses this input; the port sorts and interpolates
    n = 2 ** 24 + 3
    x = torch.arange(n, dtype=torch.float32).remainder_(1000.0)
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.25)
    got = numpy_ops.quantile(x, q=0.25)
    assert float(got) == float(np.quantile(x.numpy(), 0.25))


def test_trap_partition_and_argpartition_fix_jnp_order():
    x = cs._PART                                   # [5, 1, 4, 1, 3, 2, 9]
    for pkg in (mx, jmx):
        part = pkg.nd.partition_op(pkg.nd.array(x), kth=2).asnumpy()
        arg = pkg.nd.argpartition(pkg.nd.array(x), kth=2).asnumpy()
        assert part.tolist() == [1, 1, 2, 9, 5, 4, 3]
        assert arg.tolist() == [1, 3, 5, 0, 2, 4, 6]
        assert arg.dtype == np.int32


def test_trap_nanargmax_of_an_all_nan_slice_is_minus_1():
    x = cs._NANS
    with pytest.raises(ValueError):
        np.nanargmax(x, axis=1)                    # numpy refuses
    for name in ("nanargmax", "nanargmin"):
        got = _port(name, x, axis=1).asnumpy()
        assert got[2] == -1 and got.dtype == np.int32
        np.testing.assert_array_equal(
            got, getattr(jmx.nd, name)(jmx.nd.array(x), axis=1).asnumpy())


def test_trap_float_power_computes_in_float32():
    a, b = cs._POS, cs._X
    got = _port("float_power", a, b)
    assert got.dtype == np.float32
    assert torch.float_power(torch.from_numpy(a),
                             torch.from_numpy(b)).dtype == torch.float64


def test_trap_bitwise_ops_cast_floats_to_int32():
    x = np.array([1.7, -2.2, 5.9], np.float32)
    got = _port("invert", x)
    assert got.dtype == np.int32
    assert got.asnumpy().tolist() == [~1, ~-2, ~5]
    assert _port("left_shift", x, np.array([1, 2, 0], np.int32)
                 ).asnumpy().tolist() == [2, -8, 5]


def test_trap_heaviside_mixes_dtypes():
    got = _port("heaviside", np.array([-2, 0, 3], np.int32),
                np.array([0.5, 0.5, 0.5], np.float32))
    assert got.dtype == np.float32
    assert got.asnumpy().tolist() == [0.0, 0.5, 1.0]


def test_trap_index_and_count_results_are_int32():
    ints = cs._INTS
    assert _port("count_nonzero", ints).dtype == np.int32
    assert _port("searchsorted", cs._SORTED, cs._M).dtype == np.int32
    assert _port("digitize", cs._M, cs._SORTED).dtype == np.int32
    assert all(r.dtype == np.int32 for r in _port("nonzero", ints))
    assert _port("argwhere", ints).dtype == np.int32
    assert _port("bincount", np.array([0, 2, 2], np.int32)).dtype == np.int32
    uniq, *extras = _port("unique", cs._DUPS, return_index=True,
                          return_inverse=True, return_counts=True)
    assert uniq.dtype == np.float32 and all(e.dtype == np.int32
                                            for e in extras)
    counts, edges = _port("histogram", cs._M, bins=3)
    assert counts.dtype == np.int32 and edges.dtype == np.float32


def test_trap_unique_index_is_the_first_occurrence():
    x = np.array([3, 1, 3, 2, 1, 1, 2], np.int32)
    uniq, first, inverse, counts = (r.asnumpy() for r in _port(
        "unique", x, return_index=True, return_inverse=True,
        return_counts=True))
    want = np.unique(x, return_index=True, return_inverse=True,
                     return_counts=True)
    for g, w in zip((uniq, first, inverse, counts), want):
        np.testing.assert_array_equal(g, w)


def test_trap_histogram_puts_edge_values_where_numpy_does():
    x = cs._EDGES                                    # 0, 1, ..., 10
    counts, edges = (r.asnumpy() for r in _port("histogram", x, bins=5,
                                                 range=(0.0, 10.0)))
    want_counts, want_edges = np.histogram(x, bins=5, range=(0.0, 10.0))
    np.testing.assert_array_equal(counts, want_counts)   # [2, 2, 2, 2, 3]
    np.testing.assert_array_equal(edges, want_edges.astype(np.float32))
    # a value that the scale puts one bin off is corrected by the edges
    y = np.array([0.0, 0.3, 0.6, 0.9, 1.2, 1.5], np.float32)
    counts = _port("histogram", y, bins=3)[0].asnumpy()
    np.testing.assert_array_equal(counts, np.histogram(y, bins=3)[0])


def test_trap_gradient_of_several_axes_is_a_tuple():
    out = _port("gradient_op", cs._GRID)
    assert isinstance(out, tuple) and len(out) == 3
    assert not isinstance(_port("gradient_op", cs._GRID, axis=1), tuple)


def test_trap_clip_by_global_norm_gives_one_output_an_input():
    arrays = [cs._M, cs._M2 * 3, cs._V]
    out = _port("clip_by_global_norm", *arrays, max_norm=1.5)
    assert len(out) == 3 and [o.shape for o in out] == [a.shape
                                                        for a in arrays]
    single = _port("clip_by_global_norm", cs._M, max_norm=0.5)
    assert not isinstance(single, tuple)
    np.testing.assert_allclose(np.linalg.norm(single.asnumpy()), 0.5,
                               rtol=1e-6)


def test_trap_correlate_conjugates_and_defaults_to_valid():
    a, v = cs._C8, cs._C8[:3]
    got = _port("correlate", a, v).asnumpy()
    np.testing.assert_allclose(got, np.correlate(a, v), rtol=1e-5,
                               atol=1e-6)
    assert got.shape == (6,)


def test_dynamic_shape_ops_refuse_a_capture(monkeypatch):
    # on the card, inside a CUDA graph capture; mirrored with a stand-in
    # operand that says it lies on the card
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MXTPUError, match="CUDA graph capture"):
        numpy_ops._dynamic("unique", types.SimpleNamespace(is_cuda=True))
    numpy_ops._dynamic("unique", torch.zeros(3))      # a CPU operand


def test_every_numpy_op_is_registered_and_has_a_case():
    assert len(NUMPY_OPS) == 108
    assert set(NUMPY_OPS) <= set(registry.list_ops())
    for name in NUMPY_OPS:
        assert registry.get(name).differentiable == \
            jregistry.get(name).differentiable, name
        assert registry.get(name).aliases == jregistry.get(name).aliases
    covered = set()
    for case in cs.NP_CASES:
        if case.name.startswith("np:"):
            continue
        name = case.name[3:] if case.name.startswith("op:") else \
            cs._nd_fn(mx, case.name).__name__
        covered.add(registry.get(name).name)
    assert set(NUMPY_OPS) <= covered, sorted(set(NUMPY_OPS) - covered)


def test_mx_nd_has_every_numpy_wrapper_of_the_reference():
    names = [n for n in dir(jmx.nd) if registry.get(n) is not None
             and registry.get(n).fn.__module__.endswith(
                 ("numpy_ops", "fft_ops", "ops.linalg"))]
    assert len(names) > 150
    assert [n for n in names if not hasattr(mx.nd, n)] == []
