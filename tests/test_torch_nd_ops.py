"""Port parity: the everyday ``mx.nd`` ops.

The ops of the JAX package's ``ops/tensor.py``, ``ops/nn.py`` and
``ops/misc.py`` and the legacy names of its ``ops/more.py`` alias block,
through their ``mx.nd`` wrappers. Every case of ``chip_smoke.ND_CASES``
(numpy inputs drawn from a seed, the table ``chip_smoke.py`` also runs on
the card against the port on the CPU) goes through the JAX package's
``mx.nd`` and the port's, the port on the CPU, with the gradient of
``sum(out * w)`` where the case names inputs to differentiate. Tolerances:
``chip_smoke.ND_TOL`` (1e-5 relative, 1e-6 absolute: fp32 in another order
of operations); ``ND_LOOSE`` (1e-4, 1e-5) where a case states it, for the
special functions (each library's own series), GroupNorm and the
(transposed) convolutions (sums over windows); indices, ties, the index ops
and the sequence ops bit for bit. Each trap where the reference's answer is
not PyTorch's default (or not MXNet's) is a case of its own, and
``test_trap_gives_the_reference_result`` pins its values.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import misc as jmisc
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
CASES = {c.id: c for c in cs.ND_CASES}

# the slice's ops: the port's registry held 83 before it
SLICE_OPS = [
    "BatchNorm_v1", "BilinearResize2D", "BilinearSampler", "Convolution_v1",
    "Deconvolution", "Dropout", "Embedding", "GridGenerator", "GroupNorm",
    "InstanceNorm", "L2Normalization", "LayerNorm", "LeakyReLU",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "Pooling_v1", "RMSNorm", "ROIAlign", "ROIPooling",
    "Softmax", "SoftmaxOutput", "SparseEmbedding", "SpatialTransformer",
    "UpSampling", "adaptive_avg_pool2d", "arccos", "arccosh", "arcsin",
    "arcsinh", "arctan", "arctanh", "argsort", "batch_take", "boolean_mask",
    "broadcast_axis", "broadcast_minus", "broadcast_plus", "cbrt", "ceil",
    "concat", "contrib_SparseEmbedding", "cos", "cosh", "degrees",
    "depth_to_space", "diag", "digamma", "erf", "erfc", "erfinv", "expm1",
    "fix", "flip", "floor", "gamma", "gammaln", "gather_nd", "gelu",
    "hard_sigmoid", "index_array", "isfinite", "isinf", "isnan",
    "khatri_rao", "linalg_gemm2", "log10", "log1p", "log2", "log_sigmoid",
    "logical_not", "make_loss", "matmul", "mish", "moments", "ones_like",
    "pad", "radians", "ravel_multi_index", "rcbrt", "reciprocal", "repeat",
    "rint", "round", "rsqrt", "scatter_nd", "sequence_last", "sequence_mask",
    "sequence_reverse", "shape_array", "silu", "sin", "sinh", "size_array",
    "slice_like", "softmax_cross_entropy", "softrelu", "softsign", "sort",
    "space_to_depth", "split", "stack", "tan", "tile", "topk", "trunc",
    "unravel_index", "where", "zeros_like"]

# the names of the reference's mx.nd that this slice's ops back
SLICE_ND_NAMES = [
    "BatchNorm_v1", "BilinearResize2D", "BilinearSampler", "Concat",
    "Deconvolution", "Dropout", "Embedding", "GridGenerator", "GroupNorm",
    "InstanceNorm", "L2Normalization", "LayerNorm", "LeakyReLU",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "Pad", "Pooling_v1", "ROIAlign",
    "ROIPooling", "SequenceLast", "SequenceMask", "SequenceReverse",
    "SliceChannel", "SoftmaxActivation", "SoftmaxOutput",
    "SpatialTransformer", "UpSampling", "activation", "adaptive_avg_pool2d",
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh", "argsort",
    "batch_take", "block_grad", "boolean_mask", "broadcast_axes",
    "broadcast_axis", "broadcast_minus", "broadcast_plus", "cbrt", "ceil",
    "concat", "concatenate", "cos", "cosh", "degrees", "depth_to_space",
    "diag", "digamma", "embedding", "erf", "erfc", "erfinv", "expm1", "fix",
    "flip", "floor", "gamma", "gammaln", "gather_nd", "gelu", "hard_sigmoid",
    "index_array", "isfinite", "isinf", "isnan", "khatri_rao",
    "l2_normalization", "linalg_gemm2", "log10", "log1p", "log2",
    "log_sigmoid", "logical_not", "make_loss", "matmul", "mish", "moments",
    "ones_like", "pad", "radians", "ravel_multi_index", "rcbrt",
    "reciprocal", "repeat", "reverse", "rint", "rms_norm", "round", "rsqrt",
    "scatter_nd", "sequence_last", "sequence_mask", "sequence_reverse",
    "shape_array", "silu", "sin", "sinh", "size_array", "slice_channel",
    "slice_like", "softmax_cross_entropy", "softmax_output", "softrelu",
    "softsign", "sort", "space_to_depth", "split", "stack", "tan", "tile",
    "topk", "trunc", "unravel_index", "where", "zeros_like"]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _misc_make_loss(*arrays, **kwargs):
    return jmx.nd.invoke(jmisc.make_loss, arrays, kwargs, name="make_loss")


# ``make_loss`` with ``normalization`` is held against ops/misc.py's op:
# the JAX package's mx.nd.make_loss is ops/more.py's, which reads
# grad_scale alone
_JAX_MISC = types.SimpleNamespace(
    nd=types.SimpleNamespace(**{n: getattr(jmx.nd, n) for n in dir(jmx.nd)
                                if not n.startswith("__")}
                             | {"make_loss": _misc_make_loss}),
    autograd=jmx.autograd)
_BY_MISC_OP = ("make_loss_batch", "make_loss_valid")


def _reference(case):
    pkg = _JAX_MISC if case.id in _BY_MISC_OP else jmx
    return cs.run_nd_case(pkg, case, raw_array_kwargs=True)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_slice_op_matches_jax(case):
    cs.check_nd_case(case, cs.run_nd_case(mx, case), _reference(case))


# case id -> the reference's result (its first output), pinned
TRAPS = {
    "argsort_descending_ties": [4, 2, 1, 3, 0],
    "topk_ties": [1, 2],
    "topk_ties_ascending": [0, 3],
    "gamma_loses_the_sign": [3.5449077, 2.3632718, 1.3293404],
    "digamma_at_0_is_nan": [np.nan, -0.5772157, 0.7031566],
    "rint_half_to_even": [0, 2, 2, -0, -2, -2],
    "round_half_to_even": [0, 2, 2, -0, -2, -2],
    "norm_two_axes": [0.8266, 2.2403, 3.7144],
}


@pytest.mark.parametrize("case_id", list(TRAPS))
def test_trap_gives_the_reference_result(case_id):
    case = CASES[case_id]
    want = np.asarray(TRAPS[case_id], np.float32)
    for got in (cs.run_nd_case(mx, case)[0], _reference(case)[0]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_trap_scatter_nd_last_write_wins():
    case = CASES["scatter_nd_repeated"]
    data = case.arrays[0]
    for out in (cs.run_nd_case(mx, case), _reference(case)):
        np.testing.assert_array_equal(out[0][0, 1], data[2])
        # the overwritten write gets no gradient, the out-of-range one none
        np.testing.assert_array_equal(out[1][[0, 4]], 0)


def test_trap_logical_not_of_ints_is_float32():
    got = cs.run_nd_case(mx, CASES["logical_not_int"])[0]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [1, 0, 0, 1])


def test_trap_deconvolution_adj_at_the_stride():
    assert cs.run_nd_case(mx, CASES["Deconvolution_adj_at_stride"])[
        0].shape == (1, 1, 11, 11)


def test_leaky_relu_refuses_an_unknown_act_type():
    for pkg in (mx, jmx):
        with pytest.raises(ValueError):
            pkg.nd.LeakyReLU(pkg.nd.array(np.ones(3, np.float32)),
                             act_type="rrelu")


def test_dropout_by_its_statistics():
    assert abs(cs.nd_dropout_checks(mx, mx.cpu()) - 0.7) < 0.01


def test_every_slice_op_is_registered_and_has_a_case():
    ops = set(registry.list_ops())
    assert len(SLICE_OPS) == len(set(SLICE_OPS)) == 109
    assert set(SLICE_OPS) <= ops
    assert set(SLICE_OPS) <= set(jregistry.list_ops())
    covered = {"Dropout"}                     # test_dropout_by_its_statistics
    for case in CASES.values():
        name = case.name[3:] if case.name.startswith("op:") else \
            getattr(mx.nd, case.name).__name__
        if registry.get(name) is not None:
            covered.add(registry.get(name).name)
    assert set(SLICE_OPS) <= covered, sorted(set(SLICE_OPS) - covered)


def test_mx_nd_has_every_name_the_slice_backs():
    assert set(SLICE_ND_NAMES) <= set(dir(jmx.nd))
    assert [n for n in SLICE_ND_NAMES if not hasattr(mx.nd, n)] == []
    # every name has a case of its own, but Dropout (held by its
    # statistics) and block_grad (stop_gradient's spelling)
    assert set(SLICE_ND_NAMES) - {c.name for c in CASES.values()} == {
        "Dropout", "block_grad"}
    assert mx.nd.block_grad is mx.nd.BlockGrad is mx.nd.stop_gradient
