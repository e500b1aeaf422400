"""``mx.nd``: the imperative NDArray op namespace.

Counterpart of the JAX package's ``ndarray/__init__.py`` for the ops the
port has: wrappers generated from the op registry (``ops/tensor.py``,
``ops/nn.py``, ``ops/misc.py``, ``ops/random_ops.py``, ``ops/more.py``,
``ops/optimizer_ops.py``, ``ops/numpy_ops.py``, ``ops/fft_ops.py``,
``ops/linalg.py``, and the kernel ops
``flash_attention``/``fused_conv_bn``), every call through :func:`invoke`,
so autograd recording and the naive engine's sync apply alike. The
submodules ``mx.nd.random`` (the samplers, drawing on ``ctx=``),
``mx.nd.image``, ``mx.nd.contrib``, ``mx.nd.linalg`` and ``mx.nd.sparse``
(row_sparse and csr storage) hold the names the reference puts there;
the update ops write back with the reference's in-place rule.
``mx.nd.flash_attention`` launches the flash kernels on a CUDA array;
``invoke_op("fused_conv_bn", ...)`` the conv kernels; ``mx.nd.Custom``
runs a registered ``mx.operator`` op. The MXNet 1.x spellings the
reference keeps (``Concat``, ``SliceChannel``, ``SequenceMask``, ...) name
the same wrappers.
"""

from __future__ import annotations

import sys as _sys
from types import ModuleType as _ModuleType

from ..ops import detection as _detection  # noqa: F401  (registers ops)
from ..ops import fft_ops as _fft_ops  # noqa: F401
from ..ops import flash_attention as _flash  # noqa: F401
from ..ops import fused_conv as _fused_conv  # noqa: F401
from ..ops import linalg as _linalg  # noqa: F401
from ..ops import misc as _misc  # noqa: F401
from ..ops import more as _more  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import numpy_ops as _numpy_ops  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import random_ops as _random_ops  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _tensor  # noqa: F401
from .ndarray import (NDArray, arange, array, as_nd, empty, eye, full,
                      invoke, invoke_op, load, ones, save, waitall, zeros)
from . import sparse
from .sparse import (BaseSparseNDArray, CSRNDArray, RowSparseNDArray,
                     cast_storage)

_this = _sys.modules[__name__]


def _wrap(name, narr, variadic=False):
    """``mx.nd.<name>``: the first ``narr`` arguments are arrays (every
    positional argument where ``variadic``), options are keywords."""
    opdef = _registry.get(name)
    assert opdef is not None, name

    def op(*args, **kwargs):
        if not variadic and len(args) > narr:
            raise TypeError(f"{name} takes {narr} array arguments; pass "
                            "options as keywords")
        return invoke(opdef.fn, args, kwargs, name=opdef.name,
                      differentiable=opdef.differentiable,
                      needs_rng=opdef.needs_rng)

    op.__name__ = name
    op.__doc__ = opdef.doc
    return op


_UNARY = [
    "abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "square", "sqrt",
    "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10", "log2", "log1p",
    "expm1", "reciprocal", "negative", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "erf", "erfinv", "gamma", "gammaln", "digamma", "clip",
    "isnan", "isinf", "isfinite", "sum", "sum_axis", "mean", "prod",
    "nansum", "nanprod", "max", "max_axis", "min", "min_axis", "argmax",
    "argmin", "norm", "cumsum", "logsumexp", "reshape", "transpose",
    "expand_dims", "squeeze", "flip", "reverse", "tile", "repeat", "pad",
    "depth_to_space", "space_to_depth", "split", "sort", "argsort", "topk",
    "cast", "zeros_like", "ones_like", "shape_array", "size_array", "diag",
    "broadcast_axis", "broadcast_axes", "broadcast_to", "softmax",
    "log_softmax", "relu", "sigmoid", "softsign", "softrelu", "gelu",
    "silu", "mish", "hard_sigmoid", "Activation", "activation",
    "l2_normalization", "L2Normalization", "adaptive_avg_pool2d",
    # ops/misc.py
    "degrees", "radians", "round", "logical_not", "erfc", "log_sigmoid",
    "index_array", "moments", "UpSampling", "BilinearResize2D",
    "GridGenerator", "MakeLoss", "make_loss", "Pooling", "Pooling_v1"]
_BINARY = [
    "elemwise_add", "broadcast_add", "add", "elemwise_sub", "broadcast_sub",
    "subtract", "elemwise_mul", "broadcast_mul", "multiply", "elemwise_div",
    "broadcast_div", "divide", "broadcast_power", "power",
    "broadcast_maximum", "maximum", "broadcast_minimum", "minimum",
    "broadcast_mod", "mod", "broadcast_hypot", "broadcast_equal", "equal",
    "broadcast_not_equal", "not_equal", "broadcast_greater", "greater",
    "broadcast_greater_equal", "greater_equal", "broadcast_lesser", "lesser",
    "broadcast_lesser_equal", "lesser_equal", "broadcast_logical_and",
    "logical_and", "broadcast_logical_or", "logical_or",
    "broadcast_logical_xor", "logical_xor", "broadcast_minus",
    "broadcast_plus", "dot", "batch_dot", "matmul", "linalg_gemm2", "take",
    "pick", "gather_nd", "boolean_mask", "slice_like", "sequence_mask",
    "sequence_last", "sequence_reverse", "Embedding", "embedding",
    "softmax_cross_entropy", "SoftmaxOutput", "softmax_output",
    # ops/misc.py
    "batch_take", "BilinearSampler", "SpatialTransformer", "ROIPooling",
    "ROIAlign", "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput"]
_TERNARY = ["where", "scatter_nd"]
_VARIADIC = ["concat", "concatenate", "stack", "khatri_rao"]
# ops/numpy_ops.py and ops/fft_ops.py (the reference's numpy-parity and
# fft/complex waves)
_UNARY += [
    "exp2", "signbit", "sinc", "i0", "fabs", "invert", "bitwise_not",
    "std", "var", "average", "median", "quantile", "percentile", "ptp",
    "nanmax", "nanmin", "nanmean", "nanstd", "nanvar", "nanargmax",
    "nanargmin", "nancumsum", "nancumprod", "cumprod", "count_nonzero",
    "roll", "rot90", "tril", "triu", "trace_op", "trace", "flipud",
    "fliplr", "moveaxis", "rollaxis", "diff", "ediff1d", "resize_op",
    "np_resize", "vander", "unique", "nonzero", "flatnonzero", "argwhere",
    "bincount", "histogram", "partition_op", "np_partition",
    "argpartition", "atleast_2d", "atleast_3d", "lexsort",
    "relu6", "hard_swish", "hardswish", "cov", "corrcoef", "nanmedian",
    "nanquantile", "nanpercentile", "unwrap", "gradient_op", "np_gradient",
    "packbits", "unpackbits",
    "fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn", "ifftn",
    "fftshift", "ifftshift", "real", "imag", "conj", "angle",
    "linalg_norm", "linalg_cholesky", "linalg_eigvalsh", "linalg_pinv",
    "linalg_matrix_rank", "linalg_matrix_power", "linalg_cond"]
_BINARY += [
    "logaddexp", "logaddexp2", "copysign", "heaviside", "ldexp",
    "float_power", "fmod", "nextafter", "floor_divide", "bitwise_and",
    "bitwise_or", "bitwise_xor", "left_shift", "right_shift", "allclose",
    "isclose", "array_equal", "kron", "outer", "inner", "vdot",
    "tensordot", "cross", "polyval", "trapz", "convolve", "correlate",
    "searchsorted", "digitize", "setdiff1d", "intersect1d", "union1d",
    "isin", "linalg_solve", "linalg_tensorsolve", "take_along_axis",
    "fmax", "fmin", "compress_op", "np_compress", "extract", "select"]
_TERNARY += ["interp", "put_along_axis"]
_VARIADIC += ["hstack", "vstack", "dstack", "column_stack", "meshgrid",
              "broadcast_arrays", "einsum", "clip_by_global_norm"]
for _n in _UNARY:
    setattr(_this, _n, _wrap(_n, 1))
for _n in _BINARY:
    setattr(_this, _n, _wrap(_n, 2))
for _n in _TERNARY:
    setattr(_this, _n, _wrap(_n, 3))
for _n in _VARIADIC:
    setattr(_this, _n, _wrap(_n, 0, variadic=True))

#: q, k, v positional; ``lengths`` (an NDArray), ``scale``, ``causal`` and
#: ``cache_offset`` as keywords (the JAX op's contract)
flash_attention = _wrap("flash_attention", 3)
#: (data, gamma, beta, moving_mean, moving_var); options as keywords
BatchNorm = _wrap("BatchNorm", 5)
BatchNorm_v1 = _wrap("BatchNorm_v1", 5)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    from ..base import resolve_dtype

    return invoke_op("one_hot", indices, depth=depth, on_value=on_value,
                     off_value=off_value, dtype=resolve_dtype(dtype))


def _with_bias(name):
    """``mx.nd.<name>(data, weight, bias=None, **options)``: no bias sets
    ``no_bias``."""
    def op(data, weight, bias=None, **kwargs):
        args = [data, weight] + ([bias] if bias is not None else [])
        if bias is None:
            kwargs["no_bias"] = True
        return invoke_op(name, *args, **kwargs)

    op.__name__ = name
    return op


FullyConnected = _with_bias("FullyConnected")
Convolution = _with_bias("Convolution")
Deconvolution = _with_bias("Deconvolution")


def LayerNorm(data, gamma, beta, **kwargs):
    return invoke_op("LayerNorm", data, gamma, beta, **kwargs)


def GroupNorm(data, gamma, beta, **kwargs):
    return invoke_op("GroupNorm", data, gamma, beta, **kwargs)


def InstanceNorm(data, gamma, beta, **kwargs):
    return invoke_op("InstanceNorm", data, gamma, beta, **kwargs)


def rms_norm(data, gamma, **kwargs):
    return invoke_op("RMSNorm", data, gamma, **kwargs)


def Dropout(data, p=0.5, **kwargs):
    """Dropout of rate ``p``; ``training`` defaults to
    ``autograd.is_training()`` (on inside ``autograd.record()``)."""
    from .. import autograd

    kwargs.setdefault("training", autograd.is_training())
    return invoke_op("Dropout", data, p=p, **kwargs)


def LeakyReLU(data, gamma=None, **kwargs):
    """``gamma`` (an array) is read by ``act_type="prelu"`` alone."""
    if kwargs.get("act_type") == "prelu" and gamma is not None:
        return invoke_op("LeakyReLU", data, gamma, **kwargs)
    return invoke_op("LeakyReLU", data, **kwargs)


def scaled_dot_product_attention(q, k, v, mask=None, **kwargs):
    """The dense attention chain (``ops.nn.scaled_dot_product_attention``):
    q, k, v and an optional ``mask`` are arrays; ``scale`` and ``causal``
    keywords."""
    args = [q, k, v] + ([mask] if mask is not None else [])
    return invoke_op("scaled_dot_product_attention", *args, **kwargs)


def ravel_multi_index(data, shape):
    return invoke_op("ravel_multi_index", data, shape=tuple(shape))


def unravel_index(data, shape):
    return invoke_op("unravel_index", data, shape=tuple(shape))


def slice(data, begin, end, step=None):  # noqa: A001 (mxnet name)
    return data.slice(begin, end, step)


def slice_axis(data, axis, begin, end):
    return data.slice_axis(axis, begin, end)


def swapaxes(data, dim1, dim2):
    return data.swapaxes(dim1, dim2)


def flatten(data):
    return data.flatten()


def stop_gradient(data):
    return data.detach()


def SoftmaxActivation(data, mode="instance"):
    """The deprecated reference op: softmax over the channels (axis 1,
    ``mode="channel"``) or each instance's last axis."""
    return softmax(data, axis=1 if mode == "channel" else -1)  # noqa: F821


def Custom(*data, op_type=None, **kwargs):
    """Invoke a registered custom op (reference ``mx.nd.Custom`` over
    ``mx.operator.register``)."""
    from ..operator import invoke_custom

    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return invoke_custom(op_type, list(data), kwargs)


# the reference's MXNet 1.x spellings
BlockGrad = block_grad = stop_gradient
Cast = _this.cast
Concat = _this.concat
Flatten = flatten
Pad = _this.pad
Reshape = _this.reshape
SequenceLast = _this.sequence_last
SequenceMask = _this.sequence_mask
SequenceReverse = _this.sequence_reverse
SliceChannel = slice_channel = _this.split
SwapAxis = swapaxes

# ---------------------------------------------------------------------------
# mx.nd.random: the samplers (ops/random_ops.py)
# ---------------------------------------------------------------------------
random = _ModuleType(__name__ + ".random")

#: the positional order of each sampler's parameters
_SAMPLER_ARGS = {
    "uniform": ("low", "high", "shape"),
    "normal": ("loc", "scale", "shape"),
    "gamma_sample": ("alpha", "beta", "shape"),
    "exponential": ("lam", "shape"),
    "poisson": ("lam", "shape"),
    "randint": ("low", "high", "shape"),
    "bernoulli": ("prob", "shape"),
}


def _wrap_sampler(name):
    """``mx.nd.random.<name>(*params, shape=..., dtype=..., ctx=None)``:
    the draws are made on ``ctx`` (the default context if None) by its
    generator."""
    opdef = _registry.get(name)

    def op(*args, ctx=None, **kwargs):
        kwargs = dict(zip(_SAMPLER_ARGS[name], args)) | kwargs
        return invoke(opdef.fn, [], kwargs, name=opdef.name,
                      differentiable=False, needs_rng=True, ctx=ctx)

    op.__name__ = name
    op.__doc__ = opdef.doc
    return op


for _n in _SAMPLER_ARGS:
    setattr(random, _n.replace("_sample", ""), _wrap_sampler(_n))


def _multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Category draws from each row of ``data`` (..., k):
    ``data.shape[:-1] + shape``."""
    return invoke_op("sample_multinomial", data, shape=shape,
                     get_prob=get_prob, dtype=dtype)


def _shuffle(data):
    """``data`` with its rows (axis 0) permuted."""
    return invoke_op("shuffle", data)


random.multinomial = random.categorical = _multinomial
random.shuffle = shuffle = _shuffle
_sys.modules[random.__name__] = random
uniform = random_uniform = random.uniform
normal = random_normal = random.normal
sample_multinomial = random.multinomial


# ---------------------------------------------------------------------------
# the update ops (ops/optimizer_ops.py)
# ---------------------------------------------------------------------------
def _wrap_update(name, narr, n_state):
    """``mx.nd.<name>(*arrays, out=None, **options)`` with the reference's
    in-place rule: the first ``narr`` arguments are arrays; the new weight
    is returned, and written into ``out`` (its own tensor) only when
    ``out=`` is given; the trailing ``n_state`` arrays (momentum, mean,
    var, ...) are always written with their new values."""
    opdef = _registry.get(name)

    def op(*args, out=None, **kwargs):
        arrays = list(args[:narr])
        res = invoke(opdef.fn, arrays, kwargs, name=opdef.name,
                     differentiable=False)
        outs = list(res) if isinstance(res, tuple) else [res]
        if out is not None:
            out._write(outs[0])
        for new, state in zip(outs[1:], arrays[narr - n_state:]):
            state._write(new)
        return res

    op.__name__ = name
    op.__doc__ = opdef.doc
    return op


for _n, _k, _s in [("sgd_update", 2, 0), ("sgd_mom_update", 3, 1),
                   ("mp_sgd_update", 3, 1), ("mp_sgd_mom_update", 4, 2),
                   ("nag_mom_update", 3, 1), ("adam_update", 4, 2),
                   ("adamw_update", 4, 2), ("rmsprop_update", 3, 1),
                   ("rmspropalex_update", 5, 3), ("ftrl_update", 4, 2),
                   ("signsgd_update", 2, 0), ("signum_update", 3, 1),
                   ("ftml_update", 5, 3), ("mp_nag_mom_update", 4, 2)]:
    setattr(_this, _n, _wrap_update(_n, _k, _s))


def reset_arrays(*arrays, num_arrays=None):
    """Zero the arrays in place (the reference calls it for that); returns
    the zeros."""
    outs = invoke_op("reset_arrays", *arrays, num_arrays=num_arrays)
    outs = outs if isinstance(outs, tuple) else (outs,)
    for a, z in zip(arrays, outs):
        a._write(z)
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# ops/more.py, the samplers' pdfs and the AMP ops
# ---------------------------------------------------------------------------
_MORE = [
    ("lamb_update_phase1", 4), ("lamb_update_phase2", 4), ("amp_cast", 1),
    ("all_finite", 1), ("LRN", 1), ("softmin", 1), ("masked_softmax", 2),
    ("masked_log_softmax", 2), ("identity", 1), ("argmax_channel", 1),
    ("im2col", 1), ("col2im", 1), ("Correlation", 2),
    ("stop_gradient_op", 1),
    # the per-parameter samplers: mx.nd.sample_uniform(low, high, shape=..)
    ("sample_uniform", 2), ("sample_normal", 2), ("sample_gamma", 2),
    ("sample_exponential", 1), ("sample_poisson", 1),
    ("sample_negative_binomial", 2),
    ("interleaved_matmul_selfatt_qk", 1),
    ("interleaved_matmul_selfatt_valatt", 2),
    ("interleaved_matmul_encdec_qk", 2),
    ("interleaved_matmul_encdec_valatt", 2), ("arange_like", 1),
    ("broadcast_like", 2), ("reshape_like", 2), ("nan_to_num", 1),
    ("choose_element_0index", 2), ("fill_element_0index", 3),
    ("index_copy", 3), ("SVMOutput", 2), ("sparse_retain_rows", 2),
    # two-parameter pdfs take (sample, p1, p2), one-parameter (sample, p1)
    ("random_pdf_uniform", 3), ("random_pdf_normal", 3),
    ("random_pdf_gamma", 3), ("random_pdf_negative_binomial", 3),
    ("random_pdf_generalized_negative_binomial", 3),
    ("random_pdf_exponential", 2), ("random_pdf_poisson", 2),
    ("random_pdf_dirichlet", 2)]
_MORE_VARIADIC = ["add_n", "ElementWiseSum", "multi_sgd_update",
                  "multi_sgd_mom_update", "amp_multicast",
                  "multi_all_finite", "multi_sum_sq"]
for _n, _k in _MORE:
    setattr(_this, _n, _wrap(_n, _k))
for _n in _MORE_VARIADIC:
    setattr(_this, _n, _wrap(_n, 0, variadic=True))


def ctc_loss(data, label, data_lengths=None, label_lengths=None, **kwargs):
    """CTC loss per sample: ``data`` (T, N, C), ``label`` (N, L) padded
    with -1; ``data_lengths``/``label_lengths`` (N,) set
    ``use_data_lengths``/``use_label_lengths``."""
    def fn(d, lab, *lengths, **kw):
        dl = lengths[0] if data_lengths is not None else None
        ll = lengths[-1] if label_lengths is not None else None
        return _registry.get("CTCLoss").fn(d, lab, dl, ll, **kw)

    args = [data, label]
    if data_lengths is not None:
        args.append(data_lengths)
        kwargs.setdefault("use_data_lengths", True)
    if label_lengths is not None:
        args.append(label_lengths)
        kwargs.setdefault("use_label_lengths", True)
    return invoke(fn, args, kwargs, name="CTCLoss")


CTCLoss = ctc_loss


def DeformableConvolution(data, offset, weight, bias=None, **kwargs):
    """(data, offset, weight[, bias]); no bias sets ``no_bias``."""
    args = [data, offset, weight] + ([bias] if bias is not None else [])
    if bias is None:
        kwargs["no_bias"] = True
    return invoke_op("DeformableConvolution", *args, **kwargs)


def Crop(data, shape_like=None, **kwargs):
    """``data`` cut to ``shape_like``'s H, W, or to ``h_w``."""
    args = [data] + ([shape_like] if shape_like is not None else [])
    return invoke_op("Crop", *args, **kwargs)


# ---------------------------------------------------------------------------
# mx.nd.linalg (ops/linalg.py and linalg_gemm2): each also as
# mx.nd.linalg_<name>
# ---------------------------------------------------------------------------
linalg = _ModuleType(__name__ + ".linalg")
for _n, _k in [("linalg_gemm", 3), ("linalg_gemm2", 2), ("linalg_syrk", 1),
               ("linalg_potrf", 1), ("linalg_potri", 1), ("linalg_trmm", 2),
               ("linalg_trsm", 2), ("linalg_sumlogdiag", 1),
               ("linalg_gelqf", 1), ("linalg_syevd", 1),
               ("linalg_inverse", 1), ("linalg_det", 1),
               ("linalg_slogdet", 1), ("linalg_extractdiag", 1),
               ("linalg_makediag", 1), ("linalg_extracttrian", 1),
               ("linalg_maketrian", 1)]:
    _w = _wrap(_n, _k)
    setattr(_this, _n, _w)
    setattr(linalg, _n.replace("linalg_", ""), _w)
_sys.modules[linalg.__name__] = linalg
_LINALG = [n for n in dir(linalg) if not n.startswith("_")]

# ---------------------------------------------------------------------------
# mx.nd.image and mx.nd.contrib
# ---------------------------------------------------------------------------
image = _ModuleType(__name__ + ".image")
for _n in ("image_to_tensor", "image_normalize", "image_resize",
           "image_crop", "image_flip_left_right", "image_flip_top_bottom",
           "image_random_flip_left_right"):
    setattr(image, _n.replace("image_", ""), _wrap(_n, 1))
_sys.modules[image.__name__] = image

smooth_l1 = _wrap("smooth_l1", 1)
contrib = _ModuleType(__name__ + ".contrib")
# ops/detection.py: the bounding-box and MultiBox ops, the RPN proposals
# and the PS/rotated ROI pooling, under the reference's contrib names
for _n, _k in [("box_iou", 2), ("box_nms", 1), ("box_decode", 2),
               ("box_encode", 4), ("bipartite_matching", 1),
               ("multibox_prior", 1), ("multibox_target", 3),
               ("multibox_detection", 3), ("Proposal", 3),
               ("MultiProposal", 3), ("PSROIPooling", 2),
               ("DeformablePSROIPooling", 3), ("RROIAlign", 2)]:
    setattr(contrib, _n, _wrap(_n, _k))
contrib.box_non_maximum_suppression = contrib.box_nms
contrib.MultiBoxPrior = contrib.multibox_prior
contrib.MultiBoxTarget = contrib.multibox_target
contrib.MultiBoxDetection = contrib.multibox_detection
for _n, _k in [("div_sqrt_dim", 1), ("quadratic", 1),
               ("gradientmultiplier", 1), ("AdaptiveAvgPooling2D", 1),
               ("BatchNormWithReLU", 5), ("requantize", 3)]:
    setattr(contrib, _n, _wrap(_n, _k))
contrib.BilinearResize2D = _this.BilinearResize2D
contrib.DeformableConvolution = DeformableConvolution
contrib.ROIAlign = _this.ROIAlign
contrib.SparseEmbedding = _this.Embedding
contrib.arange_like = _this.arange_like
contrib.ctc_loss = ctc_loss
contrib.index_array = _this.index_array
contrib.index_copy = _this.index_copy
from ..contrib import control_flow as _control_flow  # noqa: E402

contrib.foreach = _control_flow.foreach
contrib.while_loop = _control_flow.while_loop
contrib.cond = _control_flow.cond
_sys.modules[contrib.__name__] = contrib


__all__ = ["BatchNorm", "BatchNorm_v1", "BlockGrad", "Cast", "Concat",
           "Convolution", "Custom", "Deconvolution", "Dropout", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "NDArray", "Pad", "Reshape", "SequenceLast",
           "SequenceMask", "SequenceReverse", "SliceChannel",
           "SoftmaxActivation", "SwapAxis", "arange", "array", "as_nd",
           "block_grad", "empty", "eye", "flash_attention", "flatten",
           "full", "invoke", "invoke_op", "load", "one_hot", "ones",
           "ravel_multi_index", "rms_norm", "save",
           "scaled_dot_product_attention", "slice", "slice_axis",
           "slice_channel", "stop_gradient", "swapaxes", "unravel_index",
           "waitall", "zeros", "random", "uniform", "normal",
           "random_uniform", "random_normal", "sample_multinomial",
           "shuffle", "reset_arrays", "ctc_loss", "CTCLoss",
           "DeformableConvolution", "Crop", "image", "contrib", "smooth_l1",
           "sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "nag_mom_update", "adam_update",
           "adamw_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "signsgd_update", "signum_update", "ftml_update",
           "mp_nag_mom_update", "linalg", "sparse", "cast_storage",
           "BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray"] \
    + _UNARY + _BINARY + _TERNARY \
    + _VARIADIC + [n for n, _ in _MORE] + _MORE_VARIADIC \
    + [f"linalg_{n}" for n in _LINALG]
