"""The CUDA kernels that ``mx.rtc`` launches on the imperative path, and
their plain PyTorch versions.

The JAX package's runtime kernel surface (``rtc.py:66``
``PallasKernel._launch_fn``) launches Pallas functions; on the card
``mx.rtc.CudaModule`` compiles CUDA source with NVRTC instead. The sources
live in ``csrc/rtc/`` and compile at the first call that needs them:

* ``scale``, ``saxpy``, ``first_row``: the counterparts of the Pallas
  kernels of the JAX package's ``tests/test_rtc.py``;
* ``softmax_ce_fwd`` / ``softmax_ce_bwd``: the pair of upstream MXNet's
  ``example/numpy-ops/custom_softmax_rtc.py``, behind the custom op
  ``"softmax_ce_rtc"`` (``mx.nd.Custom(logits, labels,
  op_type="softmax_ce_rtc")``): the forward gives the row softmax of fp32
  logits ``(N, V)``, the backward ``y - onehot(label)`` for int32 labels
  ``(N,)``, the gradient of the summed cross entropy (the op is a loss
  layer: ``need_top_grad=False``, the head gradient is not used).

Each wrapper takes NDArrays. An array on the CPU takes the plain version
(``*_reference``, over tensors); an array on the card launches the kernel
through ``CudaKernel.launch`` (counted in ``mx.rtc.launches`` under the
kernel's name) or raises. Three launches are planned by pure functions:
``scale_plan`` and ``saxpy_plan`` (one 1024-float tile a block) and
``softmax_ce_fwd_plan`` (a row held in shared memory when the card's
opt-in limit allows it, else streamed).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from .. import operator
from ..ndarray.ndarray import NDArray
from . import _nvrtc

__all__ = ["KERNELS", "SoftmaxPlan", "first_row", "first_row_reference",
           "kernel", "saxpy", "saxpy_plan", "saxpy_reference", "scale",
           "scale_plan",
           "scale_reference", "smem_optin", "softmax_ce_bwd",
           "softmax_ce_bwd_reference", "softmax_ce_fwd", "softmax_ce_fwd_plan",
           "softmax_ce_fwd_reference"]

RTC_SRC = Path(__file__).resolve().parent.parent / "csrc" / "rtc"


class _Spec(NamedTuple):
    source: str                          # csrc/rtc/<source>.cu
    lookup: str                          # the name get_kernel is given
    signature: str
    options: tuple = ()
    exports: tuple = ()


#: kernel -> where it comes from and its MXNet signature
KERNELS: Dict[str, _Spec] = {
    "scale": _Spec("scale", "scale", "const float *x, float *y, "
                   "float factor, int n"),
    "saxpy": _Spec("saxpy", "saxpy", "const float *a, const float *b, "
                   "float *out, float alpha, int n",
                   options=("--fmad=false",)),
    "first_row": _Spec("first_row", "first_row",
                       "const float *x, float *out, int cols"),
    "softmax_ce_fwd": _Spec(
        "softmax_ce", "softmax_ce_fwd<float>",
        "const float *x, float *y, int row_size, int req",
        exports=("softmax_ce_fwd<float>", "softmax_ce_bwd<float>")),
    "softmax_ce_bwd": _Spec(
        "softmax_ce", "softmax_ce_bwd<float>",
        "const int *label, const float *y, float *dx, int row_size, int req",
        exports=("softmax_ce_fwd<float>", "softmax_ce_bwd<float>")),
}
#: MXNet's req codes in the kernels
_REQ = {"null": 0, "write": 1, "inplace": 1, "add": 2}
#: threads per block
_THREADS = 256
_ROW_THREADS = 1024
#: softmax_ce.cu: its static shared memory (32 reduction slots and
#: ROW_CHUNKS mbarriers, bytes), and the threads of a block over a
#: streamed row
_ROW_STATIC = 32 * 4 + 8 * 8
_STREAM_THREADS = 512

_modules: dict = {}
_kernels: dict = {}
_assign = operator.CustomOp().assign      # MXNet's req semantics


def kernel(name: str):
    """The ``CudaKernel`` of ``name`` (compiled at first use)."""
    k = _kernels.get(name)
    if k is None:
        from ..rtc import CudaModule

        spec = KERNELS[name]
        key = (spec.source, spec.options, spec.exports)
        mod = _modules.get(key)
        if mod is None:
            mod = CudaModule((RTC_SRC / f"{spec.source}.cu").read_text(),
                             options=spec.options, exports=spec.exports)
            _modules[key] = mod
        k = _kernels[name] = mod.get_kernel(spec.lookup, spec.signature)
    return k


def scale_plan(n: int):
    """``scale``'s grid and block over ``n`` floats: 256 threads a block,
    one tile of 1024 floats a block (a 16-byte quad a thread, or four
    floats when x and y sit at two alignment phases). A grid of one wave
    of resident blocks, looping over the tiles, measured about 8% slower
    on the card (``tools/torch_rtc_designs.py``)."""
    return (max(1, math.ceil(n / (4 * _THREADS))), 1, 1), (_THREADS, 1, 1)


def saxpy_plan(n: int):
    """``saxpy``'s grid and block over ``n`` floats, as ``scale_plan``'s:
    one tile of 1024 floats a block (a 16-byte quad of each operand a
    thread, or four floats when a, b and out do not share one alignment
    phase)."""
    return scale_plan(n)


class SoftmaxPlan(NamedTuple):
    threads: int                         # a block, one block per row
    shared_bytes: int                    # dynamic shared memory
    resident: bool                       # the row held in shared memory


def softmax_ce_fwd_plan(row_size: int, smem_limit: int) -> SoftmaxPlan:
    """The launch of ``softmax_ce_fwd`` over rows of ``row_size`` floats on
    a card whose blocks may opt into ``smem_limit`` bytes of shared
    memory. A row is resident when ``ceil((row_size + 3) / 4)`` 16-byte
    quads (the row at any of its four alignment phases) fit in dynamic
    shared memory beside the kernel's static shared memory; a streamed
    row needs no dynamic shared memory. The kernel reads the choice from
    the dynamic shared memory it is given."""
    quads = (row_size + 6) // 4
    if _ROW_STATIC + 16 * quads <= smem_limit:
        threads = min(_ROW_THREADS, 32 * max(1, math.ceil(quads / 32)))
        return SoftmaxPlan(threads, 16 * quads, True)
    return SoftmaxPlan(_STREAM_THREADS, 0, False)


_smem_optin: Dict[int, int] = {}


def smem_optin(device: torch.device) -> int:
    """The shared memory a block of ``device`` may opt into (bytes)."""
    if device.index not in _smem_optin:
        _smem_optin[device.index] = \
            _nvrtc.libcuda().max_shared_per_block_optin(device.index)
    return _smem_optin[device.index]


def _on_cpu(x: NDArray) -> bool:
    return x.ctx.device_type == "cpu"


# -- plain versions ----------------------------------------------------------
def scale_reference(x: torch.Tensor, factor: float) -> torch.Tensor:
    return x * factor


def saxpy_reference(a: torch.Tensor, b: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    return a * alpha + b


def first_row_reference(x: torch.Tensor) -> torch.Tensor:
    return x[0].clone()


def softmax_ce_fwd_reference(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def softmax_ce_bwd_reference(label: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(y.shape[-1], device=y.device)
    return y - (label.long().unsqueeze(-1) == cols).to(y.dtype)


# -- wrappers ---------------------------------------------------------------
def scale(x: NDArray, factor: float) -> NDArray:
    """``x * factor`` (fp32)."""
    if _on_cpu(x):
        return NDArray(scale_reference(x._data, factor))
    y = NDArray(torch.empty_like(x._data))
    kernel("scale").launch([x, y, factor, x.size], x.ctx,
                           *scale_plan(x.size))
    return y


def saxpy(a: NDArray, b: NDArray, alpha: float) -> NDArray:
    """``a * alpha + b`` (fp32), rounded as the plain version rounds."""
    if a.shape != b.shape:
        raise ValueError(f"saxpy: shapes {a.shape} and {b.shape} differ")
    if _on_cpu(a):
        return NDArray(saxpy_reference(a._data, b._data, alpha))
    out = NDArray(torch.empty_like(a._data))
    kernel("saxpy").launch([a, b, out, alpha, a.size], a.ctx,
                           *saxpy_plan(a.size))
    return out


def first_row(x: NDArray) -> NDArray:
    """Row 0 of a 2-D fp32 array."""
    if x.ndim != 2:
        raise ValueError(f"first_row takes a 2-D array, got {x.shape}")
    if _on_cpu(x):
        return NDArray(first_row_reference(x._data))
    out = NDArray(torch.empty(x.shape[1], dtype=x._data.dtype,
                              device=x._data.device))
    kernel("first_row").launch([x, out, x.shape[1]], x.ctx,
                               (math.ceil(x.shape[1] / _THREADS), 1, 1),
                               (_THREADS, 1, 1))
    return out


def _check_rows(what: str, x: NDArray, *same: NDArray) -> None:
    """``x`` is (N, V) and each of ``same`` has its shape: the kernels
    index every array by ``x``'s rows and row length."""
    if x.ndim != 2:
        raise ValueError(f"{what} takes (N, V) arrays, got {x.shape}")
    for a in same:
        if a.shape != x.shape:
            raise ValueError(f"{what}: shapes {x.shape} and {a.shape} "
                             "differ")


def softmax_ce_fwd(x: NDArray, y: NDArray, req: str = "write") -> None:
    """Store the row softmax of ``x`` (N, V) into ``y`` by ``req``."""
    _check_rows("softmax_ce_fwd", x, y)
    if req == "null":
        return
    if _on_cpu(x):
        _assign(y, req, NDArray(softmax_ce_fwd_reference(x._data)))
        return
    plan = softmax_ce_fwd_plan(x.shape[1], smem_optin(x._data.device))
    kernel("softmax_ce_fwd").launch([x, y, x.shape[1], _REQ[req]], x.ctx,
                                    (x.shape[0], 1, 1), (plan.threads, 1, 1),
                                    shared_mem=plan.shared_bytes)


def softmax_ce_bwd(label: NDArray, y: NDArray, dx: NDArray,
                   req: str = "write") -> None:
    """Store ``y - onehot(label)`` into ``dx`` by ``req``."""
    _check_rows("softmax_ce_bwd", y, dx)
    if label.shape != y.shape[:1]:
        raise ValueError(f"softmax_ce_bwd: labels {label.shape} for "
                         f"{y.shape[0]} rows")
    if req == "null":
        return
    if _on_cpu(y):
        _assign(dx, req,
                NDArray(softmax_ce_bwd_reference(label._data, y._data)))
        return
    kernel("softmax_ce_bwd").launch([label, y, dx, y.shape[1], _REQ[req]],
                                    y.ctx, (y.shape[0], 1, 1),
                                    (_ROW_THREADS, 1, 1))


# -- the custom op ------------------------------------------------------------
class SoftmaxCERtc(operator.CustomOp):
    """Softmax forward, cross-entropy gradient backward."""

    def forward(self, is_train, req, in_data, out_data, aux):
        softmax_ce_fwd(in_data[0], out_data[0], req[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        softmax_ce_bwd(in_data[1], out_data[0], in_grad[0], req[0])


@operator.register("softmax_ce_rtc")
class SoftmaxCERtcProp(operator.CustomOpProp):
    """``mx.nd.Custom(logits (N, V) fp32, labels (N,) int32,
    op_type="softmax_ce_rtc")`` -> probabilities (N, V)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return SoftmaxCERtc()
