"""``mx.rtc``: CUDA kernels written at run time and launched on NDArrays.

The port of the JAX package's ``rtc.py``, the runtime custom-kernel
surface whose TPU form launches a user's Pallas function
(``PallasKernel._launch_fn``). On the card it is upstream MXNet's own API
(``python/mxnet/rtc.py``, ``src/common/rtc.cc``)::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }'''
    module = mx.rtc.CudaModule(source)
    axpy = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    axpy.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    print(y.asnumpy())                    # [3. 3. ... 3.]

``CudaModule`` compiles the source with NVRTC for ``sm_90a`` to a cubin,
cached under ``build/rtc/`` (see ``ops/_nvrtc.py``), and loads it into
torch's context of each device it launches on. A kernel is looked up by
name: a name listed in ``exports`` (a template instance such as
``"softmax<float>"``) through NVRTC's lowered name, any other as an
``extern "C"`` symbol. ``CudaKernel.launch`` checks every argument against
the kernel's signature, launches on torch's current stream of the device
(so the launch orders with torch's work and can be captured in a CUDA
graph) and counts the launch in :data:`launches` under the kernel's name.
Launch errors during the run are asynchronous: they surface at the next
sync point (``wait_to_read``, ``asnumpy``, ``mx.nd.waitall``).

There is no fallback: a CPU context or a CPU array raises, a missing NVRTC
raises, and nothing turns into a plain torch function. ``PallasModule``
and ``PallasKernel`` raise: a Pallas function cannot run on this card.
"""

from __future__ import annotations

import collections
import ctypes
import numbers
import re
from typing import Dict, List, NamedTuple, Sequence

import torch

from .config import is_naive_engine
from .device import Context
from .ndarray.ndarray import NDArray
from .ops import _nvrtc
from .ops import launches as _launches

__all__ = ["CudaKernel", "CudaModule", "PallasKernel", "PallasModule",
           "launches", "parse_signature"]

#: kernel launches by kernel name (the name given to ``get_kernel``); reset
#: entries to 0 before a run and read them after
launches: Dict[str, int] = collections.Counter()


def _half_bits(value) -> int:
    return int(torch.tensor(float(value), dtype=torch.float16)
               .view(torch.int16).item()) & 0xFFFF


def _bf16_bits(value) -> int:
    return int(torch.tensor(float(value), dtype=torch.bfloat16)
               .view(torch.int16).item()) & 0xFFFF


class _CType(NamedTuple):
    dtype: torch.dtype                   # the element type of a pointer
    scalar: type                         # the ctypes type of a value
    integral: bool
    convert: object = None               # value -> ctypes value argument


#: the C types a signature may name (MXNet's set, plus __nv_bfloat16)
C_TYPES = {
    "float": _CType(torch.float32, ctypes.c_float, False),
    "double": _CType(torch.float64, ctypes.c_double, False),
    "__half": _CType(torch.float16, ctypes.c_uint16, False, _half_bits),
    "__nv_bfloat16": _CType(torch.bfloat16, ctypes.c_uint16, False,
                            _bf16_bits),
    "uint8_t": _CType(torch.uint8, ctypes.c_uint8, True),
    "int8_t": _CType(torch.int8, ctypes.c_int8, True),
    "char": _CType(torch.int8, ctypes.c_int8, True),
    "int": _CType(torch.int32, ctypes.c_int32, True),
    "int32_t": _CType(torch.int32, ctypes.c_int32, True),
    "int64_t": _CType(torch.int64, ctypes.c_int64, True),
}


class Arg(NamedTuple):
    """One parameter of a kernel signature."""
    ctype: str
    is_const: bool
    is_pointer: bool
    name: str


_ARG = re.compile(r"^\s*(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?"
                  r"\s*$")


def parse_signature(signature: str) -> List[Arg]:
    """MXNet's kernel signature string, for example ``"const float *x,
    float *y, float alpha, int n"``: each argument is ``[const] type [*]
    [name]``, with ``type`` one of :data:`C_TYPES`."""
    args = []
    for i, part in enumerate(re.sub(r"\s+", " ", signature).split(",")):
        m = _ARG.match(part)
        if m is None or m.group(2) == "const":
            raise ValueError(f'invalid argument "{part.strip()}" in kernel '
                             f'signature {signature!r}: each must be '
                             '"[const] type [*] [name]"')
        if m.group(2) not in C_TYPES:
            raise TypeError(f"unsupported kernel argument type "
                            f"{m.group(2)!r} in {part.strip()!r}; supported: "
                            f"{', '.join(C_TYPES)}")
        args.append(Arg(m.group(2), bool(m.group(1)), bool(m.group(3)),
                        m.group(4) or f"arg{i}"))
    return args


class CudaModule:
    """CUDA C++ source compiled at run time (reference
    ``mx.rtc.CudaModule(source, options=(), exports=())``). ``options``
    go to NVRTC after ``--gpu-architecture=sm_90a`` and
    ``-I$CUDA_HOME/include``; ``exports`` names template instances to
    look up by their C++ name. Compiles now (or reads the cache); loads
    into a device at its first launch there."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._cubin, self._lowered = _nvrtc.compile_cubin(source, options,
                                                          exports)
        self._modules: Dict[int, ctypes.c_void_p] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with argument types ``signature``."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))

    def _function(self, symbol: str, device_index: int):
        cuda = _nvrtc.libcuda()
        module = self._modules.get(device_index)
        if module is None:
            module = cuda.load_module(self._cubin)
            self._modules[device_index] = module
        return cuda.get_function(module, symbol)


class CudaKernel:
    """A kernel of a :class:`CudaModule` (reference ``CudaKernel``)."""

    def __init__(self, module: CudaModule, name: str, symbol: str,
                 args: List[Arg]):
        self._module = module
        self.name = name
        self._symbol = symbol
        self.args = args
        self._functions: Dict[int, ctypes.c_void_p] = {}
        self._smem_opt_in: Dict[int, int] = {}

    def _values(self, args, device: torch.device) -> list:
        """One ctypes value per argument, checked against the signature
        (types first, then the arrays' devices)."""
        if len(args) != len(self.args):
            raise TypeError(f"CudaKernel({self.name}) expects "
                            f"{len(self.args)} arguments but got {len(args)}")
        values, placed = [], []
        for i, (arg, spec) in enumerate(zip(args, self.args)):
            ct = C_TYPES[spec.ctype]
            where = f"CudaKernel({self.name}) argument {i} ({spec.name})"
            if spec.is_pointer:
                if not isinstance(arg, NDArray):
                    raise TypeError(f"{where} must be an NDArray, got "
                                    f"{type(arg).__name__}")
                t = arg._data
                if t.dtype != ct.dtype:
                    raise TypeError(f"{where} is {t.dtype}, the signature "
                                    f"says {spec.ctype}*")
                placed.append((where, arg))
                values.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if not isinstance(arg, numbers.Real) or isinstance(arg,
                                                                   bool):
                    raise TypeError(f"{where} must be a number, got "
                                    f"{type(arg).__name__}")
                if ct.integral and int(arg) != arg:
                    raise TypeError(f"{where} is {arg!r}, the signature "
                                    f"says {spec.ctype}")
                value = ct.convert(arg) if ct.convert else (
                    int(arg) if ct.integral else float(arg))
                values.append(ct.scalar(value))
        for where, arg in placed:
            if arg._data.device != device:
                raise ValueError(f"{where} is on {arg.ctx}, the launch on "
                                 f"{device}")
            if not arg._data.is_contiguous():
                raise ValueError(f"{where} is not contiguous")
        return values

    def launch(self, args, ctx: Context, grid_dims, block_dims,
               shared_mem: int = 0) -> None:
        """Launch on ``ctx``'s card over ``args`` in the signature's order
        (pointers as NDArrays on that card, of the pointer's dtype;
        numbers converted to the signature's C type), with a
        ``grid_dims`` grid of ``block_dims`` blocks and ``shared_mem``
        bytes of dynamic shared memory (over 48 KB opts the kernel in)."""
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise ValueError(f"CudaKernel({self.name}).launch needs a gpu "
                             f"context, got {ctx!r}: a CUDA kernel runs "
                             "only on the card")
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError("grid_dims and block_dims must be tuples of 3 "
                             "integers")
        values = self._values(args, torch.device("cuda", ctx.device_id))
        device = ctx.torch_device()          # raises without a card
        cuda = _nvrtc.libcuda()
        cuda.use_device(ctx.device_id)
        fn = self._functions.get(ctx.device_id)
        if fn is None:
            fn = self._module._function(self._symbol, ctx.device_id)
            self._functions[ctx.device_id] = fn
        if shared_mem > max(_nvrtc.DEFAULT_MAX_DYNAMIC_SMEM,
                            self._smem_opt_in.get(ctx.device_id, 0)):
            cuda.set_max_dynamic_smem(fn, shared_mem)
            self._smem_opt_in[ctx.device_id] = shared_mem
        stream = torch.cuda.current_stream(device).cuda_stream
        cuda.launch(fn, [int(g) for g in grid_dims],
                   [int(b) for b in block_dims], int(shared_mem), stream,
                   values)
        _launches.count("rtc", self.name)
        if is_naive_engine():
            torch.cuda.synchronize(device)


class PallasKernel:
    """The JAX package's Pallas kernel handle. It cannot run here."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError(
            "mx.rtc.PallasModule and PallasKernel launch Pallas functions, "
            "which run only on a TPU; on this card write the kernel in "
            "CUDA C++ and use mx.rtc.CudaModule(source).get_kernel(name, "
            "signature)")


class PallasModule(PallasKernel):
    """The JAX package's Pallas kernel factory. It cannot run here."""
