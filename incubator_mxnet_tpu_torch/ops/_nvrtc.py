"""ctypes bindings of NVRTC (the runtime compiler) and of ``libcuda``
(``cuModuleLoadData``, ``cuLaunchKernel``, ...), for ``mx.rtc``.

``compile_cubin`` compiles CUDA C++ source at run time for ``sm_90a`` to a
cubin (``nvrtcGetCUBIN``: machine code, so nothing is compiled again when
it loads) and caches it under ``build/rtc/`` at the root of the checkout,
named by the sha256 of the source, the options, the architecture and the
exported names. ``Libcuda`` loads a cubin into torch's context of a
device and launches its kernels on a torch stream.

Nothing is loaded at import. ``libnvrtc`` is looked for in
``$CUDA_HOME/lib64``, in the ``nvidia/cuda_nvrtc/lib`` directory of the
torch installation and in ``/usr/local/cuda/lib64``; a missing library
raises and names those places. Every pointer and the stream are
``c_void_p`` (ctypes would otherwise pass a 32-bit int and cut them).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading
from ctypes import POINTER, byref, c_char_p, c_int, c_size_t, c_uint, \
    c_void_p
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

ARCH = "sm_90a"
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "rtc"
#: dynamic shared memory a kernel gets without opting in
DEFAULT_MAX_DYNAMIC_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_CU_DEVICE_ATTRIBUTE_MAX_SHARED_MEMORY_PER_BLOCK_OPTIN = 97

_lock = threading.Lock()
_nvrtc = None
_libcuda = None


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvrtc_search_dirs() -> List[Path]:
    """Where ``libnvrtc`` is looked for, in order."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(Path(os.environ["CUDA_HOME"]) / "lib64")
    import torch

    dirs.append(Path(torch.__file__).resolve().parent.parent / "nvidia"
                / "cuda_nvrtc" / "lib")
    dirs.append(Path("/usr/local/cuda/lib64"))
    return dirs


def _bind(lib, name, argtypes, restype=c_int):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def nvrtc():
    """The loaded ``libnvrtc`` with its functions' types set."""
    global _nvrtc
    with _lock:
        if _nvrtc is not None:
            return _nvrtc
        dirs = nvrtc_search_dirs()
        for d in dirs:
            for path in sorted(d.glob("libnvrtc.so*")):
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    continue
                _bind(lib, "nvrtcGetErrorString", [c_int], c_char_p)
                _bind(lib, "nvrtcCreateProgram",
                      [POINTER(c_void_p), c_char_p, c_char_p, c_int,
                       POINTER(c_char_p), POINTER(c_char_p)])
                _bind(lib, "nvrtcAddNameExpression", [c_void_p, c_char_p])
                _bind(lib, "nvrtcCompileProgram",
                      [c_void_p, c_int, POINTER(c_char_p)])
                _bind(lib, "nvrtcGetProgramLogSize",
                      [c_void_p, POINTER(c_size_t)])
                _bind(lib, "nvrtcGetProgramLog", [c_void_p, c_void_p])
                _bind(lib, "nvrtcGetCUBINSize", [c_void_p, POINTER(c_size_t)])
                _bind(lib, "nvrtcGetCUBIN", [c_void_p, c_void_p])
                _bind(lib, "nvrtcGetLoweredName",
                      [c_void_p, c_char_p, POINTER(c_char_p)])
                _bind(lib, "nvrtcDestroyProgram", [POINTER(c_void_p)])
                _nvrtc = lib
                return lib
        raise RuntimeError(
            "libnvrtc not found: mx.rtc.CudaModule compiles with NVRTC and "
            "has no other compiler; looked in "
            + ", ".join(str(d) for d in dirs)
            + " (set CUDA_HOME to a CUDA toolkit)")


def _check_nvrtc(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.nvrtcGetErrorString(status).decode()
        raise RuntimeError(f"NVRTC {what} failed: {msg} ({status})")


def default_options() -> Tuple[str, ...]:
    opts = [f"--gpu-architecture={ARCH}"]
    include = Path(cuda_home()) / "include"
    if include.is_dir():
        opts.append(f"-I{include}")
    return tuple(opts)


def cache_key(source: str, options: Sequence[str],
              exports: Sequence[str]) -> str:
    h = hashlib.sha256()
    for part in (source, "\0".join(options), ARCH, "\0".join(exports)):
        h.update(part.encode())
        h.update(b"\1")
    return h.hexdigest()


def _compile(source: str, options: Sequence[str],
             exports: Sequence[str]) -> Tuple[bytes, Dict[str, str]]:
    lib = nvrtc()
    prog = c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        byref(prog), source.encode(), b"rtc_module.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         f"nvrtcAddNameExpression({name!r})")
        opts = [o.encode() for o in options]
        status = lib.nvrtcCompileProgram(prog, len(opts),
                                         (c_char_p * len(opts))(*opts))
        if status != 0:
            size = c_size_t()
            lib.nvrtcGetProgramLogSize(prog, byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            raise RuntimeError(
                f"NVRTC could not compile the module "
                f"({lib.nvrtcGetErrorString(status).decode()}); options "
                f"{list(options)}; log:\n{log.value.decode(errors='replace')}")
        size = c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), byref(out)),
                f"nvrtcGetLoweredName({name!r})")
            lowered[name] = out.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(byref(prog))


def compile_cubin(source: str, options: Sequence[str] = (),
                  exports: Iterable[str] = ()
                  ) -> Tuple[bytes, Dict[str, str]]:
    """The cubin of ``source`` (compiled with :func:`default_options` and
    ``options``) and the lowered names of ``exports``, from the cache or
    from NVRTC. A failed compile raises with NVRTC's log."""
    options = default_options() + tuple(options)
    exports = tuple(exports)
    key = cache_key(source, options, exports)
    cubin_path = CACHE_DIR / f"{key}.cubin"
    names_path = CACHE_DIR / f"{key}.json"
    if cubin_path.exists() and names_path.exists():
        return cubin_path.read_bytes(), json.loads(names_path.read_text())
    cubin, lowered = _compile(source, options, exports)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
    for path, data in ((names_path, json.dumps(lowered).encode()),
                       (cubin_path, cubin)):
        tmp = path.with_name(path.name + tag)
        tmp.write_bytes(data)
        os.replace(tmp, path)        # atomic: readers see whole files
    return cubin, lowered


class Libcuda:
    """The ``libcuda`` calls ``mx.rtc`` makes."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        self.get_error_string = _bind(lib, "cuGetErrorString",
                                      [c_int, POINTER(c_char_p)])
        self.ctx_get_current = _bind(lib, "cuCtxGetCurrent",
                                     [POINTER(c_void_p)])
        self.ctx_get_device = _bind(lib, "cuCtxGetDevice", [POINTER(c_int)])
        self.ctx_set_current = _bind(lib, "cuCtxSetCurrent", [c_void_p])
        self.device_get = _bind(lib, "cuDeviceGet", [POINTER(c_int), c_int])
        self.device_get_attribute = _bind(lib, "cuDeviceGetAttribute",
                                          [POINTER(c_int), c_int, c_int])
        self.primary_ctx_get_state = _bind(
            lib, "cuDevicePrimaryCtxGetState",
            [c_int, POINTER(c_uint), POINTER(c_int)])
        self.primary_ctx_retain = _bind(lib, "cuDevicePrimaryCtxRetain",
                                        [POINTER(c_void_p), c_int])
        self.module_load_data = _bind(lib, "cuModuleLoadData",
                                      [POINTER(c_void_p), c_void_p])
        self.module_get_function = _bind(
            lib, "cuModuleGetFunction", [POINTER(c_void_p), c_void_p,
                                         c_char_p])
        self.func_set_attribute = _bind(lib, "cuFuncSetAttribute",
                                        [c_void_p, c_int, c_int])
        self.launch_kernel = _bind(
            lib, "cuLaunchKernel",
            [c_void_p, c_uint, c_uint, c_uint, c_uint, c_uint, c_uint,
             c_uint, c_void_p, POINTER(c_void_p), POINTER(c_void_p)])
        self._primary: Dict[int, c_void_p] = {}

    def check(self, status: int, what: str) -> None:
        if status != 0:
            msg = c_char_p()
            self.get_error_string(status, byref(msg))
            text = msg.value.decode() if msg.value else "unknown error"
            raise RuntimeError(f"libcuda: {what} failed: {text} "
                               f"({status})")

    def use_device(self, index: int) -> None:
        """Make torch's context of device ``index`` current on this
        thread. torch creates that context (the device's primary context)
        when it first touches the device; a thread of torch's (the
        autograd engine's) may not have it current yet, and then it is
        bound here. A device torch has not initialised raises: mx.rtc
        never creates a context."""
        cur = c_void_p()
        self.check(self.ctx_get_current(byref(cur)), "cuCtxGetCurrent")
        if cur.value:
            dev = c_int()
            self.check(self.ctx_get_device(byref(dev)), "cuCtxGetDevice")
            if dev.value == index:
                return
        dev = c_int()
        self.check(self.device_get(byref(dev), index), "cuDeviceGet")
        flags, active = c_uint(), c_int()
        self.check(self.primary_ctx_get_state(dev, byref(flags),
                                              byref(active)),
                   "cuDevicePrimaryCtxGetState")
        if not active.value:
            raise RuntimeError(
                f"cuda:{index} has no context: torch has not initialised "
                "the device (allocate a tensor on it first); mx.rtc does "
                "not create contexts")
        ctx = self._primary.get(index)
        if ctx is None:
            ctx = c_void_p()
            self.check(self.primary_ctx_retain(byref(ctx), dev),
                       "cuDevicePrimaryCtxRetain")
            self._primary[index] = ctx
        self.check(self.ctx_set_current(ctx), "cuCtxSetCurrent")

    def max_shared_per_block_optin(self, index: int) -> int:
        """The shared memory (bytes) a block on device ``index`` may opt
        into (232,448 on an H100)."""
        dev, value = c_int(), c_int()
        self.check(self.device_get(byref(dev), index), "cuDeviceGet")
        attr = _CU_DEVICE_ATTRIBUTE_MAX_SHARED_MEMORY_PER_BLOCK_OPTIN
        self.check(self.device_get_attribute(byref(value), attr, dev),
                   "cuDeviceGetAttribute(MAX_SHARED_MEMORY_PER_BLOCK_OPTIN)")
        return value.value

    def load_module(self, cubin: bytes) -> c_void_p:
        module = c_void_p()
        image = ctypes.create_string_buffer(cubin, len(cubin))
        self.check(self.module_load_data(byref(module), image),
                   "cuModuleLoadData")
        return module

    def get_function(self, module: c_void_p, name: str) -> c_void_p:
        fn = c_void_p()
        self.check(self.module_get_function(byref(fn), module,
                                            name.encode()),
                   f"cuModuleGetFunction({name!r})")
        return fn

    def set_max_dynamic_smem(self, fn: c_void_p, nbytes: int) -> None:
        self.check(self.func_set_attribute(
            fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
            "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")

    def launch(self, fn: c_void_p, grid: Sequence[int], block: Sequence[int],
               shared_mem: int, stream: int, args: Sequence) -> None:
        """Launch ``fn`` with ``args`` (one ctypes value per kernel
        argument, alive until this returns) on ``stream``."""
        params = (c_void_p * len(args))(*[ctypes.addressof(a) for a in args])
        self.check(self.launch_kernel(fn, *grid, *block, shared_mem,
                                      c_void_p(stream), params, None),
                   "cuLaunchKernel")


def libcuda() -> Libcuda:
    global _libcuda
    with _lock:
        if _libcuda is None:
            _libcuda = Libcuda()
        return _libcuda

