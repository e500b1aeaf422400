"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are
built at first use into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``) and named by a hash of the source and flags, so
a changed source rebuilds and an unchanged one loads at once. The hash
also covers the shared headers (``csrc/*.cuh``) the sources include.
Nothing is built or loaded at import.

``build_all()`` starts one ``nvcc`` per source together and waits for all,
so a cold start costs the slowest build, not their sum.

``MXTPU_KERNEL_BUILD_DIR`` (an environment variable, read at each call)
puts the libraries elsewhere, e.g. an empty directory for a replica that
starts cold. :func:`recorded` lists the libraries a thread loads and the
``nvcc`` builds it starts (what the serving artifact store persists), and
:func:`install` writes a library built elsewhere under its name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: every kernel source of the package
SOURCES = ("conv_bwd", "conv_bwd_f32", "conv_bwd_tc", "flash_bwd",
           "flash_bwd_f32", "flash_bwd_tc", "flash_fwd", "flash_fwd_f32",
           "flash_fwd_split", "flash_fwd_tc", "fused_conv", "fused_conv_f32",
           "fused_conv_tc")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: the ``nvcc`` processes this process started, and the open recordings
#: (:func:`recorded`) of the calling thread
builds = 0
_local = threading.local()


def build_dir() -> Path:
    """Where the libraries go: ``$MXTPU_KERNEL_BUILD_DIR``, else
    ``build/kernels/`` at the root of the checkout."""
    env = os.environ.get("MXTPU_KERNEL_BUILD_DIR")
    return Path(env) if env else BUILD_DIR


@contextlib.contextmanager
def recorded() -> Iterator[dict]:
    """Around work on this thread: yields ``{"loaded": set of source names
    whose library a wrapper asked for, "built": [source names nvcc built],
    "build_seconds": float}``, filled as the work runs."""
    rec = {"loaded": set(), "built": [], "build_seconds": 0.0}
    stack = _local.__dict__.setdefault("recs", [])
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def _note(key: str, value) -> None:
    for rec in getattr(_local, "recs", ()):
        if key == "loaded":
            rec["loaded"].add(value)
        elif key == "built":
            rec["built"].append(value)
        else:
            rec["build_seconds"] += value


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from csrc/ at first use")


def lib_path(name: str) -> Path:
    """Content-addressed library path of kernel source ``name``."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def install(name: str, filename: str, blob: bytes) -> bool:
    """Write ``blob``, the library ``filename`` of source ``name`` built
    elsewhere, into the build directory, unless it is there already;
    atomic, as a build. False (nothing written) when ``filename`` is not
    this checkout's name for ``name`` (another source or flags)."""
    out = lib_path(name)
    if out.name != filename:
        return False
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, out)
    return True


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is already built;
    returns ``(final_path, tmp_path, process)`` or None."""
    global builds
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    builds += 1
    _note("built", name)
    return out, tmp, proc


def _finish(name: str, started) -> None:
    out, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees whole files


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Build every listed kernel library (default: all) in parallel."""
    names = list(SOURCES if names is None else names)
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if any(started.values()):
            _note("build_seconds", time.perf_counter() - t0)
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    if getattr(_local, "recs", None):
        _note("loaded", name)
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
