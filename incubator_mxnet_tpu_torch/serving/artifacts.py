"""Persistent serving artifacts: the on-disk half of the executor caches.

Counterpart of the JAX package's ``serving/artifacts.py``, with another
payload. There an artifact is a serialized XLA executable, loaded without
the compiler. Here a model's executables are CUDA graphs, which cannot be
serialized, and capturing them again is cheap (a fraction of a second for
a ResNet-50's six buckets). What a cold replica really pays for is the
``nvcc`` build of every kernel library its graphs launch (``ops/_build.py``
caches them by content hash, but a new replica starts with an empty build
directory). So the persisted payload of an executable is the set of kernel
libraries its capture loaded, as bytes: a replica pointed at the store
installs them into its build directory and captures its graphs again with
no ``nvcc`` run.

The store is keyed in two layers, as the reference's:

* the **logical key** names what the artifact is for (model, component,
  bucket, feature signature, dtype) and is hashed into its filename;
* the **guard fingerprint** names what it is only valid under (torch and
  CUDA versions, the driver, the device, ``sm_90a``, the kernel sources
  and flags, the model's parameter-spec fingerprint) and is checked field
  by field at load. Any mismatch **refuses** the artifact (counted and
  logged, never installed) and the caller builds and persists again.

Writes are atomic (``.tmp`` + fsync + rename), so a killed replica never
leaves a torn artifact that a later one would trust; a corrupt file reads
as a miss.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pickle
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import torch

from ..ops import _build

logger = logging.getLogger("mxtpu_torch.serving")

__all__ = ["ArtifactStore", "environment_fingerprint", "kernel_payload",
           "install_payload", "params_fingerprint",
           "serialization_supported"]

#: bump when the on-disk pickle layout changes: old files are refused
SCHEMA_VERSION = 1

_SUFFIX = ".mxart"


def serialization_supported() -> bool:
    """Can the payload be stored? It is the kernel libraries as bytes, which
    any process can write, so always: the store never disables itself for
    want of a serializer (the reference's contract where one is absent:
    "the store disables itself ... never an error")."""
    return True


def _driver_version() -> Optional[int]:
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return int(v.value)
    except OSError:
        pass
    return None


def environment_fingerprint() -> Dict[str, Any]:
    """The toolchain and device half of the guard: a kernel library is only
    valid for the sources and flags it was built from and the card and
    driver it runs on."""
    on_card = torch.cuda.is_available()
    kernels = hashlib.sha256(" ".join(
        _build.lib_path(n).name for n in _build.SOURCES).encode())
    return {
        "schema": SCHEMA_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": _driver_version() if on_card else None,
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 0,
        "arch": "sm_90a",
        "kernels": kernels.hexdigest()[:16],
    }


def params_fingerprint(params) -> str:
    """Structural fingerprint of a parameter list: ordered shapes and
    dtypes. It names the program's signature, not the weight values: a
    weight swap keeps it, an architecture change breaks it."""
    h = hashlib.sha256()
    for p in params:
        h.update(repr(tuple(int(d) for d in p.shape)).encode())
        h.update(str(p.dtype).replace("torch.", "").encode())
    return h.hexdigest()[:16]


def kernel_payload(names: Iterable[str]) -> Dict[str, Tuple[str, bytes]]:
    """The libraries of kernel sources ``names`` as built in this checkout:
    ``{source: (library filename, bytes)}`` (sources never built here are
    left out)."""
    out = {}
    for name in sorted(set(names)):
        path = _build.lib_path(name)
        if path.exists():
            out[name] = (path.name, path.read_bytes())
    return out


def install_payload(payload: Dict[str, Tuple[str, bytes]]) -> int:
    """Install a :func:`kernel_payload` into the build directory (a library
    already there stays); returns the count of libraries it holds.
    Raises ``ValueError`` for a library built from other sources (the
    guard's ``kernels`` field refuses such an artifact first)."""
    for name, (filename, blob) in payload.items():
        if name not in _build.SOURCES \
                or not _build.install(name, filename, blob):
            raise ValueError(f"artifact library {filename} is not this "
                             f"checkout's build of {name}")
    return len(payload)


def _key_hash(logical: Dict[str, Any]) -> str:
    payload = repr(sorted((k, repr(v)) for k, v in logical.items()))
    return hashlib.sha1(payload.encode()).hexdigest()[:20]


class ArtifactStore:
    """One directory of artifacts, ``<root>/<model>/<logical-key-hash>
    .mxart``, shared safely by every cache in a process and by independent
    replica processes (loads are read-only, saves are atomic renames)."""

    def __init__(self, root: str):
        self.root = str(root)
        self._lock = threading.Lock()

    def _model_dir(self, model: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "._-") else "_"
                       for c in str(model)) or "model"
        return os.path.join(self.root, safe)

    def path_for(self, model: str, logical: Dict[str, Any]) -> str:
        return os.path.join(self._model_dir(model),
                            _key_hash(logical) + _SUFFIX)

    # -- save ---------------------------------------------------------------
    def save(self, model: str, logical: Dict[str, Any],
             guard: Dict[str, Any], payload) -> str:
        """Store ``payload`` (a :func:`kernel_payload`) under (model,
        logical) with ``guard`` recorded for load-time verification.
        Atomic: a crash mid-write leaves at most a ``.tmp``."""
        blob = pickle.dumps({"schema": SCHEMA_VERSION,
                             "logical": dict(logical),
                             "guard": dict(guard),
                             "artifact": payload},
                            protocol=pickle.HIGHEST_PROTOCOL)
        path = self.path_for(model, logical)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # a scratch name of its own: two replicas booting cold on one key
        # must not interleave their writes into one tmp file
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return path

    # -- load ---------------------------------------------------------------
    def load(self, model: str, logical: Dict[str, Any],
             guard: Dict[str, Any]) -> Tuple[Optional[Any], str]:
        """The installed payload of (model, logical), or ``(None,
        reason)``: ``"absent"`` (a plain miss), ``"corrupt"`` (unreadable),
        or ``"refused:<field>"`` (its recorded guard disagrees on
        ``<field>``). A refused artifact is never installed."""
        path = self.path_for(model, logical)
        record = self._read(path)
        if record is None:
            return None, "absent" if not os.path.exists(path) else "corrupt"
        payload, reason = self._install_checked(record, logical, guard)
        if payload is None and reason.startswith("refused"):
            logger.warning(
                "artifact %s refused (%s): building again; a stale "
                "artifact is never installed", path, reason)
        return payload, reason

    def load_all(self, model: str,
                 guard: Dict[str, Any]) -> Iterator[Tuple[Dict, Any]]:
        """Yield ``(logical, payload)`` for every artifact of ``model``
        whose guard matches, installed: the eager warm-start scan (no
        feature signature needed up front). Refused and corrupt entries
        are skipped (logged), not raised."""
        d = self._model_dir(model)
        if not os.path.isdir(d):
            return
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(_SUFFIX):
                continue
            record = self._read(os.path.join(d, fn))
            if record is None:
                continue
            logical = record.get("logical", {})
            payload, reason = self._install_checked(record, logical, guard)
            if payload is None:
                logger.warning("artifact %s skipped (%s)",
                               os.path.join(d, fn), reason)
                continue
            yield logical, payload

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _read(path: str) -> Optional[Dict]:
        try:
            with open(path, "rb") as f:
                record = pickle.load(f)
            if not isinstance(record, dict) or "artifact" not in record:
                return None
            return record
        except (OSError, pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, TypeError):
            return None

    @staticmethod
    def _install_checked(record: Dict, logical: Dict,
                         guard: Dict) -> Tuple[Optional[Any], str]:
        if record.get("schema") != SCHEMA_VERSION:
            return None, "refused:schema"
        if record.get("logical") != dict(logical):
            # a filename-hash collision or a hand-moved file: the stored
            # logical identity is authoritative
            return None, "refused:logical"
        stored = record.get("guard", {})
        want = dict(guard)
        for field in sorted(set(stored) | set(want)):
            if stored.get(field) != want.get(field):
                return None, f"refused:{field}"
        payload = record["artifact"]
        try:
            install_payload(payload)
        except (OSError, ValueError, TypeError, AttributeError) as e:
            return None, f"corrupt:{type(e).__name__}"
        return payload, "ok"
