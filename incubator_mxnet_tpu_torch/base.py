"""Shared helpers: the package's error class and dtype plumbing.

Counterpart of the JAX package's ``base.py``. ``resolve_dtype`` takes a
dtype as a name (``"float32"``, ``"bfloat16"``), a numpy dtype or type, or
a torch dtype, and gives the torch dtype.
"""

from __future__ import annotations

import numpy as _np
import torch

#: dtype names the package accepts, as the JAX package's ``_DTYPE_ALIASES``
DTYPE_ALIASES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_NUMPY_TO_TORCH = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.int16): torch.int16,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.uint32): torch.uint32,
    _np.dtype(_np.uint64): torch.uint64,
    _np.dtype(_np.bool_): torch.bool,
    _np.dtype(_np.complex64): torch.complex64,
    _np.dtype(_np.complex128): torch.complex128,
}
_TORCH_TO_NUMPY = {t: n for n, t in _NUMPY_TO_TORCH.items()}


def resolve_dtype(dtype):
    """The torch dtype of ``dtype`` (a name, numpy dtype or type, or torch
    dtype); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in DTYPE_ALIASES:
        return DTYPE_ALIASES[dtype]
    try:
        return _NUMPY_TO_TORCH[_np.dtype(dtype)]
    except (TypeError, KeyError):
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype, or None where numpy has none
    (bfloat16)."""
    return _TORCH_TO_NUMPY.get(dtype)


class MXTPUError(RuntimeError):
    """Base error class (reference: MXNetError via MXGetLastError)."""
