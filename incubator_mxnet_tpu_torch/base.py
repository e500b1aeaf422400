"""Shared helpers: the package's error class.

Counterpart of the JAX package's ``base.py``.
"""

from __future__ import annotations


class MXTPUError(RuntimeError):
    """Base error class (reference: MXNetError via MXGetLastError)."""
