"""Prompt-length bucket policy.

Counterpart of the bucket policy of ``BucketedExecutorCache`` in
the JAX package's ``serving/executor_cache.py`` (``bucket_for``,
``max_batch_size``, zero-padding up to the bucket). There is no compile
cache: PyTorch runs eagerly, so a bucket only fixes the padded length.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["BucketPolicy"]


class BucketPolicy:
    """Sorted distinct buckets; inputs pad with zeros up to the smallest
    bucket that holds them."""

    def __init__(self, buckets: Sequence[int]):
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets: Tuple[int, ...] = bs

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that holds ``n``."""
        if n < 1:
            raise ValueError(f"size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"size {n} exceeds the largest bucket {self.buckets[-1]}; "
            "raise buckets=")

    @property
    def max_batch_size(self) -> int:
        return self.buckets[-1]

    def pad(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` zero-padded along its first axis to its bucket."""
        n = arr.shape[0]
        bucket = self.bucket_for(n)
        if n == bucket:
            return arr
        pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)
