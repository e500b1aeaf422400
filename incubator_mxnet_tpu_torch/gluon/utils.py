"""Gluon utilities: batch slicing, global-norm clipping, file checks.

Counterpart of the JAX package's ``gluon/utils.py`` (MXNet's
``gluon.utils``): ``split_data`` and ``split_and_load`` (a batch sliced
across contexts), ``clip_global_norm``, ``check_sha1`` and ``download``,
which never opens a connection: a file already present resolves, anything
else raises.

``clip_global_norm`` takes the norm on the device in one pass over the
list (``torch._foreach_norm``, the per-array norms combined in fp64), reads
that one value back and scales in place with ``torch._foreach_mul_``:
one synchronizing read a call, where the reference reads one host float
an array.
"""

from __future__ import annotations

import hashlib
import math
import os
import warnings
from typing import List

import torch

from ..device import Context
from ..ndarray.ndarray import NDArray, as_nd

__all__ = ["check_sha1", "clip_global_norm", "download", "split_and_load",
           "split_data"]


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> list:
    """Slice one batch into ``num_slice`` parts along ``batch_axis``
    (reference ``split_data``). With ``even_split`` the batch must divide;
    else the last slice takes the remainder. Each slice is an ``NDArray``
    (``slice_axis``) on the operand's device."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"batch size {size} not divisible by num_slice {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list: List[Context], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Slice a batch (a numpy array, an ``NDArray`` or a tensor) across
    ``ctx_list`` and load each slice onto its context (reference
    ``split_and_load``): one context takes the whole batch. Returns
    ``NDArray``\\ s, as the reference; a tensor is wrapped without a
    copy before it moves."""
    data = NDArray(data) if isinstance(data, torch.Tensor) else as_nd(
        data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Rescale ``arrays`` (``NDArray``\\ s or tensors, e.g. the parameters'
    ``.grad``) in place so that their joint L2 norm is at most
    ``max_norm`` (reference ``clip_global_norm``): each is multiplied by
    ``max_norm / (norm + 1e-8)`` when that is below 1. Returns the norm as
    a Python float. A norm that is not finite warns ("nan or inf in
    clip_global_norm"); a NaN norm then scales nothing, an infinite one
    scales by 0, as the reference does."""
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    if not tensors:
        return 0.0
    dev = tensors[0].device
    acc = torch.float64 if any(t.dtype == torch.float64 for t in tensors) \
        else torch.float32
    norms = torch._foreach_norm(tensors, 2, dtype=acc)
    total = torch.stack([n.to(dev) for n in norms]).double().norm()
    norm = total.item()                       # the one synchronizing read
    if check_isfinite and not math.isfinite(norm):
        warnings.warn("nan or inf in clip_global_norm")
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(tensors, scale)
    return norm


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Whether the SHA-1 of ``filename``'s bytes is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True) -> str:
    """Reference ``gluon.utils.download`` without the network: the file
    ``url`` names (at ``path``, or in it when ``path`` is a directory)
    resolves when it is present (and, given ``sha1_hash``, has that
    digest) and ``overwrite`` is false; anything else raises
    ``RuntimeError``. It never opens a connection."""
    fname = url.split("/")[-1] if path is None or os.path.isdir(path or ".") \
        else path
    if path and os.path.isdir(path):
        fname = os.path.join(path, fname)
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        f"download({url!r}): no network egress in this environment; place "
        f"the file at {fname!r} manually")
