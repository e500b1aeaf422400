"""Sparse storage: ``row_sparse`` and ``csr`` arrays.

Counterpart of the JAX package's ``ndarray/sparse.py`` (reference
``python/mxnet/ndarray/sparse.py``): ``RowSparseNDArray`` (a subset of
rows held, the rest zero: embedding and optimizer gradients),
``CSRNDArray`` (compressed rows: sparse feature matrices),
``cast_storage``/``tostype``, ``retain``, the sparse ``dot``, ``add`` and
``elemwise_add``.

Data, indices and indptr are tensors on the operand's device; indices and
indptr are int32, as x32 gives. Nothing is read back to the host: the
reference computes its row ids, ``unique`` and ``nonzero`` on host
metadata, the port computes them on the device (``torch.unique``,
``nonzero`` through boolean masks, ``repeat_interleave``,
``index_add_``). Where the number of stored entries depends on the data
(a storage cast, ``retain``, a merge, a csr slice) the op waits for the
device by nature, and inside a CUDA graph capture it raises. ``dot`` and
``todense`` know their sizes and run inside a capture.

The sparse arrays are not ``NDArray`` subclasses, so a dense-only op
refuses them loudly, as the reference's. Like the reference's, ``dot``
builds its result off the tape: it does not record under
``autograd.record()``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import resolve_dtype
from ..device import Context, resolve
from ..ops.numpy_ops import _dynamic
from .ndarray import NDArray, _context_of, _narrow_x32, as_nd
from .ndarray import zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray", "add",
           "cast_storage", "csr_matrix", "dense_from_row_sparse", "dot",
           "elemwise_add", "retain", "row_sparse_array", "zeros"]

_INDEX = torch.int32


def _tensor(x, dev=None, dtype=None) -> torch.Tensor:
    """``x`` (an NDArray, tensor, numpy array or list) as a tensor on
    ``dev``, x32-narrowed unless ``dtype`` is given. Where ``dev`` is None
    an NDArray or tensor stays on its own device, other data goes onto the
    default context."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.tensor(x)
        dev = resolve(None) if dev is None else dev
    dt = dtype if dtype is not None else _narrow_x32(t.dtype)
    return t.to(device=t.device if dev is None else dev, dtype=dt)


class BaseSparseNDArray:
    """What the sparse storage types share (not an ``NDArray``: a
    dense-only op refuses a sparse operand)."""

    _shape: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def ctx(self) -> Context:
        return _context_of(self._data)

    context = ctx

    @property
    def dtype(self):
        return NDArray(self._data).dtype

    @property
    def nnz(self) -> int:
        return int(self._data.shape[0])

    def wait_to_read(self) -> None:
        NDArray(self._data).wait_to_read()

    def __repr__(self):
        return f"\n<{type(self).__name__} {self.shape} @{self.ctx}>"

    def asnumpy(self):
        return self.todense().asnumpy()


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` hold ``data``; every other row is zero (reference
    ``RowSparseNDArray``). The canonical form has sorted unique indices:
    every op of this module returns it, but ``row_sparse_array`` only
    sorts what it is given, as the reference's."""

    def __init__(self, data, indices, shape, ctx=None):
        dev = None if ctx is None else resolve(ctx)
        self._data = _tensor(data, dev)
        self._indices = _tensor(indices, self._data.device, _INDEX)
        self._shape = tuple(int(s) for s in shape)
        if self._data.shape[0] != self._indices.shape[0]:
            raise ValueError(f"data rows {self._data.shape[0]} != indices "
                             f"{self._indices.shape[0]}")

    @property
    def data(self) -> NDArray:
        return NDArray(self._data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def stype(self) -> str:
        return "row_sparse"

    def todense(self) -> NDArray:
        return NDArray(dense_from_row_sparse(self._data, self._indices,
                                             self._shape))

    def tostype(self, stype: str):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(f"cast row_sparse -> {stype!r} not supported")

    def retain(self, row_ids) -> "RowSparseNDArray":
        """Only the rows listed in ``row_ids`` (reference
        ``sparse.retain``)."""
        _dynamic("sparse.retain", self._data)
        keep = _tensor(row_ids, self._data.device).reshape(-1).long()
        mask = torch.isin(self._indices.long(), keep)
        return RowSparseNDArray(self._data[mask], self._indices[mask],
                                self._shape)

    def copy(self) -> "RowSparseNDArray":
        """A copy that owns its tensors (a gradient buffer changes in
        place, so a snapshot must not share them)."""
        return RowSparseNDArray(self._data.clone(), self._indices.clone(),
                                self._shape)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return _merge_row_sparse(self, other)
        return self.todense() + other

    __radd__ = __add__

    def as_torch(self) -> torch.Tensor:
        """The same rows as a torch sparse COO tensor (one sparse dim)."""
        return torch.sparse_coo_tensor(
            self._indices.long().unsqueeze(0), self._data, self._shape,
            check_invariants=False)

    @classmethod
    def from_torch(cls, t: torch.Tensor) -> "RowSparseNDArray":
        """A torch gradient as a row-sparse array: a sparse COO tensor
        (one sparse dim) coalesced, a dense one by ``cast_storage``."""
        if not t.is_sparse:
            return cast_storage(NDArray(t.detach()), "row_sparse")
        if t.sparse_dim() != 1:
            raise ValueError("a row-sparse array has one sparse dim, got "
                             f"{t.sparse_dim()}")
        t = t.detach().coalesce()
        return cls(t.values(), t.indices()[0], t.shape)


class CSRNDArray(BaseSparseNDArray):
    """A 2-D matrix in compressed sparse rows (reference ``CSRNDArray``):
    row ``r`` holds ``data[indptr[r]:indptr[r + 1]]`` at the columns
    ``indices[indptr[r]:indptr[r + 1]]``."""

    def __init__(self, data, indices, indptr, shape, ctx=None):
        dev = None if ctx is None else resolve(ctx)
        self._data = _tensor(data, dev)
        self._indices = _tensor(indices, self._data.device, _INDEX)
        self._indptr = _tensor(indptr, self._data.device, _INDEX)
        self._shape = tuple(int(s) for s in shape)
        if len(self._shape) != 2:
            raise ValueError("csr storage is 2-D only")

    @property
    def data(self) -> NDArray:
        return NDArray(self._data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._indptr)

    @property
    def stype(self) -> str:
        return "csr"

    def _row_ids(self) -> torch.Tensor:
        """The row of each stored entry (COO rows), on the device: the
        output size is nnz, so nothing waits for the device."""
        rows = torch.arange(self._shape[0], device=self._data.device)
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(rows, counts, output_size=self.nnz)

    def todense(self) -> NDArray:
        dense = self._data.new_zeros(self._shape)
        dense[self._row_ids(), self._indices.long()] = self._data
        return NDArray(dense)

    def copy(self) -> "CSRNDArray":
        return CSRNDArray(self._data.clone(), self._indices.clone(),
                          self._indptr.clone(), self._shape)

    def tostype(self, stype: str):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(f"cast csr -> {stype!r} not supported")

    def dot(self, dense, transpose_a: bool = False) -> NDArray:
        return dot(self, dense, transpose_a=transpose_a)

    def __getitem__(self, key):
        """Rows ``key`` (a slice of step 1), as the reference's."""
        if not isinstance(key, slice):
            raise TypeError("csr supports row-slice indexing only")
        start, stop, step = key.indices(self._shape[0])
        if step != 1:
            raise ValueError("csr slicing requires step 1")
        stop = max(stop, start)
        _dynamic("CSRNDArray slicing", self._data)
        rows = self._row_ids()
        mask = (rows >= start) & (rows < stop)
        iptr = self._indptr[start:stop + 1]
        return CSRNDArray(self._data[mask], self._indices[mask],
                          iptr - iptr[:1], (stop - start, self._shape[1]))


def dense_from_row_sparse(rdata: torch.Tensor, indices: torch.Tensor,
                          shape) -> torch.Tensor:
    """The dense tensor of ``shape`` whose rows ``indices`` are
    ``rdata``, zero elsewhere."""
    return rdata.new_zeros(tuple(shape)).index_copy_(0, indices.long(),
                                                     rdata)


def _merge_row_sparse(a: RowSparseNDArray,
                      b: RowSparseNDArray) -> RowSparseNDArray:
    """``a + b`` with sorted unique rows, in ``a``'s dtype."""
    _dynamic("row_sparse add", a._data, b._data)
    uniq, inv = torch.unique(torch.cat([a._indices, b._indices]),
                             sorted=True, return_inverse=True)
    vals = torch.cat([a._data, b._data.to(a._data.dtype)])
    rows = vals.new_zeros((uniq.shape[0],) + vals.shape[1:])
    return RowSparseNDArray(rows.index_add_(0, inv, vals), uniq, a._shape)


def embedding_grad(ids: torch.Tensor, outside: torch.Tensor,
                   dy: torch.Tensor, shape) -> torch.Tensor:
    """The weight gradient of an embedding lookup as a coalesced sparse
    COO tensor: one row for each distinct id in ``ids`` (rows of the
    table, already counted from the end) not flagged ``outside``, in
    ascending order, the cotangent rows ``dy`` of its lookups summed."""
    _dynamic("Embedding(sparse_grad=True) backward", dy)
    keep = ~outside.reshape(-1)
    rows = dy.reshape(-1, shape[-1])[keep]
    uniq, inv = torch.unique(ids.reshape(-1)[keep], sorted=True,
                             return_inverse=True)
    summed = rows.new_zeros((uniq.shape[0], shape[-1])).index_add_(
        0, inv, rows)
    return torch.sparse_coo_tensor(uniq.unsqueeze(0), summed, tuple(shape),
                                   is_coalesced=True, check_invariants=False)


# ---------------------------------------------------------------------------
# constructors (reference mx.nd.sparse factory functions)
# ---------------------------------------------------------------------------
def _values(data, ctx, dtype) -> torch.Tensor:
    """Stored values on ``ctx``: where it is None an array keeps its
    device, anything else goes onto the default context."""
    t = _tensor(data, None if ctx is None else resolve(ctx))
    return t if dtype is None else t.to(_narrow_x32(resolve_dtype(dtype)))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``row_sparse_array((data, indices), shape)``, the rows sorted by
    index (duplicates kept, as the reference's), or a dense array's
    nonzero rows."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        if shape is None:
            raise ValueError("shape required for (data, indices) input")
        data = _values(arg1[0], ctx, dtype)
        indices = _tensor(arg1[1], data.device).reshape(-1).long()
        order = torch.sort(indices, stable=True).indices
        return RowSparseNDArray(data[order], indices[order], shape)
    return cast_storage(as_nd(arg1, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``csr_matrix((data, indices, indptr), shape)`` or a dense 2-D
    array's nonzeros."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        if shape is None:
            raise ValueError("shape required for (data, indices, indptr)")
        data = _values(arg1[0], ctx, dtype)
        return CSRNDArray(data, _tensor(arg1[1], data.device),
                          _tensor(arg1[2], data.device), shape)
    return cast_storage(as_nd(arg1, ctx=ctx, dtype=dtype), "csr")


def zeros(stype: str, shape, ctx=None, dtype="float32"):
    """An all-zero array of ``stype`` (no stored entries)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    dev = resolve(ctx)
    dt = _narrow_x32(resolve_dtype(dtype) or torch.float32)
    empty = torch.zeros((0,), dtype=_INDEX, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=dev), empty, shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev), empty,
                          torch.zeros((shape[0] + 1,), dtype=_INDEX,
                                      device=dev), shape)
    raise ValueError(f"unknown storage type {stype!r}")


def cast_storage(arr, stype: str):
    """Dense <-> sparse (reference ``cast_storage``): ``row_sparse`` keeps
    every row with a nonzero, ``csr`` every nonzero in row-major order."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    arr = as_nd(arr)
    if stype == "default":
        return arr
    a = arr._data.detach()
    if stype not in ("row_sparse", "csr"):
        raise ValueError(f"unknown storage type {stype!r}")
    _dynamic("cast_storage", a)
    if stype == "row_sparse":
        nz = (a.reshape(a.shape[0], -1) != 0).any(dim=1)
        rows = torch.arange(a.shape[0], device=a.device)[nz]
        return RowSparseNDArray(a[nz], rows, arr.shape)
    if a.dim() != 2:
        raise ValueError("csr storage is 2-D only")
    nz = a != 0
    counts = nz.sum(dim=1, dtype=_INDEX)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0,
                                                          dtype=_INDEX)])
    cols = torch.arange(a.shape[1], device=a.device).expand_as(a)[nz]
    return CSRNDArray(a[nz], cols, indptr, arr.shape)


def retain(arr: RowSparseNDArray, row_ids) -> RowSparseNDArray:
    return arr.retain(row_ids)


# ---------------------------------------------------------------------------
# sparse dot
# ---------------------------------------------------------------------------
@torch.no_grad()
def dot(lhs, rhs, transpose_a: bool = False) -> NDArray:
    """``sparse.dot``: csr . dense (and csr^T . dense) -> dense, a
    gather and a segment sum on the device (the reference's LibSVM linear
    models). A row-sparse ``lhs`` is densified. ``rhs`` is a 2-D dense
    array. Off the tape, as the reference's."""
    rhs = as_nd(rhs)._data.detach()
    if isinstance(lhs, CSRNDArray):
        if rhs.dim() != 2:
            raise ValueError(f"sparse.dot: a 2-D dense rhs, got shape "
                             f"{tuple(rhs.shape)}")
        rows = lhs._row_ids()
        cols = lhs._indices.long()
        dt = torch.result_type(lhs._data, rhs)
        data = lhs._data.to(dt).unsqueeze(1)
        if transpose_a:
            # (csr^T . rhs)[j] = sum over the entries of column j
            out = rhs.new_zeros((lhs._shape[1], rhs.shape[1]), dtype=dt)
            return NDArray(out.index_add_(0, cols, data * rhs[rows]))
        out = rhs.new_zeros((lhs._shape[0], rhs.shape[1]), dtype=dt)
        return NDArray(out.index_add_(0, rows, data * rhs[cols]))
    left = lhs.todense() if isinstance(lhs, RowSparseNDArray) else as_nd(lhs)
    return NDArray(torch.matmul(left._data.detach(), rhs))


def add(lhs, rhs):
    """row_sparse + row_sparse stays row-sparse; any other pair densifies."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _merge_row_sparse(lhs, rhs)
    left = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else as_nd(lhs)
    right = rhs.todense() if isinstance(rhs, BaseSparseNDArray) \
        else as_nd(rhs)
    return left + right


def elemwise_add(lhs, rhs):
    return add(lhs, rhs)
