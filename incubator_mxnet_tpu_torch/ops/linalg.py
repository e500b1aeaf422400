"""The linear-algebra operator family (``mx.nd.linalg``).

Counterpart of the JAX package's ``ops/linalg.py`` (the reference's
``src/operator/tensor/la_op.cc``): gemm, syrk, potrf, potri, trmm, trsm,
sumlogdiag, gelqf, syevd, inverse, det, slogdet and the diagonal and
triangle packers, each batched over the leading dimensions (they act on
the trailing two). They run on ``torch.linalg`` (cuSOLVER and cuBLAS on
the card). ``linalg_gelqf`` returns ``(Q, L)`` with ``A = L Q``, and
``linalg_syevd`` ``(U, L)`` with the eigenvectors as the rows of U, as the
reference does. ``linalg_gemm2`` is ``ops/tensor.py``'s.
"""

from __future__ import annotations

import torch

from .fft_ops import symmetrize
from .registry import register


def _t(a):
    return torch.swapaxes(a, -1, -2)


@register("linalg_gemm")
def linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha * op(A) op(B) + beta * C."""
    if axis != -2:
        raise NotImplementedError(
            "linalg_gemm: only the default axis=-2 (trailing matrix dims) "
            "is implemented; transpose your batch layout instead")
    a_ = _t(a) if transpose_a else a
    b_ = _t(b) if transpose_b else b
    return alpha * torch.matmul(a_, b_) + beta * c


@register("linalg_syrk")
def linalg_syrk(a, transpose=False, alpha=1.0):
    """alpha * A Aᵀ (or Aᵀ A where ``transpose``)."""
    a_ = _t(a) if transpose else a
    return alpha * torch.matmul(a_, _t(a_))


@register("linalg_potrf")
def linalg_potrf(a):
    """The lower Cholesky factor L of an SPD matrix: A = L Lᵀ (of ``(A +
    Aᵀ) / 2``, as the reference)."""
    return torch.linalg.cholesky(symmetrize(a))


@register("linalg_potri")
def linalg_potri(a):
    """The inverse of B = A Aᵀ from its Cholesky factor A (lower)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trmm")
def linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha * op(A) B (or B op(A)), A's triangle alone."""
    tri = torch.tril(a) if lower else torch.triu(a)
    tri = _t(tri) if transpose else tri
    out = torch.matmul(b, tri) if rightside else torch.matmul(tri, b)
    return alpha * out


@register("linalg_trsm")
def linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha * op(A)⁻¹ B (or B op(A)⁻¹), A's triangle alone."""
    upper = not lower
    if transpose:
        a, upper = _t(a), lower
    x = torch.linalg.solve_triangular(a, b, upper=upper, left=not rightside)
    return alpha * x


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    """The sum of the logs of the diagonal (a Cholesky factor's log-det)."""
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_gelqf")
def linalg_gelqf(a):
    """The LQ factorization A = L Q (Q with orthonormal rows): ``(Q, L)``,
    from the QR factorization of Aᵀ."""
    q_t, r_t = torch.linalg.qr(_t(a))
    return _t(q_t), _t(r_t)


@register("linalg_syevd")
def linalg_syevd(a):
    """``(U, L)`` with A = Uᵀ diag(L) U: the eigenvectors are U's rows."""
    w, v = torch.linalg.eigh(symmetrize(a))
    return _t(v), w


@register("linalg_inverse", aliases=("inverse",))
def linalg_inverse(a):
    return torch.linalg.inv(a)


@register("linalg_det", aliases=("det",))
def linalg_det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet", aliases=("slogdet",))
def linalg_slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("linalg_extractdiag")
def linalg_extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(d, offset=0):
    """A (batch of) square matrix with ``d`` on its ``offset`` diagonal."""
    n = d.shape[-1] + abs(offset)
    out = torch.zeros(d.shape[:-1] + (n, n), dtype=d.dtype, device=d.device)
    idx = torch.arange(d.shape[-1], device=d.device)
    out[..., idx + max(0, -offset), idx + max(0, offset)] = d
    return out


def _triangle(n, offset, lower, device):
    """The row-major positions of a triangle with ``offset`` diagonals (as
    ``np.tril_indices(n, k=offset)`` / ``np.triu_indices``)."""
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


def _triangle_count(n, offset, lower):
    """The count of positions ``_triangle`` gives."""
    if lower:
        return sum(max(0, min(n, i + offset + 1)) for i in range(n))
    return sum(max(0, n - max(0, i + offset)) for i in range(n))


@register("linalg_extracttrian")
def linalg_extracttrian(a, offset=0, lower=True):
    """A triangle (with ``offset`` diagonals) as a packed row-major
    vector."""
    rows, cols = _triangle(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


@register("linalg_maketrian")
def linalg_maketrian(d, offset=0, lower=True):
    """The inverse of ``extracttrian``: n is the size whose triangle holds
    as many values as ``d``'s last axis."""
    k = d.shape[-1]
    n = 1
    while _triangle_count(n, offset, lower) != k:
        n += 1
        if n > 4096:
            raise ValueError("cannot infer matrix size from packed length")
    rows, cols = _triangle(n, offset, lower, d.device)
    out = torch.zeros(d.shape[:-1] + (n, n), dtype=d.dtype, device=d.device)
    out[..., rows, cols] = d
    return out
