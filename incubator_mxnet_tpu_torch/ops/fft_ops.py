"""The FFT family, the complex parts, and the rest of ``np.linalg``.

Counterpart of the JAX package's ``ops/fft_ops.py`` (the reference's
contrib ``fft``/``ifft`` and the 2.x ``mx.np.linalg`` namespace). The
FFTs run on ``torch.fft`` (cuFFT on the card) and give complex64 for a
real or complex64 operand; the factorizations run on ``torch.linalg``
(cuSOLVER on the card) on the operand's own device. The JAX package's
host fallback for one TPU backend has no counterpart: nothing here leaves
the operand's device.

Where jnp's answer is not ``torch.linalg``'s default, the op gives jnp's:
``linalg_lstsq`` solves through the SVD (the minimum-norm solution of a
rank-deficient system, jnp's ``rcond``) and returns ``(x, resid, rank,
s)`` with the residuals always computed; ``linalg_pinv`` cuts at
``10 * max(M, N) * eps * s_max``; ``linalg_matrix_rank`` counts the
singular values above ``s_max * max(M, N) * eps`` (or ``tol``);
``linalg_cond`` is a ratio of singular values for ``p`` None, 2 or -2,
else a product of norms, inf where it is NaN without a NaN input;
``linalg_eigh``, ``linalg_eigvalsh`` and ``linalg_cholesky`` factor
``(A + Aᴴ) / 2``, whatever ``UPLO`` says;
``linalg_qr(mode="r")`` returns R alone and ``linalg_svd(compute_uv=
False)`` the singular values alone.
"""

from __future__ import annotations

import math

import torch

from .numpy_ops import _float
from .registry import register


def _tuple(v):
    return None if v is None else tuple(v)


# --- fft ---------------------------------------------------------------------
@register("fft")
def fft(x, n=None, axis=-1, norm=None):
    return torch.fft.fft(_float(x), n=n, dim=axis, norm=norm)


@register("ifft")
def ifft(x, n=None, axis=-1, norm=None):
    return torch.fft.ifft(_float(x), n=n, dim=axis, norm=norm)


@register("rfft")
def rfft(x, n=None, axis=-1, norm=None):
    return torch.fft.rfft(_float(x), n=n, dim=axis, norm=norm)


@register("irfft")
def irfft(x, n=None, axis=-1, norm=None):
    return torch.fft.irfft(_float(x), n=n, dim=axis, norm=norm)


@register("fft2")
def fft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.fft2(_float(x), s=_tuple(s), dim=tuple(axes),
                          norm=norm)


@register("ifft2")
def ifft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.ifft2(_float(x), s=_tuple(s), dim=tuple(axes),
                           norm=norm)


@register("fftn")
def fftn(x, s=None, axes=None, norm=None):
    return torch.fft.fftn(_float(x), s=_tuple(s), dim=_tuple(axes),
                          norm=norm)


@register("ifftn")
def ifftn(x, s=None, axes=None, norm=None):
    return torch.fft.ifftn(_float(x), s=_tuple(s), dim=_tuple(axes),
                           norm=norm)


@register("fftshift")
def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=_tuple(axes))


@register("ifftshift")
def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=_tuple(axes))


@register("real")
def real(x):
    return torch.real(x) if x.is_complex() else x


@register("imag")
def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@register("conj")
def conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


@register("angle")
def angle(x):
    return torch.angle(_float(x))


@register("absolute_complex", aliases=("complex_abs",))
def absolute_float(x):
    return torch.abs(x)


# --- np.linalg completions ---------------------------------------------------
@register("linalg_norm")
def linalg_norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    x = _float(x)
    if axis is None and ord is None:
        out = torch.linalg.vector_norm(x.reshape(-1), 2)
        return out.reshape((1,) * x.dim()) if keepdims else out
    dim = axis if axis is None or isinstance(axis, int) else tuple(axis)
    return torch.linalg.norm(x, ord=ord, dim=dim, keepdim=keepdims)


@register("linalg_solve")
def linalg_solve(a, b):
    """numpy 2's rule: ``b`` is a vector only where it is 1-D, else a
    (batch of) matrix."""
    a, b = _float(a), _float(b)
    if b.dim() > 1 and tuple(b.shape) == tuple(a.shape[:-1]):
        # torch would read this ``b`` as a batch of vectors
        return torch.linalg.lu_solve(*torch.linalg.lu_factor(a), b)
    return torch.linalg.solve(a, b)


@register("linalg_lstsq", differentiable=False)
def linalg_lstsq(a, b, rcond=None):
    """jnp's ``lstsq``: ``(x, resid, rank, s)`` through the SVD; singular
    values below ``rcond * s_max`` (jnp's default ``eps * max(M, N)``)
    count as zero, so a rank-deficient system gets the minimum-norm x."""
    a, b = _float(a), _float(b)
    vector = b.dim() == 1
    if vector:
        b = b[:, None]
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    if rcond is None:
        rcond = eps * max(n, m)
    elif rcond < 0:
        rcond = eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    x = torch.matmul(vt.conj().T, s_inv * torch.matmul(u.conj().T, b))
    resid = torch.linalg.vector_norm(b - torch.matmul(a, x), dim=0) ** 2
    return (x.reshape(-1) if vector else x), resid, rank, s


@register("linalg_qr")
def linalg_qr(a, mode="reduced"):
    """``(q, r)``, or R alone for ``mode="r"``."""
    q, r = torch.linalg.qr(_float(a), mode=mode)
    return r if mode == "r" else (q, r)


@register("linalg_svd")
def linalg_svd(a, full_matrices=True, compute_uv=True):
    a = _float(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    return tuple(torch.linalg.svd(a, full_matrices=full_matrices))


def symmetrize(a):
    """``(A + Aᴴ) / 2``: jnp's ``eigh``, ``eigvalsh`` and ``cholesky``
    factor that, so ``UPLO`` names no triangle and the gradient is
    symmetric."""
    a = _float(a)
    return (a + a.mT.conj()) / 2


@register("linalg_eigh")
def linalg_eigh(a, UPLO="L"):  # noqa: N803 (numpy's name)
    return tuple(torch.linalg.eigh(symmetrize(a), UPLO=UPLO))


@register("linalg_eigvalsh")
def linalg_eigvalsh(a, UPLO="L"):  # noqa: N803
    return torch.linalg.eigvalsh(symmetrize(a), UPLO=UPLO)


@register("linalg_cholesky")
def linalg_cholesky(a):
    return torch.linalg.cholesky(symmetrize(a))


@register("linalg_pinv")
def linalg_pinv(a, rcond=None):
    """Singular values at or below ``rcond * s_max`` dropped; jnp's
    default ``rcond`` is ``10 * max(M, N) * eps``."""
    a = _float(a)
    if rcond is None:
        rcond = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rcond)


@register("linalg_matrix_rank", differentiable=False)
def linalg_matrix_rank(a, tol=None):
    """The count of singular values above ``tol`` (jnp's default: ``s_max *
    max(M, N) * eps``); a vector's rank is whether it has a nonzero."""
    a = _float(a)
    if a.dim() < 2:
        return (a != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(a)
    if tol is None:
        tol = s.amax(-1) * max(a.shape[-2:]) * torch.finfo(s.dtype).eps
    tol = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return torch.sum(s > tol.unsqueeze(-1), dim=-1).to(torch.int32)


@register("linalg_matrix_power")
def linalg_matrix_power(a, n=1):
    return torch.linalg.matrix_power(a, n)


@register("linalg_multi_dot")
def linalg_multi_dot(*arrays):
    return torch.linalg.multi_dot(list(arrays))


@register("linalg_cond", differentiable=False)
def linalg_cond(a, p=None):
    a = _float(a)
    if p is None or p == 2 or p == -2:
        s = torch.linalg.svdvals(a)
        r = s[..., 0] / s[..., -1] if p != -2 else s[..., -1] / s[..., 0]
    else:
        r = torch.linalg.matrix_norm(a, ord=p) \
            * torch.linalg.matrix_norm(torch.linalg.inv(a), ord=p)
    no_nan = ~torch.isnan(a).any(-1).any(-1)
    return torch.where(torch.isnan(r) & no_nan, torch.full_like(r, math.inf),
                       r)


@register("linalg_tensorsolve")
def linalg_tensorsolve(a, b):
    return torch.linalg.tensorsolve(_float(a), _float(b))


@register("linalg_tensorinv")
def linalg_tensorinv(a, ind=2):
    return torch.linalg.tensorinv(_float(a), ind=ind)
