"""``mx.np.linalg`` (the reference's ``python/mxnet/numpy/linalg.py``):
numpy's signatures over the ``linalg_*`` ops, which run on the operand's
device."""

from __future__ import annotations

from .. import ndarray as _nd


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return _nd.invoke_op("linalg_norm", x, ord=ord, axis=axis,
                         keepdims=keepdims)


def solve(a, b):
    return _nd.invoke_op("linalg_solve", a, b)


def lstsq(a, b, rcond=None):
    return _nd.invoke_op("linalg_lstsq", a, b, rcond=rcond)


def qr(a, mode="reduced"):
    return _nd.invoke_op("linalg_qr", a, mode=mode)


def svd(a, full_matrices=True, compute_uv=True):
    return _nd.invoke_op("linalg_svd", a, full_matrices=full_matrices,
                         compute_uv=compute_uv)


def eigh(a, UPLO="L"):  # noqa: N803 (numpy's name)
    return _nd.invoke_op("linalg_eigh", a, UPLO=UPLO)


def eigvalsh(a, UPLO="L"):  # noqa: N803
    return _nd.invoke_op("linalg_eigvalsh", a, UPLO=UPLO)


def cholesky(a):
    return _nd.invoke_op("linalg_cholesky", a)


def inv(a):
    return _nd.invoke_op("linalg_inverse", a)


def det(a):
    return _nd.invoke_op("linalg_det", a)


def slogdet(a):
    return _nd.invoke_op("linalg_slogdet", a)


def pinv(a, rcond=None):
    return _nd.invoke_op("linalg_pinv", a, rcond=rcond)


def matrix_rank(a, tol=None):
    return _nd.invoke_op("linalg_matrix_rank", a, tol=tol)


def matrix_power(a, n):
    return _nd.invoke_op("linalg_matrix_power", a, n=n)


def multi_dot(arrays):
    return _nd.invoke_op("linalg_multi_dot", *arrays)


def cond(a, p=None):
    return _nd.invoke_op("linalg_cond", a, p=p)


def tensorsolve(a, b):
    return _nd.invoke_op("linalg_tensorsolve", a, b)


def tensorinv(a, ind=2):
    return _nd.invoke_op("linalg_tensorinv", a, ind=ind)
