"""``mx.np.fft``: numpy's FFT namespace over the ``fft`` ops
(``torch.fft``, cuFFT on the card)."""

from __future__ import annotations

from .. import ndarray as _nd


def fft(a, n=None, axis=-1, norm=None):
    return _nd.invoke_op("fft", a, n=n, axis=axis, norm=norm)


def ifft(a, n=None, axis=-1, norm=None):
    return _nd.invoke_op("ifft", a, n=n, axis=axis, norm=norm)


def rfft(a, n=None, axis=-1, norm=None):
    return _nd.invoke_op("rfft", a, n=n, axis=axis, norm=norm)


def irfft(a, n=None, axis=-1, norm=None):
    return _nd.invoke_op("irfft", a, n=n, axis=axis, norm=norm)


def fft2(a, s=None, axes=(-2, -1), norm=None):
    return _nd.invoke_op("fft2", a, s=s, axes=axes, norm=norm)


def ifft2(a, s=None, axes=(-2, -1), norm=None):
    return _nd.invoke_op("ifft2", a, s=s, axes=axes, norm=norm)


def fftn(a, s=None, axes=None, norm=None):
    return _nd.invoke_op("fftn", a, s=s, axes=axes, norm=norm)


def ifftn(a, s=None, axes=None, norm=None):
    return _nd.invoke_op("ifftn", a, s=s, axes=axes, norm=norm)


def fftshift(a, axes=None):
    return _nd.invoke_op("fftshift", a, axes=axes)


def ifftshift(a, axes=None):
    return _nd.invoke_op("ifftshift", a, axes=axes)
