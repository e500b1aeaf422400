"""Random sampling ops and the pdfs.

Counterpart of the JAX package's ``ops/random_ops.py`` (the reference's
``src/operator/random/``: ``sample_op.cc``, ``multisample_op.cc``,
``shuffle_op.cc``, ``pdf_op.cc``; ``mx.nd.random.*``). None is a TPU
kernel there, so each is plain PyTorch here.

A sampler takes ``rng``, the ``torch.Generator`` it draws from (the
package's generator of a device, which ``ndarray.invoke`` passes), and
draws on that generator's device. Every draw goes through it: the
samplers use the torch functions that take a ``generator`` and never
``torch.distributions``, whose ``sample()`` takes none. The draws are
not JAX's threefry draws: the tests hold the samplers by their
statistics. The ``random_pdf_*`` ops are deterministic and
differentiable.

``random_uniform`` and ``random_normal`` carry the aliases
``sample_uniform``/``sample_normal`` here, as in the reference; its
``ops/more.py`` registers its per-parameter samplers under those names
afterwards, and so does the port's (``ops/__init__.py`` imports this
module first).
"""

from __future__ import annotations

import math

import torch

from ..base import resolve_dtype
from .registry import register


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _full(value, shape, rng):
    """``value`` (a number or a tensor) broadcast to ``shape`` in fp32 on
    the generator's device."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=rng.device).expand(shape).contiguous()


def standard_gamma(alpha, rng):
    """Gamma(alpha, 1) draws, one per element of the fp32 ``alpha``."""
    return torch._standard_gamma(alpha, generator=rng)


def poisson(lam, rng):
    """Poisson(lam) draws, one per element of the fp32 ``lam``."""
    return torch.poisson(lam, generator=rng)


def exponential(shape, rng):
    """Exponential(1) draws of ``shape`` in fp32."""
    return torch.empty(shape, dtype=torch.float32,
                       device=rng.device).exponential_(generator=rng)


@register("random_uniform", differentiable=False, needs_rng=True,
          aliases=("uniform", "sample_uniform"))
def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", rng=None):
    u = torch.rand(_shape(shape), generator=rng, device=rng.device)
    return (u * (high - low) + low).to(resolve_dtype(dtype))


@register("random_normal", differentiable=False, needs_rng=True,
          aliases=("normal", "sample_normal"))
def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", rng=None):
    z = torch.randn(_shape(shape), generator=rng, device=rng.device)
    return (z * scale + loc).to(resolve_dtype(dtype))


@register("random_gamma", differentiable=False, needs_rng=True,
          aliases=("gamma_sample",))
def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", rng=None):
    """Shape ``alpha``, scale ``beta``."""
    g = standard_gamma(_full(alpha, _shape(shape), rng), rng)
    return (g * beta).to(resolve_dtype(dtype))


@register("random_exponential", differentiable=False, needs_rng=True,
          aliases=("exponential",))
def random_exponential(lam=1.0, shape=(1,), dtype="float32", rng=None):
    return (exponential(_shape(shape), rng) / lam).to(resolve_dtype(dtype))


@register("random_poisson", differentiable=False, needs_rng=True,
          aliases=("poisson",))
def random_poisson(lam=1.0, shape=(1,), dtype="float32", rng=None):
    return poisson(_full(lam, _shape(shape), rng), rng).to(
        resolve_dtype(dtype))


@register("random_randint", differentiable=False, needs_rng=True,
          aliases=("randint",))
def randint(low=0, high=10, shape=(1,), dtype="int32", rng=None):
    """Integers in [``low``, ``high``)."""
    return torch.randint(int(low), int(high), _shape(shape), generator=rng,
                         device=rng.device, dtype=resolve_dtype(dtype))


@register("random_bernoulli", differentiable=False, needs_rng=True,
          aliases=("bernoulli",))
def bernoulli(prob=0.5, shape=(1,), dtype="float32", rng=None):
    u = torch.rand(_shape(shape), generator=rng, device=rng.device)
    return (u < prob).to(resolve_dtype(dtype))


@register("sample_multinomial", differentiable=False, needs_rng=True,
          aliases=("multinomial", "random_categorical"))
def multinomial(data, shape=(), get_prob=False, dtype="int32", rng=None):
    """Category indices drawn from each row of ``data`` (..., k): weights
    ``max(p, 1e-37)``, so a row need not sum to 1. The result is
    ``data.shape[:-1] + shape``, the ``shape`` draws last. The
    reference's ``get_prob`` returns no probabilities there either."""
    extra = _shape(shape)
    n = math.prod(extra)
    k = data.shape[-1]
    w = data.reshape(-1, k).float().clamp_min(1e-37)
    idx = torch.multinomial(w, n, replacement=True, generator=rng)
    return idx.reshape(data.shape[:-1] + extra).to(resolve_dtype(dtype))


@register("shuffle", differentiable=False, needs_rng=True)
def shuffle(x, rng=None):
    """``x`` with its rows (axis 0) permuted."""
    return x[torch.randperm(x.shape[0], generator=rng, device=x.device)]


def _negative_binomial(k, p, shape, dtype, rng):
    """The gamma-Poisson mixture: lam ~ Gamma(k, (1 - p) / p), X ~
    Poisson(lam)."""
    lam = standard_gamma(_full(k, shape, rng), rng) * (1 - p) / p
    return poisson(lam, rng).to(resolve_dtype(dtype))


@register("random_negative_binomial", differentiable=False, needs_rng=True,
          aliases=("sample_negative_binomial", "negative_binomial"))
def random_negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32",
                             rng=None):
    """Failures before the ``k``-th success of probability ``p``."""
    return _negative_binomial(float(k), float(p), _shape(shape), dtype, rng)


@register("random_generalized_negative_binomial", differentiable=False,
          needs_rng=True,
          aliases=("sample_generalized_negative_binomial",
                   "generalized_negative_binomial"))
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                         dtype="float32", rng=None):
    """Mean ``mu``, dispersion ``alpha``: k = 1/alpha, p = k/(k + mu)."""
    k = 1.0 / float(alpha)
    return _negative_binomial(k, k / (k + float(mu)), _shape(shape), dtype,
                              rng)


# -- the pdfs (reference pdf_op.cc) -------------------------------------------
def _maybe_log(v, is_log):
    return v if is_log else torch.exp(v)


@register("random_pdf_uniform")
def random_pdf_uniform(sample, low, high, is_log=False):
    inside = (sample >= low) & (sample <= high)
    logpdf = torch.where(inside, -torch.log(high - low),
                         torch.full_like(sample, -math.inf))
    return _maybe_log(logpdf, is_log)


@register("random_pdf_normal")
def random_pdf_normal(sample, mu, sigma, is_log=False):
    z = (sample - mu) / sigma
    logpdf = -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2 * math.pi)
    return _maybe_log(logpdf, is_log)


@register("random_pdf_gamma")
def random_pdf_gamma(sample, alpha, beta, is_log=False):
    """Shape ``alpha``, rate ``beta`` (reference ``PDF_Gamma``)."""
    logpdf = (alpha * torch.log(beta) + (alpha - 1) * torch.log(sample)
              - beta * sample - torch.lgamma(alpha))
    return _maybe_log(logpdf, is_log)


@register("random_pdf_exponential")
def random_pdf_exponential(sample, lam, is_log=False):
    return _maybe_log(torch.log(lam) - lam * sample, is_log)


@register("random_pdf_poisson")
def random_pdf_poisson(sample, lam, is_log=False):
    logpdf = sample * torch.log(lam) - lam - torch.lgamma(sample + 1.0)
    return _maybe_log(logpdf, is_log)


@register("random_pdf_negative_binomial")
def random_pdf_negative_binomial(sample, k, p, is_log=False):
    """P(X=x) = C(x+k-1, x) p^k (1-p)^x: ``k`` successes of probability
    ``p``."""
    logpdf = (torch.lgamma(sample + k) - torch.lgamma(sample + 1.0)
              - torch.lgamma(k) + k * torch.log(p)
              + sample * torch.log1p(-p))
    return _maybe_log(logpdf, is_log)


@register("random_pdf_generalized_negative_binomial")
def random_pdf_generalized_negative_binomial(sample, mu, alpha,
                                             is_log=False):
    """Mean ``mu``, dispersion ``alpha``: k = 1/alpha, p = k/(k+mu)."""
    k = 1.0 / alpha
    return random_pdf_negative_binomial(sample, k, k / (k + mu), is_log)


@register("random_pdf_dirichlet")
def random_pdf_dirichlet(sample, alpha, is_log=False):
    """Over the last axis of ``sample`` and ``alpha``."""
    logpdf = (((alpha - 1) * torch.log(sample)).sum(-1)
              + torch.lgamma(alpha.sum(-1)) - torch.lgamma(alpha).sum(-1))
    return _maybe_log(logpdf, is_log)
