"""Port parity: the flash-attention backward.

``flash_attention_bwd_reference`` (the plain version of the port's two
backward CUDA kernels, and what a CPU tensor runs) against the JAX
package's Pallas backward ``_flash_bwd`` run in interpret mode, fed the same
lse and delta (taken from the JAX forward); then the port's autograd
Function end to end against ``jax.vjp`` of the JAX ``flash_attention``
with the same cotangent. Both sides compute in fp32 and differ only in the
order of their sums: 1e-4 abs / 1e-5 rel (gradients reach ~10 here, a sum
over up to 56 keys or queries of O(1) terms).

The CUDA kernels themselves are held against this plain version in
``tests/test_torch_flash_kernel.py`` (on a card) and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import pallas_attention as pa

import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 1e-4, 1e-5

# (name, b, h, tq, tk, d, causal, cache_offset, lengths): every forward case
# of tests/test_torch_flash_attention.py
CASES = [
    ("square_causal_d32", 2, 3, 40, 40, 32, True, False, None),
    ("square_causal_d64", 1, 2, 37, 37, 64, True, False, None),
    ("tq_lt_tk_causal", 2, 2, 24, 56, 32, True, False, None),
    ("lengths", 3, 2, 19, 56, 64, False, False, [56, 17, 1]),
    ("lengths_causal", 2, 2, 30, 30, 32, True, False, [30, 11]),
    ("cache_offset_tq1", 3, 2, 1, 48, 64, True, True, [48, 20, 1]),
    ("cache_offset_tq3", 3, 2, 3, 48, 32, True, True, [48, 20, 3]),
    ("masked_row_zero_len", 2, 2, 9, 21, 32, False, False, [0, 21]),
    ("masked_rows_tq_gt_tk", 1, 2, 20, 8, 32, True, False, None),
]


def _inputs(b, h, tq, tk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, tq, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32),
            rs.randn(b, h, tq, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_backward(case):
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v, g = _inputs(b, h, tq, tk, d)
    scale = 1.0 / np.sqrt(d)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jl = None if lens is None else jnp.asarray(lens)
    out, lse = pa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jl, scale, causal, True, return_lse=True,
                             cache_offset=cache_offset)
    delta = jnp.sum(jnp.asarray(g) * out, axis=-1)
    want = pa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
                         lse, delta, jnp.asarray(g), scale, causal, True,
                         cache_offset=cache_offset)
    got = fa.flash_attention_bwd_reference(
        *_t(q, k, v), None if lens is None else torch.from_numpy(lens),
        *_t(lse, delta, g), causal=causal, cache_offset=cache_offset)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the split plain versions the card compares each kernel with
    args = (*_t(q, k, v), None if lens is None else torch.from_numpy(lens),
            *_t(lse, delta, g))
    kw = dict(causal=causal, cache_offset=cache_offset)
    assert torch.equal(fa.flash_bwd_dq(*args, **kw), got[0])
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_jax_vjp(case):
    """torch autograd through the port's ``flash_attention`` (the autograd
    Function) against ``jax.vjp`` of the JAX ``flash_attention``."""
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v, g = _inputs(b, h, tq, tk, d, seed=4)
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def jfn(q_, k_, v_):
        return pa.flash_attention(
            q_, k_, v_, None if lens is None else jnp.asarray(lens),
            causal=causal, interpret=True, cache_offset=cache_offset)

    want_o, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = (t.requires_grad_(True) for t in _t(q, k, v))
    fa.flash_fwd_launches = 0
    out = fa.flash_attention(tq_, tk_, tv_,
                             None if lens is None else torch.from_numpy(lens),
                             causal=causal, cache_offset=cache_offset)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=RTOL, atol=ATOL)
    for name, x, y in zip(("dq", "dk", "dv"), (tq_, tk_, tv_), want):
        assert torch.isfinite(x.grad).all(), name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert fa.flash_fwd_launches == 0          # CPU: the plain version ran


def test_fully_masked_rows_give_zero_gradients_and_no_nan():
    q, k, v, g = _inputs(2, 2, 20, 8, 32, seed=2)
    tq_, tk_, tv_ = (t.requires_grad_(True) for t in _t(q, k, v))
    # bottom-right causal with tq > tk: rows 0..11 see no key
    fa.flash_attention(tq_, tk_, tv_, causal=True).backward(
        torch.from_numpy(g))
    assert torch.all(tq_.grad[:, :, :12] == 0)
    assert torch.any(tq_.grad[:, :, 12:] != 0)
    for t in (tq_, tk_, tv_):
        assert not torch.isnan(t.grad).any()
    # a length-0 batch entry: no key at all, every gradient of it is 0
    q, k, v, g = _inputs(2, 2, 5, 7, 32, seed=3)
    tq_, tk_, tv_ = (t.requires_grad_(True) for t in _t(q, k, v))
    fa.flash_attention(tq_, tk_, tv_, torch.tensor([0, 7])).backward(
        torch.from_numpy(g))
    for t in (tq_, tk_, tv_):
        assert torch.all(t.grad[0] == 0) and torch.isfinite(t.grad).all()
        assert torch.any(t.grad[1] != 0)


def test_no_grad_path_skips_the_function():
    q, k, v, _ = _inputs(1, 2, 6, 6, 32)
    tq_, tk_, tv_ = (t.requires_grad_(True) for t in _t(q, k, v))
    with torch.no_grad():
        out = fa.flash_attention(tq_, tk_, tv_, causal=True)
    assert out.grad_fn is None
    out, lse = fa.flash_attention(tq_, tk_, tv_, causal=True,
                                  return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad
