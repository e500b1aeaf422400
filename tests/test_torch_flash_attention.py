"""Port parity: flash attention.

``flash_attention_reference`` (the plain version of the port's CUDA kernel,
and what a CPU tensor runs) against the JAX package's Pallas flash kernel
run in interpret mode, on the same numpy inputs. Both sides compute in full
fp32 and differ only in the order of their sums, hence 2e-5 abs / 1e-5 rel.

The CUDA kernel itself is held against this plain version in
``tests/test_torch_flash_kernel.py`` (on a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_attention as pa

import incubator_mxnet_tpu_torch  # noqa: F401  (TF32 off at import)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-5


def _inputs(b, h, tq, tk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, tq, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32),
            rs.randn(b, h, tk, d).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (name, b, h, tq, tk, d, causal, cache_offset, lengths)
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_kernel_with_lse(case):
    _, b, h, tq, tk, d, causal, cache_offset, lengths = case
    q, k, v = _inputs(b, h, tq, tk, d)
    scale = 1.0 / np.sqrt(d)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want_o, want_lse = pa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), scale, causal, True,
        return_lse=True, cache_offset=cache_offset)
    got_o, got_lse = fa.flash_attention_reference(
        *_torch(q, k, v), None if lens is None else torch.from_numpy(lens),
        causal=causal, cache_offset=cache_offset, return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=RTOL, atol=ATOL)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    q, k, v = _inputs(2, 2, 20, 8, 32)
    out, lse = fa.flash_attention_reference(*_torch(q, k, v), causal=True,
                                            return_lse=True)
    # bottom-right causal with tq > tk: rows 0..11 see no key
    assert torch.all(out[:, :, :12] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :12]))
    assert torch.all(torch.isfinite(lse[:, :, 12:]))
    q, k, v = _inputs(2, 2, 5, 7, 32)
    out, lse = fa.flash_attention_reference(
        *_torch(q, k, v), torch.tensor([0, 7]), return_lse=True)
    assert torch.all(out[0] == 0) and torch.all(torch.isneginf(lse[0]))
    assert not torch.isnan(out).any()


@pytest.mark.parametrize("cache_offset", [False, True])
def test_public_entry_matches_jax_flash_attention(cache_offset):
    """The public ``flash_attention`` contract on a CPU tensor (default
    scale; cache_offset implies causal) against the JAX entry point."""
    b, h, tq, tk, d = 2, 3, (2 if cache_offset else 33), 33, 64
    q, k, v = _inputs(b, h, tq, tk, d, seed=3)
    lens = np.asarray([33, 9], np.int32)
    want = pa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), causal=not cache_offset,
                              interpret=True, cache_offset=cache_offset)
    got = fa.flash_attention(*_torch(q, k, v), torch.from_numpy(lens),
                             causal=not cache_offset,
                             cache_offset=cache_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
