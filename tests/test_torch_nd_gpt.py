"""Port parity: a GPT training step written only in ``mx.nd`` ops.

``chip_smoke.nd_gpt_step`` (the function ``chip_smoke.py`` runs on the card
at GPT-117M's width) is written against the ``mx`` API alone: token and
position ``Embedding``, per layer ``LayerNorm``, ``FullyConnected``,
``split`` of the fused QKV projection, ``reshape``/``transpose`` to
(B, H, T, D), ``flash_attention(causal=True)``, ``gelu``, ``Dropout`` and
the residual adds, the final ``LayerNorm`` and the head, and the loss of
``SoftmaxOutput(normalization="valid")`` under ``autograd.record()``. It
runs once with each package at 2 layers, 64 units, 4 heads, vocabulary
97, B=2, T=16, on the same weights drawn from a seed. The JAX package's
``flash_attention`` runs as ``tests/test_torch_ndarray.py``'s
``test_nd_flash_attention_matches_jax`` runs it (its XLA reference at this
length), the port's its plain version on the CPU. The loss agrees to
1e-5 relative and every gradient to 1e-5 relative L2 (fp32 in another
order of operations).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAYERS, UNITS, HEADS, VOCAB, B, T = 2, 64, 4, 97, 2, 16
RTOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(seed=0):
    """The decoder's parameters by name (shapes from the port's
    ``gpt_decoder_tiny``), drawn from ``seed``: LayerNorm gains near 1,
    the rest small."""
    net = get_gpt("gpt_decoder_tiny", vocab_size=VOCAB, units=UNITS,
                  num_layers=LAYERS, num_heads=HEADS, max_length=T,
                  dropout=0.0)
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in net.named_parameters():
        w = rs.randn(*p.shape).astype(np.float32)
        out[name] = 1 + 0.1 * w if name.endswith("gamma") else 0.1 * w
    return out


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def test_nd_gpt_step_matches_jax():
    cs = _chip_smoke()
    weights = _weights()
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, VOCAB, (B, T)).astype(np.float32)
    labels = rs.randint(0, VOCAB, (B * T,)).astype(np.float32)
    res = {}
    for pkg in (jmx, mx):
        params = {n: pkg.nd.array(w) for n, w in weights.items()}
        for p in params.values():
            p.attach_grad()
        loss = cs.nd_gpt_step(pkg, params, pkg.nd.array(tokens),
                              pkg.nd.array(labels), LAYERS, HEADS)
        res[pkg] = loss, {n: p.grad.asnumpy() for n, p in params.items()}
    (loss, grads), (want_loss, want_grads) = res[mx], res[jmx]
    assert np.isfinite(loss) and abs(loss - want_loss) <= RTOL * want_loss
    assert len(grads) == 29
    for name, g in grads.items():
        want = want_grads[name]
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert err <= RTOL, (name, err)
