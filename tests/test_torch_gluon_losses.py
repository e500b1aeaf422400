"""Port parity: the gluon losses of slice 21 against the JAX package's,
on the CPU.

Each loss is built in both packages with the same arguments and run on
the same numpy inputs drawn from a seed: the JAX side on NDArrays under
``autograd.record()``, the port on tensors. Compared: the per-sample
loss, and the gradients of ``sum(loss * g)`` with respect to every float
input, for ``weight``, ``sample_weight`` and ``batch_axis`` where the
loss takes them. ``SigmoidBinaryCrossEntropyLoss``'s ``pos_weight`` and
``CTCLoss``'s ``label_layout="TN"``, which the JAX package takes and
leaves out, are held against MXNet's formula (numpy) and the ``"NT"``
result on transposed labels.

Tolerance: ``ND_TOL`` (1e-5 relative, 1e-6 absolute), fp32 on both
sides.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon

ND_TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _signs(seed, *shape):
    return np.where(_rand(seed, *shape) > 0, 1.0, -1.0).astype(np.float32)


def _run_jax(loss, arrays, grads_of):
    nds = [None if a is None else jmx.nd.array(a) for a in arrays]
    for i in grads_of:
        nds[i].attach_grad()
    with jmx.autograd.record():
        out = loss(*nds)
        g = np.random.RandomState(99).uniform(0.5, 1.5, out.shape).astype(
            np.float32)
        head = (out * jmx.nd.array(g)).sum()
    head.backward()
    return out.asnumpy(), [nds[i].grad.asnumpy() for i in grads_of], g


def _run_port(loss, arrays, grads_of, g):
    ts = [None if a is None else torch.from_numpy(a.copy()) for a in arrays]
    for i in grads_of:
        ts[i].requires_grad_(True)
    with mx.autograd.record():
        out = loss(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [ts[i].grad.numpy() for i in grads_of]


def _check(name, args, arrays, grads_of=(0,)):
    want, want_grads, g = _run_jax(getattr(jgluon.loss, name)(**args),
                                   arrays, grads_of)
    got, got_grads = _run_port(getattr(gluon.loss, name)(**args), arrays,
                               grads_of, g)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **ND_TOL)
    for i, a, b in zip(grads_of, got_grads, want_grads):
        np.testing.assert_allclose(a, b, err_msg=f"gradient of input {i}",
                                   **ND_TOL)
    return got


_P = _rand(1, 4, 3, lo=-3.0, hi=3.0)          # logits, rates in log space
_PROB = _rand(2, 4, 3, lo=0.05, hi=0.95)
_Y01 = (_rand(3, 4, 3) > 0).astype(np.float32)
_SW = _rand(4, 4, 1, lo=0.2, hi=1.0)
_SW_AXIS1 = _rand(5, 1, 3, lo=0.2, hi=1.0)
_LOGP = np.log(np.random.RandomState(6).dirichlet(np.ones(5), 4)).astype(
    np.float32)
_Q = np.random.RandomState(7).dirichlet(np.ones(5), 4).astype(np.float32)
_SIGNED = _signs(8, 4, 3)
_A, _POS, _NEG = (_rand(9 + i, 4, 2, 3) for i in range(3))
_COUNTS = np.random.RandomState(12).poisson(2.0, (4, 3)).astype(np.float32)
_RATES = _rand(13, 4, 3, lo=0.2, hi=3.0)

# (loss, constructor arguments, inputs, inputs differentiated)
LOSS_CASES = {
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}, [_P, _Y01], (0,)),
    "sigmoid_bce_weighted": ("SigmoidBinaryCrossEntropyLoss",
                             dict(weight=0.5), [_P, _Y01, _SW], (0,)),
    "sigmoid_bce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                                 dict(from_sigmoid=True), [_PROB, _Y01],
                                 (0,)),
    "sigmoid_bce_batch_axis1": ("SigmoidBCELoss", dict(batch_axis=1),
                                [_P, _Y01, _SW_AXIS1], (0,)),
    "kldiv_from_logits": ("KLDivLoss", {}, [_LOGP, _Q], (0,)),
    "kldiv_logits": ("KLDivLoss", dict(from_logits=False, axis=1,
                                       weight=2.0), [_LOGP * 3, _Q], (0,)),
    "huber": ("HuberLoss", dict(rho=0.5), [_P, _P * 0.5 + _rand(14, 4, 3),
                                           _SW], (0, 1)),
    "hinge": ("HingeLoss", {}, [_P, _SIGNED], (0,)),
    "hinge_margin_axis1": ("HingeLoss", dict(margin=2.0, batch_axis=1),
                           [_P, _SIGNED, _SW_AXIS1], (0,)),
    "squared_hinge": ("SquaredHingeLoss", dict(margin=1.5, weight=0.3),
                      [_P, _SIGNED, _SW], (0,)),
    "logistic_signed": ("LogisticLoss", {}, [_P, _SIGNED], (0,)),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        [_P, _Y01, _SW], (0,)),
    "triplet": ("TripletLoss", dict(margin=0.5), [_A, _POS, _NEG],
                (0, 1, 2)),
    "triplet_weighted": ("TripletLoss", dict(weight=2.0),
                         [_A, _POS, _NEG, _rand(15, 4, lo=0.2)], (0, 1, 2)),
    "cosine": ("CosineEmbeddingLoss", dict(margin=0.2),
               [_A, _POS, _signs(16, 4)], (0, 1)),
    "cosine_weighted": ("CosineEmbeddingLoss", dict(weight=0.5),
                        [_A, _NEG, _signs(17, 4), _rand(18, 4, lo=0.2)],
                        (0, 1)),
    "poisson_logits": ("PoissonNLLLoss", {}, [_P, _COUNTS], (0,)),
    "poisson_rates_full": ("PoissonNLLLoss", dict(from_logits=False,
                                                  compute_full=True),
                           [_RATES, _COUNTS, _SW], (0,)),
    "sdml": ("SDMLLoss", dict(smoothing_parameter=0.1, weight=2.0),
             [_rand(21, 4, 6), _rand(22, 4, 6)], (0, 1)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    name, args, arrays, grads_of = LOSS_CASES[case]
    _check(name, args, arrays, grads_of)


_CTC = _rand(30, 3, 6, 5, lo=-2.0, hi=2.0)                # (N, T, C)
_CTC_LABELS = np.array([[1, 2, -1], [3, 3, 1], [4, -1, -1]], np.float32)


@pytest.mark.parametrize("layout, lengths", [
    ("NTC", "none"), ("TNC", "pred"), ("NTC", "label"), ("TNC", "both")])
def test_ctc_loss_matches_jax(layout, lengths):
    pred = _CTC if layout == "NTC" else _CTC.transpose(1, 0, 2).copy()
    arrays = [pred, _CTC_LABELS, None, None]
    if lengths in ("pred", "both"):
        arrays[2] = np.array([6, 4, 5], np.float32)
    if lengths in ("label", "both"):
        arrays[3] = np.array([2, 3, 1], np.float32)
    _check("CTCLoss", dict(layout=layout, weight=0.5 if lengths == "both"
                           else None), arrays, (0,))


def test_ctc_label_layout_tn_reads_the_transposed_labels():
    labels_tn = torch.from_numpy(_CTC_LABELS.T.copy())
    tn = gluon.loss.CTCLoss(label_layout="TN")(torch.from_numpy(_CTC),
                                               labels_tn)
    nt = gluon.loss.CTCLoss()(torch.from_numpy(_CTC),
                              torch.from_numpy(_CTC_LABELS))
    np.testing.assert_array_equal(tn.numpy(), nt.numpy())
    with pytest.raises(ValueError, match="layouts"):
        gluon.loss.CTCLoss(layout="NCT")


@pytest.mark.parametrize("from_sigmoid", [False, True])
def test_sigmoid_bce_pos_weight_is_mxnet_s(from_sigmoid):
    """``pos_weight`` scales the positive term (MXNet's formula, in
    float64 numpy); the JAX package takes the argument and leaves it out,
    so a ``pos_weight`` of ones is held against it too."""
    pred = _PROB if from_sigmoid else _P
    pos_weight = _rand(31, 1, 3, lo=0.5, hi=3.0)
    loss = gluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=from_sigmoid)
    got = loss(torch.from_numpy(pred), torch.from_numpy(_Y01), None,
               torch.from_numpy(pos_weight)).numpy()
    p, y, w = (a.astype(np.float64) for a in (pred, _Y01, pos_weight))
    if from_sigmoid:
        want = -(np.log(p + 1e-12) * y * w + np.log(1 - p + 1e-12) * (1 - y))
    else:
        want = p - p * y + (1 + (w - 1) * y) * (
            np.log1p(np.exp(-np.abs(p))) + np.maximum(-p, 0))
    np.testing.assert_allclose(got, want.mean(axis=1), **ND_TOL)
    ones = loss(torch.from_numpy(pred), torch.from_numpy(_Y01), None,
                torch.ones(1, 3)).numpy()
    ref = jgluon.loss.SigmoidBinaryCrossEntropyLoss(
        from_sigmoid=from_sigmoid)(jmx.nd.array(pred), jmx.nd.array(_Y01))
    np.testing.assert_allclose(ones, ref.asnumpy(), **ND_TOL)


def test_losses_take_ndarrays_and_refuse_unknown_label_formats():
    with mx.cpu():
        out = gluon.loss.HingeLoss()(mx.nd.array(_P), mx.nd.array(_SIGNED))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (4,)
    want = jgluon.loss.HingeLoss()(jmx.nd.array(_P), jmx.nd.array(_SIGNED))
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **ND_TOL)
    with pytest.raises(ValueError, match="label_format"):
        gluon.loss.LogisticLoss(label_format="ternary")


def test_every_reference_loss_is_ported():
    names = {n for n in dir(jgluon.loss) if n.endswith("Loss")}
    assert names <= set(dir(gluon.loss)), names - set(dir(gluon.loss))
