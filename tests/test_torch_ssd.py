"""Port parity: SSD-300 (``models/ssd.py``) against the JAX package.

One SSD-300 VOC net drawn in the JAX package (xavier, from a seed) is
carried into the port by ``gluon.model_zoo.load_jax_params``; both run
one B=1 forward at 3x300x300 on the same image (a module fixture shares
it). The three outputs agree to 1e-4 relative and 1e-4 absolute (fp32
convolutions over 26M weights in another order of sums). The training
pipeline (``MultiBoxTarget`` with hard-negative mining, then
``SSDMultiBoxLoss`` and its gradient with respect to both predictions)
runs in each package on the JAX forward's outputs and the bench row's
labels: the class targets equal, the rest to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.parallel.spmd import collect_params as jcollect

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.ops import detection as det

FWD_RTOL, FWD_ATOL = 1e-4, 1e-4
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def bench_labels(rs, b):
    """bench.py's SSD row labels: one box a image in 4 slots."""
    label = np.full((b, 4, 5), -1.0, np.float32)
    for j in range(b):
        cx, cy = rs.uniform(0.3, 0.7, 2)
        w, h = rs.uniform(0.2, 0.4, 2)
        label[j, 0] = [rs.randint(20), cx - w / 2, cy - h / 2, cx + w / 2,
                       cy + h / 2]
    return label


@pytest.fixture(scope="module")
def pair():
    """(JAX outputs, port outputs, port net, JAX params, image)."""
    jmx.random.seed(0)
    jnet = jmodels.get_ssd(num_classes=20)
    jnet.initialize(init="xavier")
    img = np.random.RandomState(0).rand(1, 3, 300, 300).astype(np.float32)
    jout = [o.asnumpy() for o in jnet(jmx.nd.array(img))]
    params = {n: p.data().asnumpy() for n, p in jcollect(jnet).items()}
    net = models.get_ssd(num_classes=20)
    load_jax_params(net, params, ctx=mx.cpu())
    with mx.autograd.pause():
        out = [o.asnumpy() for o in net(mx.nd.array(img, ctx=mx.cpu()))]
    return jout, out, net, params, img


def test_parameter_names_equal_the_jax_package(pair):
    _, _, net, params, _ = pair
    names = [n for n, _ in net.named_parameters()]
    assert sorted(names) == sorted(params)
    assert len(names) == 71
    assert sum(p.numel() for p in net.parameters()) == 26_285_486
    assert "features.norm4.scale" in names


def test_forward_with_carried_weights(pair):
    jout, out, _, _, _ = pair
    assert [o.shape for o in out] == [(1, 8732, 21), (1, 34928),
                                      (1, 8732, 4)]
    for name, w, g in zip(("cls_pred", "loc_pred", "anchors"), jout, out):
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=name)


def test_forward_on_tensors_equals_on_ndarrays(pair):
    _, out, net, _, img = pair
    with torch.no_grad():
        got = net(torch.from_numpy(img))
    for g, w in zip(got, out):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)


def _pipeline_jax(cls_pred, loc_pred, anchors, label):
    from incubator_mxnet_tpu.ops import detection as jdet

    loss_blk = jmodels.SSDMultiBoxLoss()

    def loss_of(cp, lp):
        bt, bm, ct = jdet.multibox_target(
            anchors, label, jnp.transpose(cp, (0, 2, 1)),
            negative_mining_ratio=3.0, ignore_label=-1)
        out = loss_blk(jmx.nd.NDArray(cp), jmx.nd.NDArray(lp),
                       jmx.nd.NDArray(ct), jmx.nd.NDArray(bt),
                       jmx.nd.NDArray(bm))
        return out._data.sum(), (bt, bm, ct, out._data)

    (_, aux), grads = jax.value_and_grad(loss_of, argnums=(0, 1),
                                         has_aux=True)(cls_pred, loc_pred)
    return [np.asarray(a) for a in aux] + [np.asarray(g) for g in grads]


def _pipeline_port(cls_pred, loc_pred, anchors, label):
    cp = torch.from_numpy(cls_pred).requires_grad_()
    lp = torch.from_numpy(loc_pred).requires_grad_()
    bt, bm, ct = det.multibox_target(
        torch.from_numpy(anchors), torch.from_numpy(label),
        cp.detach().transpose(1, 2), negative_mining_ratio=3.0,
        ignore_label=-1)
    loss = models.SSDMultiBoxLoss()(cp, lp, ct, bt, bm)
    loss.sum().backward()
    return [t.detach().numpy() for t in (bt, bm, ct, loss, cp.grad,
                                         lp.grad)]


def test_target_loss_and_gradient_pipeline(pair):
    jout, _, _, _, _ = pair
    label = bench_labels(np.random.RandomState(1), 1)
    want = _pipeline_jax(jnp.asarray(jout[0]), jnp.asarray(jout[1]),
                         jnp.asarray(jout[2]), jnp.asarray(label))
    got = _pipeline_port(jout[0], jout[1], jout[2], label)
    names = ("box_target", "box_mask", "cls_target", "loss", "d_cls_pred",
             "d_loc_pred")
    for name, w, g in zip(names, want, got):
        assert w.shape == g.shape, name
        if name in ("box_mask", "cls_target"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7,
                                       err_msg=name)
    assert (got[2] > 0).sum() >= 1            # a matched anchor
    assert (got[2] == -1).sum() > 0           # negatives mined away


def test_detection_decodes_the_forward(pair):
    """``multibox_detection`` on the forward's softmaxed classes: the
    port's output equals the JAX package's on the same predictions."""
    from incubator_mxnet_tpu.ops import detection as jdet

    jout, _, _, _, _ = pair
    logits = jout[0][:, :200]                 # 200 anchors bound the NMS
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).transpose(0, 2, 1)
    loc, anchors = jout[1][:, :800], jout[2][:, :200]
    kw = dict(threshold=0.04, nms_threshold=0.45)
    want = np.asarray(jdet.multibox_detection(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anchors), **kw))
    got = det.multibox_detection(torch.from_numpy(np.ascontiguousarray(
        prob)), torch.from_numpy(loc), torch.from_numpy(anchors), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    assert (want[0, :, 0] >= 0).any()


def test_hybridize_and_export_round_trip(pair, tmp_path):
    """The net hybridizes (the CachedOp engages on the card only; on the
    CPU the call runs the forward) and exports; the SymbolBlock loaded
    back gives the same outputs."""
    from incubator_mxnet_tpu_torch.gluon import SymbolBlock

    _, out, net, _, img = pair
    net.hybridize()
    with mx.autograd.pause():
        again = [o.asnumpy() for o in net(mx.nd.array(img, ctx=mx.cpu()))]
    for g, w in zip(again, out):
        np.testing.assert_array_equal(g, w)
    path = str(tmp_path / "ssd")
    net.export(path)
    blk = SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                              f"{path}-0000.params", ctx=mx.cpu())
    with mx.autograd.pause():
        got = blk(mx.nd.array(img, ctx=mx.cpu()))
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.asnumpy(), w, rtol=1e-5, atol=1e-6)
