"""Port parity: every op of ``ops/detection.py`` against the JAX package.

The same numpy inputs (from a seed) go through the JAX op and the port's.
Index outputs (matches, keep masks, ranks, class targets) must be equal;
floating outputs agree to 1e-5 relative and 1e-6 absolute (both fp32, the
same formulas in another order of operations). Ties are made on purpose
(equal scores, equal IoUs) and must break the same way: stable sorts and
the first maximum, as ``jnp.argsort``/``jnp.argmax``. The registry holds
every op under the reference's names and aliases, and ``mx.nd.contrib``
every member the JAX package's has.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import detection as jdet
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import detection as det
from incubator_mxnet_tpu_torch.ops import registry

RTOL, ATOL = 1e-5, 1e-6


def _both(fn_j, fn_t, *arrays, **kw):
    """(JAX result, port result) as lists of numpy arrays."""
    rj = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    rt = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    rj = list(rj) if isinstance(rj, (tuple, list)) else [rj]
    rt = list(rt) if isinstance(rt, (tuple, list)) else [rt]
    return ([np.asarray(x) for x in rj],
            [x.detach().numpy() for x in rt])


def _same(fn_j, fn_t, *arrays, exact=False, **kw):
    want, got = _both(fn_j, fn_t, *arrays, **kw)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return got


def _boxes(rs, *shape, lo=0.0, hi=1.0):
    """Corner boxes (..., 4) with x0 < x1, y0 < y1 inside [lo, hi]."""
    a = rs.uniform(lo, hi, shape + (2, 2)).astype(np.float32)
    a.sort(axis=-2)
    return np.concatenate([a[..., 0, :], a[..., 1, :]], -1)


NAMES = {"smooth_l1": (), "box_iou": (), "box_encode": (), "box_decode": (),
         "bipartite_matching": (),
         "box_nms": ("box_non_maximum_suppression",),
         "multibox_prior": ("MultiBoxPrior",),
         "multibox_target": ("MultiBoxTarget",),
         "multibox_detection": ("MultiBoxDetection",),
         "Proposal": ("proposal", "contrib_Proposal"),
         "MultiProposal": ("multi_proposal", "contrib_MultiProposal"),
         "PSROIPooling": ("psroi_pooling", "contrib_PSROIPooling"),
         "DeformablePSROIPooling": ("deformable_psroi_pooling",
                                    "contrib_DeformablePSROIPooling"),
         "RROIAlign": ("rroi_align", "contrib_RROIAlign")}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_registered_under_the_reference_names_and_aliases(name):
    od, jod = registry.get(name), jregistry.get(name)
    assert od is not None and od.name == name == jod.name
    assert set(od.aliases) == set(jod.aliases) == set(NAMES[name])
    assert od.differentiable == jod.differentiable
    for a in NAMES[name]:
        assert registry.get(a) is od


def test_nd_contrib_holds_every_member_of_the_reference():
    names = [n for n in dir(jmx.nd.contrib) if not n.startswith("_")]
    assert [n for n in names if not hasattr(mx.nd.contrib, n)] == []
    assert hasattr(mx.nd, "smooth_l1")


@pytest.mark.parametrize("scalar", [1.0, 2.5])
def test_smooth_l1_and_its_gradient(scalar):
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32) * 2
    _same(jdet.smooth_l1, det.smooth_l1, x, scalar=scalar)
    t = torch.from_numpy(x).requires_grad_()
    det.smooth_l1(t, scalar=scalar).sum().backward()
    import jax

    g = jax.grad(lambda a: jdet.smooth_l1(a, scalar=scalar).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(1)
    a, b = _boxes(rs, 2, 6), _boxes(rs, 2, 5)
    b[0, 1] = a[0, 2]                       # identical boxes: IoU 1
    _same(jdet.box_iou, det.box_iou, a, b, format=fmt)


def test_box_encode_and_decode():
    rs = np.random.RandomState(2)
    anchors, refs = _boxes(rs, 2, 10), _boxes(rs, 2, 3)
    samples = rs.choice([-1.0, 0.0, 1.0], (2, 10)).astype(np.float32)
    matches = rs.randint(0, 3, (2, 10)).astype(np.float32)
    _same(jdet.box_encode, det.box_encode, samples, matches, anchors, refs)
    data = rs.randn(2, 10, 4).astype(np.float32) * 0.5
    for kw in (dict(), dict(std0=0.1, std1=0.1, std2=0.2, std3=0.2),
               dict(clip=0.3), dict(format="center")):
        _same(jdet.box_decode, det.box_decode, data, anchors[:1], **kw)


@pytest.mark.parametrize("kw", [dict(), dict(is_ascend=True, threshold=0.9),
                                dict(topk=2), dict(threshold=0.5)],
                         ids=["plain", "ascend", "topk", "threshold"])
def test_bipartite_matching_with_ties(kw):
    rs = np.random.RandomState(3)
    s = rs.uniform(0, 1, (2, 5, 4)).astype(np.float32)
    s[0, 1, 2] = s[0, 3, 0] = s[0].max() + 0.1     # a tie for the maximum
    s[1, :, 1] = 0.5                               # a column of ties
    _same(jdet.bipartite_matching, det.bipartite_matching, s, exact=True,
          **kw)


def _records(rs, b, n, ids=True, ties=True):
    """(B, N, 6) records [id, score, box] with tied scores and overlaps,
    invalid (score 0 or negative) rows among them."""
    rec = np.zeros((b, n, 6), np.float32)
    rec[..., 0] = rs.randint(0, 3, (b, n)) if ids else 0
    rec[..., 1] = rs.uniform(-0.2, 1.0, (b, n))
    rec[..., 2:] = _boxes(rs, b, n, lo=0.0, hi=0.6)
    if ties:
        rec[:, 3, 1] = rec[:, 5, 1] = 0.9           # tied scores
        rec[:, 5, 2:] = rec[:, 3, 2:] + 0.01         # overlapping
        rec[:, 7, 1] = 0.0                           # invalid (score 0)
    return rec


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_thresh=0.3, valid_thresh=0.1),
    dict(id_index=0, background_id=0),
    dict(id_index=0, force_suppress=True),
    dict(topk=5),
    dict(in_format="center", out_format="corner"),
    dict(in_format="corner", out_format="center", topk=7),
], ids=["plain", "thresholds", "background", "force_suppress", "topk",
        "center_in", "center_out_topk"])
def test_box_nms(kw):
    rec = _records(np.random.RandomState(4), 2, 12)
    _same(jdet.box_nms, det.box_nms, rec, **kw)


def test_box_nms_takes_one_image_of_records():
    rec = _records(np.random.RandomState(4), 1, 12)[0]    # (N, K)
    _same(jdet.box_nms, det.box_nms, rec, overlap_thresh=0.3)


def test_nms_fixed_point_equals_the_greedy_loop_on_long_chains():
    """A chain of boxes each overlapping the next (suppression alternates
    down the chain): the fixed point needs several passes and must land
    on the greedy answer."""
    n = 40
    rec = np.zeros((1, n, 6), np.float32)
    rec[0, :, 1] = np.linspace(1.0, 0.1, n)
    x = np.arange(n, dtype=np.float32) * 0.02
    rec[0, :, 2], rec[0, :, 4] = x, x + 0.05
    rec[0, :, 3], rec[0, :, 5] = 0.0, 0.05
    got = _same(jdet.box_nms, det.box_nms, rec, overlap_thresh=0.4)
    kept = got[0][0, :, 1] >= 0
    assert 0 < kept.sum() < n


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.2,), ratios=(1.0,)),
    dict(sizes=(0.1, 0.141), ratios=(1.0, 2.0, 0.5), clip=True),
    dict(sizes=(0.5,), ratios=(1.0, 3.0), steps=(0.1, 0.2),
         offsets=(0.3, 0.6)),
], ids=["square", "ssd_map", "steps"])
def test_multibox_prior(kw):
    x = np.zeros((1, 3, 5, 7), np.float32)
    _same(jdet.multibox_prior, det.multibox_prior, x, **kw)


def _target_inputs(seed, b=3, n_side=6, m=4, classes=4):
    rs = np.random.RandomState(seed)
    anchor = np.asarray(jdet.multibox_prior(
        jnp.zeros((1, 1, n_side, n_side)), sizes=(0.2, 0.3),
        ratios=(1.0, 2.0)))
    n = anchor.shape[1]
    label = np.full((b, m, 5), -1.0, np.float32)
    for j in range(b):
        for k in range(j + 1):                      # 1..b valid labels
            cx, cy = rs.uniform(0.3, 0.7, 2)
            w, h = rs.uniform(0.1, 0.4, 2)
            label[j, k] = [rs.randint(classes), cx - w / 2, cy - h / 2,
                           cx + w / 2, cy + h / 2]
    # an exact duplicate of the first label: its IoUs tie everywhere
    label[2, 2] = label[2, 0]
    pred = rs.randn(b, classes + 1, n).astype(np.float32)
    pred[:, 1:, :5] = 3.0                           # tied mining scores
    return anchor, label, pred


@pytest.mark.parametrize("kw", [
    dict(),
    dict(negative_mining_ratio=3.0, ignore_label=-1),
    dict(negative_mining_ratio=2.0, negative_mining_thresh=0.3,
         minimum_negative_samples=5, overlap_threshold=0.3),
    dict(variances=(0.2, 0.2, 0.1, 0.1)),
], ids=["plain", "mining", "mining_min", "variances"])
def test_multibox_target_with_ties(kw):
    anchor, label, pred = _target_inputs(5)
    got = _same(jdet.multibox_target, det.multibox_target, anchor, label,
                pred, **kw)
    # the class targets are indices: equal, not close
    want = np.asarray(jdet.multibox_target(
        jnp.asarray(anchor), jnp.asarray(label), jnp.asarray(pred),
        **kw)[2])
    np.testing.assert_array_equal(got[2], want)


def test_multibox_target_reads_nothing_on_the_host():
    """The target pipeline runs under the sync debug mode without a
    device: a CPU run cannot show a sync, so the source is held to the
    rule instead (no .item(), nonzero or boolean-mask indexing)."""
    import inspect

    for fn in (det.multibox_target, det._match_anchors, det._greedy_pairs,
               det._iou_corner):
        src = inspect.getsource(fn)
        for bad in (".item()", "nonzero", ".tolist()", ".cpu()",
                    "masked_select"):
            assert bad not in src, (fn.__name__, bad)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_topk=10, threshold=0.05),
    dict(force_suppress=True, nms_threshold=0.3),
    dict(clip=False, background_id=2),
], ids=["plain", "topk", "force_suppress", "background"])
def test_multibox_detection(kw):
    rs = np.random.RandomState(6)
    anchor = np.asarray(jdet.multibox_prior(
        jnp.zeros((1, 1, 4, 4)), sizes=(0.3,), ratios=(1.0, 2.0)))
    n = anchor.shape[1]
    logits = rs.randn(2, 4, n).astype(np.float32)
    logits[:, :, 3] = logits[:, :, 9]               # tied anchors' scores
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, n * 4) * 0.3).astype(np.float32)
    _same(jdet.multibox_detection, det.multibox_detection,
          prob.astype(np.float32), loc, anchor, **kw)


@pytest.mark.parametrize("op, score", [("Proposal", False),
                                       ("MultiProposal", True)])
def test_proposal(op, score):
    rs = np.random.RandomState(7)
    a = 3 * 2
    cls = rs.uniform(0, 1, (2, 2 * a, 5, 6)).astype(np.float32)
    cls[:, a:, 1, 1] = cls[:, a:, 2, 2]             # tied scores
    bbox = (rs.randn(2, 4 * a, 5, 6) * 0.2).astype(np.float32)
    info = np.array([[80, 96, 1.0], [64, 80, 1.5]], np.float32)
    kw = dict(feature_stride=16, scales=(2, 4, 8), ratios=(0.5, 1.0),
              rpn_pre_nms_top_n=50, rpn_post_nms_top_n=12, threshold=0.6,
              rpn_min_size=4, output_score=score)
    _same(jregistry.get(op).fn, registry.get(op).fn, cls, bbox, info, **kw)


def _rois(rs, r, n, h, w):
    x0 = rs.uniform(0, w * 8, r)
    y0 = rs.uniform(0, h * 8, r)
    return np.stack([rs.randint(0, n, r), x0, y0,
                     x0 + rs.uniform(4, w * 8, r),
                     y0 + rs.uniform(4, h * 8, r)], 1).astype(np.float32)


@pytest.mark.parametrize("group", [0, 2])
def test_psroi_pooling_and_its_gradient(group):
    rs = np.random.RandomState(8)
    p, d = 3, 2
    g = group or p
    data = rs.randn(2, d * g * g, 9, 11).astype(np.float32)
    rois = _rois(rs, 4, 2, 9, 11)
    kw = dict(spatial_scale=0.125, output_dim=d, pooled_size=p,
              group_size=group)
    _same(jdet.psroi_pooling, det.psroi_pooling, data, rois, **kw)
    import jax

    gj = jax.grad(lambda x: jdet.psroi_pooling(x, jnp.asarray(rois),
                                               **kw).sum())(
        jnp.asarray(data))
    t = torch.from_numpy(data).requires_grad_()
    det.psroi_pooling(t, torch.from_numpy(rois), **kw).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling(no_trans):
    rs = np.random.RandomState(9)
    p, d = 2, 3
    data = rs.randn(2, d * p * p, 8, 10).astype(np.float32)
    rois = _rois(rs, 3, 2, 8, 10)
    trans = (rs.randn(3, 2, p, p) * 0.5).astype(np.float32)
    kw = dict(spatial_scale=0.125, output_dim=d, pooled_size=p,
              sample_per_part=3, trans_std=0.2, no_trans=no_trans)
    _same(jdet.deformable_psroi_pooling, det.deformable_psroi_pooling,
          data, rois, trans, **kw)


def test_rroi_align():
    rs = np.random.RandomState(10)
    data = rs.randn(2, 3, 9, 12).astype(np.float32)
    rois = np.stack([rs.randint(0, 2, 5), rs.uniform(10, 80, 5),
                     rs.uniform(10, 60, 5), rs.uniform(8, 40, 5),
                     rs.uniform(8, 30, 5), rs.uniform(-90, 90, 5)],
                    1).astype(np.float32)
    _same(jdet.rroi_align, det.rroi_align, data, rois, pooled_size=(3, 4),
          spatial_scale=0.125)
