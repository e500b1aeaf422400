"""Detection and bounding-box ops: the op set behind SSD-300.

Counterpart of the JAX package's ``ops/detection.py`` (reference
``src/operator/contrib/multibox_prior.cc``, ``multibox_target.cc``,
``multibox_detection.cc``, ``bounding_box.cc`` (box_nms, box_iou,
box_encode, box_decode, bipartite_matching), ``proposal.cc``,
``multi_proposal.cc``, ``psroi_pooling.cc``,
``deformable_psroi_pooling.cc``, ``rroi_align.cc`` and ``smooth_l1``),
with its names, aliases and static-shape results: matching and NMS give
fixed-size outputs with ``-1`` rows, as there.

None of these is a TPU kernel in the JAX package (they are jnp code that
XLA compiles), so they are plain PyTorch here. Two rules keep them equal
to the JAX package and usable inside a captured train step:

* Ties: every sort is stable (``torch.argsort(..., stable=True)``, as
  ``jnp.argsort``), and the greedy matchings take the first maximum of
  the flattened scores (``torch.argmax``, as ``jnp.argmax``).
* ``multibox_target`` and what it calls (``_iou_corner``,
  ``_match_anchors``) read no value on the host and keep every shape
  static: no ``.item()``, no ``nonzero``, no boolean-mask indexing, no
  Python branch on a tensor. The greedy bipartite pass is a loop over the
  M label slots, batched over the images, so an SSD train step can be
  captured in a CUDA graph. Nor do they (or ``multibox_prior``) copy a
  host list to the device: constants enter as Python scalars.

Greedy NMS (``box_nms``, ``multibox_detection``, ``Proposal``) is a
``fori_loop`` over the n candidates in the JAX package, which would be n
device steps here (8732 for SSD-300). ``_nms_keep`` computes the same
keep mask as a fixed point: ``keep[j] = valid[j] & ~any_{i<j}(keep[i] &
sup[i, j])``, iterated from ``keep = valid`` until it stops changing.
The greedy mask is the equation's only solution (entry j depends on the
entries before it alone) and entry j is final after j passes, so the
iteration reaches it; in practice in a few passes (the longest chain of
suppressions). Each pass tests for convergence with one host read: NMS
is on the inference path only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register

__all__ = ["bipartite_matching", "box_decode", "box_encode", "box_iou",
           "box_nms", "deformable_psroi_pooling", "multi_proposal",
           "multibox_detection", "multibox_prior", "multibox_target",
           "proposal", "psroi_pooling", "rroi_align", "smooth_l1"]


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------
def _to_corner(b):
    """center (cx, cy, w, h) -> corner (xmin, ymin, xmax, ymax)."""
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _to_center(b):
    """corner -> center."""
    x0, y0, x1, y1 = b.split(1, dim=-1)
    return torch.cat([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def _iou_corner(a, b, eps=1e-12):
    """Pairwise IoU. a (..., N, 4), b (..., M, 4) corner -> (..., N, M)."""
    ax0, ay0, ax1, ay1 = a.unsqueeze(-2).split(1, dim=-1)
    bx0, by0, bx1, by1 = b.unsqueeze(-3).split(1, dim=-1)
    ix = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp_min(0.0)
    iy = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp_min(0.0)
    inter = (ix * iy)[..., 0]
    area_a = ((ax1 - ax0) * (ay1 - ay0))[..., 0]
    area_b = ((bx1 - bx0) * (by1 - by0))[..., 0]
    return inter / (area_a + area_b - inter + eps)


def _take_rows(x, idx):
    """``x`` (B, N, ...) at rows ``idx`` (B, K) -> (B, K, ...)
    (``take_along_axis`` on axis 1)."""
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, full)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """Huber-style loss core: ``0.5 (s x)^2`` where ``|x| < 1/s^2``, else
    ``|x| - 0.5/s^2``."""
    s2 = scalar * scalar
    absx = data.abs()
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * data * data,
                       absx - 0.5 / s2)


# ---------------------------------------------------------------------------
# contrib bounding-box ops
# ---------------------------------------------------------------------------
@register("box_iou", differentiable=False)
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU. lhs (..., N, 4), rhs (..., M, 4) -> (..., N, M)."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return _iou_corner(lhs, rhs)


@register("box_encode", differentiable=False)
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Encode matched boxes against anchors. samples (B, N) in {-1, 0, 1},
    matches (B, N) indices into refs, anchors (B, N, 4), refs (B, M, 4),
    corner format. Returns (targets (B, N, 4), masks (B, N, 4))."""
    g = _take_rows(refs, matches.long())
    ac, gc = _to_center(anchors), _to_center(g)
    cols = [
        (gc[..., 0:1] - ac[..., 0:1]) / ac[..., 2:3].clamp_min(1e-12),
        (gc[..., 1:2] - ac[..., 1:2]) / ac[..., 3:4].clamp_min(1e-12),
        torch.log(gc[..., 2:3].clamp_min(1e-12)
                  / ac[..., 2:3].clamp_min(1e-12)),
        torch.log(gc[..., 3:4].clamp_min(1e-12)
                  / ac[..., 3:4].clamp_min(1e-12))]
    t = torch.cat([(c - float(m)) / float(sd)
                   for c, m, sd in zip(cols, means, stds)], -1)
    mask = (samples > 0.5).to(anchors.dtype)[..., None]
    return t * mask, mask.expand(t.shape)


@register("box_decode", differentiable=False)
def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner"):
    """Decode box regressions against anchors (the stds default to 1, as
    in the reference). data (B, N, 4), anchors (1, N, 4)."""
    a = _to_center(anchors) if format == "corner" else anchors
    d = torch.cat([data[..., c:c + 1] * float(sd)
                   for c, sd in enumerate((std0, std1, std2, std3))], -1)
    cx = d[..., 0:1] * a[..., 2:3] + a[..., 0:1]
    cy = d[..., 1:2] * a[..., 3:4] + a[..., 1:2]
    dw, dh = d[..., 2:3], d[..., 3:4]
    if clip > 0:
        dw, dh = dw.clamp_max(clip), dh.clamp_max(clip)
    w = torch.exp(dw) * a[..., 2:3]
    h = torch.exp(dh) * a[..., 3:4]
    return _to_corner(torch.cat([cx, cy, w, h], -1))


def _greedy_pairs(s, steps, ok_of, strike=float("-inf")):
    """``steps`` rounds of greedy matching over scores ``s`` (B, N, M),
    fp32, consumed: each round takes each image's first maximum (i, j),
    records it where ``ok_of(value)`` and strikes out row i and column j
    (with ``strike``). Returns (row (B, N), col (B, M)) int64, -1 where
    unmatched."""
    bsz, n, m = s.shape
    row = torch.full((bsz, n), -1, dtype=torch.int64, device=s.device)
    col = torch.full((bsz, m), -1, dtype=torch.int64, device=s.device)
    rows = torch.arange(n, device=s.device)
    cols = torch.arange(m, device=s.device)
    flat = s.view(bsz, n * m)
    for _ in range(steps):
        idx = flat.argmax(dim=1)
        i, j = idx // m, idx % m
        ok = ok_of(flat.gather(1, idx[:, None])[:, 0])[:, None]
        # one-hot masks and selects, not index_put: a Python value put
        # by index is a host copy, which a CUDA graph capture refuses
        at_i, at_j = rows[None] == i[:, None], cols[None] == j[:, None]
        row = torch.where(at_i & ok, j[:, None], row)
        col = torch.where(at_j & ok, i[:, None], col)
        s.masked_fill_(at_i[:, :, None] | at_j[:, None, :], strike)
    return row, col


@register("bipartite_matching", differentiable=False)
def bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy bipartite matching. data (..., N, M) pairwise scores.
    Returns (row_match (..., N), col_match (..., M)): each row's matched
    column (or -1), and each column's row."""
    scores = -data if is_ascend else data
    thr = -threshold if is_ascend else threshold
    n, m = data.shape[-2:]
    steps = min(n, m) if topk <= 0 else min(topk, n, m)
    flat = scores.reshape((-1, n, m)).to(torch.float32).clone()
    row, col = _greedy_pairs(flat, steps, lambda v: v >= thr)
    batch = data.shape[:-2]
    return (row.reshape(batch + (n,)).to(data.dtype),
            col.reshape(batch + (m,)).to(data.dtype))


def _nms_keep(boxes, scores, ids, overlap_thresh, valid, force_suppress):
    """Greedy NMS of each image's candidates in score order (stable).
    boxes (B, n, 4), scores/ids/valid (B, n). Returns (keep (B, n) bool in
    sorted order, order (B, n)). The keep mask is the fixed point of the
    greedy rule (the module's docstring), one image at a time so that the
    (n, n) suppression matrix of one image is all that lives at once."""
    order = torch.argsort(-scores, dim=1, stable=True)
    b = _take_rows(boxes, order)
    v = torch.gather(valid, 1, order)
    cid = torch.gather(ids, 1, order)
    n = boxes.shape[1]
    later = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu_(1)
    keeps = []
    for k in range(boxes.shape[0]):
        sup = (_iou_corner(b[k], b[k]) > overlap_thresh) & later
        if not force_suppress:
            sup &= cid[k][:, None] == cid[k][None, :]
        supf = sup.to(torch.float32)
        keep = v[k]
        for _ in range(n):
            hit = (keep.to(torch.float32)[None, :] @ supf)[0] > 0
            new = v[k] & ~hit
            if torch.equal(new, keep):
                break
            keep = new
        keeps.append(keep)
    return torch.stack(keeps), order


@register("box_nms", aliases=("box_non_maximum_suppression",),
          differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression. data (B, N, K) records (or (N, K)); the
    output is score-sorted with suppressed records filled with -1."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    boxes = data[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    scores = data[..., score_index]
    ids = data[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (ids != background_id)
    n = data.shape[1]
    rec = data
    if 0 < topk < n:
        # the topk valid candidates first: the (n, n) IoU matrix is then
        # bounded by topk (the reference's nms_topk pre-slice)
        masked = torch.where(valid, scores, float("-inf"))
        order0 = torch.argsort(-masked, dim=1, stable=True)[:, :topk]
        boxes = _take_rows(boxes, order0)
        scores, ids, valid = (torch.gather(t, 1, order0)
                              for t in (scores, ids, valid))
        rec = _take_rows(data, order0)
    keep, order = _nms_keep(boxes, scores, ids, overlap_thresh, valid,
                            force_suppress)
    sorted_rec = _take_rows(rec, order)
    if out_format != in_format:
        bx = sorted_rec[..., coord_start:coord_start + 4]
        bx = _to_corner(bx) if out_format == "corner" else _to_center(bx)
        sorted_rec = torch.cat([sorted_rec[..., :coord_start], bx,
                                sorted_rec[..., coord_start + 4:]], -1)
    out = torch.where(keep[..., None], sorted_rec,
                      torch.full_like(sorted_rec, -1.0))
    if 0 < topk < n:
        out = torch.cat([out, out.new_full(
            (out.shape[0], n - topk, out.shape[2]), -1.0)], 1)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# MultiBox family (SSD)
# ---------------------------------------------------------------------------
@register("multibox_prior", aliases=("MultiBoxPrior",), differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of a feature map data (N, C, H, W) (only H, W are
    read): per pixel ``len(sizes) + len(ratios) - 1`` anchors, (s_i, r_0)
    for every size then (s_0, r_j) for j >= 1, width ``s sqrt(r) H / W``,
    height ``s / sqrt(r)``, normalized. Output (1, H*W*A, 4) corner."""
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    combos = [(s, ratios[0]) for s in sizes] + \
             [(sizes[0], r) for r in ratios[1:]]
    # each anchor's half width and height, rounded to fp32 as the JAX
    # package's fp32 arrays hold them (Python scalars: no host copy)
    half = [(float(np.float32(s * (r ** 0.5) * h / w)) / 2,
             float(np.float32(s / (r ** 0.5))) / 2) for s, r in combos]
    out = torch.stack([torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh],
                                   -1) for hw, hh in half], 2)
    out = out.reshape(1, h * w * len(combos), 4)
    return out.clamp(0.0, 1.0) if clip else out


def _match_anchors(iou, overlap_threshold):
    """Reference multibox_target matching, batched: greedy bipartite
    first (each label claims its best anchor, M rounds), then an unmatched
    anchor whose best IoU reaches the threshold claims its best label.
    iou (B, N, M) -> match (B, N) label index or -1."""
    m = iou.shape[2]
    s = iou.to(torch.float32).clone()
    match, _ = _greedy_pairs(s, m, lambda v: v > 1e-12, strike=-1.0)
    best_iou, best_gt = iou.max(dim=2)
    thresh_match = torch.where(best_iou >= overlap_threshold, best_gt,
                               torch.full_like(best_gt, -1))
    return torch.where(match >= 0, match, thresh_match)


@register("multibox_target", aliases=("MultiBoxTarget",),
          differentiable=False)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets. anchor (1, N, 4) corner; label (B, M, 5) rows
    [cls, xmin, ymin, xmax, ymax] padded with -1; cls_pred (B, C+1, N)
    (read for hard-negative mining only). Returns (box_target (B, N*4),
    box_mask (B, N*4), cls_target (B, N)): cls_target is the label's class
    + 1 for a matched anchor, 0 for background and ``ignore_label`` for a
    negative mined away. Static shapes, no host read."""
    anchors = anchor.reshape(-1, 4)
    dtype = anchor.dtype
    bsz, n = label.shape[0], anchors.shape[0]
    gt_valid = label[..., 0] >= 0                        # (B, M)
    gt_boxes = label[..., 1:5]
    iou = _iou_corner(anchors.expand(bsz, n, 4), gt_boxes)   # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    match = _match_anchors(iou, overlap_threshold)
    matched = match >= 0
    midx = match.clamp_min(0)
    g = _take_rows(gt_boxes, midx)                       # (B, N, 4)
    ac, gc = _to_center(anchors), _to_center(g)
    v = [float(x) for x in variances]
    t = torch.stack([
        (gc[..., 0] - ac[:, 0]) / ac[:, 2].clamp_min(1e-12) / v[0],
        (gc[..., 1] - ac[:, 1]) / ac[:, 3].clamp_min(1e-12) / v[1],
        torch.log(gc[..., 2].clamp_min(1e-12)
                  / ac[:, 2].clamp_min(1e-12)) / v[2],
        torch.log(gc[..., 3].clamp_min(1e-12)
                  / ac[:, 3].clamp_min(1e-12)) / v[3]], -1)
    box_target = torch.where(matched[..., None], t, torch.zeros_like(t))
    box_mask = matched[..., None].expand(t.shape).to(torch.float32)
    cls_of = torch.gather(label[..., 0], 1, midx) + 1.0
    cls_target = torch.where(matched, cls_of, torch.zeros_like(cls_of))
    if negative_mining_ratio > 0:
        # hard-negative mining: unmatched anchors whose best IoU is below
        # negative_mining_thresh are the eligible negatives, ranked by
        # their largest foreground prediction; ratio * positives of them
        # (at least minimum_negative_samples) stay background, the rest
        # are ignored
        best_iou = iou.max(dim=2).values
        eligible = ~matched & (best_iou < negative_mining_thresh)
        neg_score = cls_pred[:, 1:, :].max(dim=1).values
        neg_score = torch.where(eligible, neg_score,
                                torch.full_like(neg_score, float("-inf")))
        num_pos = matched.sum(dim=1)
        quota = (num_pos * float(negative_mining_ratio)).to(torch.int64) \
            .clamp_min(int(minimum_negative_samples))
        rank = torch.argsort(torch.argsort(-neg_score, dim=1, stable=True),
                             dim=1, stable=True)
        keep_neg = eligible & (rank < quota[:, None])
        cls_target = torch.where(matched | keep_neg, cls_target,
                                 torch.full_like(cls_target,
                                                 float(ignore_label)))
    return (box_target.reshape(bsz, -1).to(dtype),
            box_mask.reshape(bsz, -1).to(dtype), cls_target.to(dtype))


@register("multibox_detection", aliases=("MultiBoxDetection",),
          differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and per-class NMS. cls_prob (B, C+1, N), loc_pred (B, N*4),
    anchor (1, N, 4). Output (B, N, 6): [class_id, score, xmin, ymin,
    xmax, ymax] sorted by score, suppressed rows all -1."""
    b, n = cls_prob.shape[0], anchor.shape[1]
    loc = loc_pred.reshape(b, n, 4)
    v = variances
    a = _to_center(anchor)
    d0 = loc[..., 0:1] * v[0] * a[..., 2:3] + a[..., 0:1]
    d1 = loc[..., 1:2] * v[1] * a[..., 3:4] + a[..., 1:2]
    d2 = torch.exp(loc[..., 2:3] * v[2]) * a[..., 2:3]
    d3 = torch.exp(loc[..., 3:4] * v[3]) * a[..., 3:4]
    boxes = _to_corner(torch.cat([d0, d1, d2, d3], -1))
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    keep_cls = [c for c in range(cls_prob.shape[1]) if c != background_id]
    fg = cls_prob[:, keep_cls]                            # (B, C, N)
    score, cls_id = fg.max(dim=1)
    cls_id = cls_id.to(cls_prob.dtype)
    valid = score > threshold
    records = torch.cat([cls_id[..., None], score[..., None], boxes], -1)
    if 0 < nms_topk < n:
        masked = torch.where(valid, score, torch.full_like(score,
                                                          float("-inf")))
        order0 = torch.argsort(-masked, dim=1, stable=True)[:, :nms_topk]
        boxes = _take_rows(boxes, order0)
        score, cls_id, valid = (torch.gather(t, 1, order0)
                                for t in (score, cls_id, valid))
        records = _take_rows(records, order0)
    keep, order = _nms_keep(boxes, score, cls_id, nms_threshold, valid,
                            force_suppress)
    sorted_rec = _take_rows(records, order)
    out = torch.where(keep[..., None], sorted_rec,
                      torch.full_like(sorted_rec, -1.0))
    if 0 < nms_topk < n:
        out = torch.cat([out, out.new_full(
            (out.shape[0], n - nms_topk, out.shape[2]), -1.0)], 1)
    return out


# ---------------------------------------------------------------------------
# RPN proposals (reference contrib Proposal / MultiProposal)
# ---------------------------------------------------------------------------
def _generate_base_anchors(stride, scales, ratios, device):
    """Reference rcnn generate_anchors: base box [0, 0, stride-1,
    stride-1], ratio enumeration (rounded), then scale enumeration."""
    base = float(stride)
    cx = cy = (base - 1.0) / 2.0
    size = base * base
    anchors = []
    for r in ratios:
        ws = round(np.sqrt(size / r))
        hs = round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - (wss - 1) / 2.0, cy - (hss - 1) / 2.0,
                            cx + (wss - 1) / 2.0, cy + (hss - 1) / 2.0])
    return torch.tensor(np.array(anchors, np.float32), device=device)


def _bbox_transform_inv(boxes, deltas):
    """Fast R-CNN delta decode: (dx, dy, dw, dh) on corner boxes."""
    ws = boxes[:, 2] - boxes[:, 0] + 1.0
    hs = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (ws - 1.0)
    cy = boxes[:, 1] + 0.5 * (hs - 1.0)
    pcx = deltas[:, 0] * ws + cx
    pcy = deltas[:, 1] * hs + cy
    pw = torch.exp(deltas[:, 2]) * ws
    ph = torch.exp(deltas[:, 3]) * hs
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], 1)


def _proposal_one(scores, deltas, im_info, anchors, stride, pre_nms,
                  post_nms, thresh, min_size):
    """One image: scores (A, H, W), deltas (4A, H, W), im_info (3,).
    Returns (post_nms, 4) rois and (post_nms,) scores, zero-padded when
    fewer survive (as the JAX package)."""
    a, h, w = scores.shape
    dev = scores.device
    shift_x = torch.arange(w, dtype=torch.float32, device=dev) * stride
    shift_y = torch.arange(h, dtype=torch.float32, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1)               # (H, W, 4)
    all_anchors = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    all_deltas = deltas.reshape(a, 4, h, w).permute(2, 3, 0, 1) \
        .reshape(-1, 4)
    all_scores = scores.permute(1, 2, 0).reshape(-1)
    boxes = _bbox_transform_inv(all_anchors, all_deltas)
    lim = (im_info[1] - 1.0, im_info[0] - 1.0, im_info[1] - 1.0,
           im_info[0] - 1.0)
    boxes = torch.stack([torch.minimum(boxes[:, c].clamp_min(0), lim[c])
                         for c in range(4)], 1)
    ms = min_size * im_info[2]
    keep_sz = ((boxes[:, 2] - boxes[:, 0] + 1.0 >= ms)
               & (boxes[:, 3] - boxes[:, 1] + 1.0 >= ms))
    masked = torch.where(keep_sz, all_scores,
                         torch.full_like(all_scores, float("-inf")))
    k = min(pre_nms, boxes.shape[0])
    # lax.top_k's order: descending, the lower index first among equals
    top_scores, order = torch.sort(masked, descending=True, stable=True)
    top_scores, order = top_scores[:k], order[:k]
    top_boxes = boxes[order]
    valid = torch.isfinite(top_scores)
    keep, nms_order = _nms_keep(top_boxes[None], top_scores[None],
                                torch.zeros_like(top_scores)[None], thresh,
                                valid[None], True)
    keep, nms_order = keep[0], nms_order[0]
    sorted_boxes = top_boxes[nms_order]
    sorted_scores = top_scores[nms_order]
    rank = torch.where(keep, torch.cumsum(keep.to(torch.int64), 0) - 1,
                       torch.full_like(nms_order, k))
    idx = torch.where(keep & (rank < post_nms), rank,
                      torch.full_like(rank, post_nms))      # dump slot
    out_boxes = boxes.new_zeros((post_nms + 1, 4))
    out_boxes[idx] = sorted_boxes
    out_scores = all_scores.new_zeros((post_nms + 1,))
    out_scores[idx] = torch.where(torch.isfinite(sorted_scores),
                                  sorted_scores,
                                  torch.zeros_like(sorted_scores))
    return out_boxes[:post_nms], out_scores[:post_nms]


@register("Proposal", aliases=("proposal", "contrib_Proposal"),
          differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, feature_stride=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
             threshold=0.7, rpn_min_size=16, output_score=False):
    """RPN proposals: decode the anchor deltas, clip, drop boxes under the
    minimum size, keep the top pre_nms, NMS, keep the top post_nms.
    cls_prob (N, 2A, H, W), bbox_pred (N, 4A, H, W), im_info (N, 3)
    [height, width, scale]. Output rois (N*post_nms, 5) with the batch
    index in column 0 (and scores (N*post_nms, 1) with output_score)."""
    n, a2 = cls_prob.shape[:2]
    a = a2 // 2
    anchors = _generate_base_anchors(feature_stride, scales, ratios,
                                     cls_prob.device)
    post = int(rpn_post_nms_top_n)
    outs = [_proposal_one(cls_prob[i, a:], bbox_pred[i], im_info[i],
                          anchors, float(feature_stride),
                          int(rpn_pre_nms_top_n), post, float(threshold),
                          float(rpn_min_size)) for i in range(n)]
    boxes = torch.stack([o[0] for o in outs])
    scores = torch.stack([o[1] for o in outs])
    bidx = torch.arange(n, dtype=boxes.dtype,
                        device=boxes.device).repeat_interleave(post)
    rois = torch.cat([bidx[:, None], boxes.reshape(-1, 4)], 1)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


@register("MultiProposal", aliases=("multi_proposal",
                                    "contrib_MultiProposal"),
          differentiable=False)
def multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Batch RPN proposals (the same as ``Proposal``, which is batched
    already)."""
    return proposal(cls_prob, bbox_pred, im_info, **kwargs)


# ---------------------------------------------------------------------------
# position-sensitive and rotated ROI pooling
# ---------------------------------------------------------------------------
def _bilinear(img, yy, xx, h, w):
    """Bilinear samples of ``img`` (..., H*W) at (yy, xx) (K,), clamped to
    the map as the JAX package clamps them."""
    y0 = yy.floor().clamp(0, h - 1).long()
    y1 = (y0 + 1).clamp(0, h - 1)
    wy = (yy - y0).clamp(0.0, 1.0).to(img.dtype)
    x0 = xx.floor().clamp(0, w - 1).long()
    x1 = (x0 + 1).clamp(0, w - 1)
    wx = (xx - x0).clamp(0.0, 1.0).to(img.dtype)
    return (img[..., y0 * w + x0] * ((1 - wy) * (1 - wx))
            + img[..., y0 * w + x1] * ((1 - wy) * wx)
            + img[..., y1 * w + x0] * (wy * (1 - wx))
            + img[..., y1 * w + x1] * (wy * wx))


@register("PSROIPooling", aliases=("psroi_pooling", "contrib_PSROIPooling"))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                  pooled_size=1, group_size=0):
    """Position-sensitive ROI pooling (R-FCN): output bin (i, j) averages
    channel block ``d*g*g + i*g + j`` over the bin. data (N,
    output_dim*g*g, H, W); rois (R, 5); out (R, output_dim, p, p)."""
    g = int(group_size) or int(pooled_size)
    p = int(pooled_size)
    _, _, h, w = data.shape
    dev = data.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    i = torch.arange(p, dtype=torch.float32, device=dev)
    gi = (torch.arange(p, device=dev) * g) // p
    outs = []
    for roi in rois:
        x1 = torch.round(roi[1]) * spatial_scale
        y1 = torch.round(roi[2]) * spatial_scale
        x2 = (torch.round(roi[3]) + 1.0) * spatial_scale
        y2 = (torch.round(roi[4]) + 1.0) * spatial_scale
        bh = (y2 - y1).clamp_min(0.1) / p
        bw = (x2 - x1).clamp_min(0.1) / p
        hs = torch.floor(y1 + i * bh).clamp(0, h)
        he = torch.ceil(y1 + (i + 1) * bh).clamp(0, h)
        ws = torch.floor(x1 + i * bw).clamp(0, w)
        we = torch.ceil(x1 + (i + 1) * bw).clamp(0, w)
        my = ((ys[None] >= hs[:, None]) & (ys[None] < he[:, None])) \
            .to(data.dtype)
        mx = ((xs[None] >= ws[:, None]) & (xs[None] < we[:, None])) \
            .to(data.dtype)
        img = data[roi[0].long()].reshape(output_dim, g, g, h, w)
        sel = img[:, gi][:, :, gi]                     # (D, p, p, H, W)
        num = torch.einsum("dijhw,ih,jw->dij", sel, my, mx)
        cnt = (my.sum(1)[:, None] * mx.sum(1)[None, :]).clamp_min(1.0)
        outs.append(num / cnt)
    return torch.stack(outs) if outs else data.new_zeros(
        (0, output_dim, p, p))


@register("DeformablePSROIPooling",
          aliases=("deformable_psroi_pooling",
                   "contrib_DeformablePSROIPooling"))
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=1, pooled_size=1, group_size=0,
                             part_size=0, sample_per_part=4,
                             trans_std=0.1, no_trans=False):
    """Deformable PSROI pooling: PSROI bins shifted by the normalized
    offsets ``trans`` (R, 2, p, p) times ``trans_std`` and the roi's size,
    each the mean of ``sample_per_part``^2 bilinear samples."""
    g = int(group_size) or int(pooled_size)
    p = int(pooled_size)
    if part_size not in (0, p):
        raise NotImplementedError(
            f"part_size={part_size} != pooled_size={p}: the part-cell "
            "lookup is not implemented; pass part_size=0 (trans shaped "
            "(R, 2, pooled_size, pooled_size))")
    sp = max(1, int(sample_per_part))
    _, _, h, w = data.shape
    dev = data.device
    if no_trans or trans is None:
        trans = data.new_zeros((rois.shape[0], 2, p, p))
    i = torch.arange(p, dtype=torch.float32, device=dev)
    s = (torch.arange(sp, dtype=torch.float32, device=dev) + 0.5) / sp
    gi = (torch.arange(p, device=dev) * g) // p
    kidx = torch.arange(p * p, device=dev).repeat_interleave(sp * sp)
    outs = []
    for roi, tr in zip(rois, trans):
        x1 = torch.round(roi[1]) * spatial_scale - 0.5
        y1 = torch.round(roi[2]) * spatial_scale - 0.5
        x2 = (torch.round(roi[3]) + 1.0) * spatial_scale - 0.5
        y2 = (torch.round(roi[4]) + 1.0) * spatial_scale - 0.5
        rw = (x2 - x1).clamp_min(0.1)
        rh = (y2 - y1).clamp_min(0.1)
        bh, bw = rh / p, rw / p
        img = data[roi[0].long()].reshape(output_dim, g, g, h, w)
        dx = tr[0] * trans_std * rw
        dy = tr[1] * trans_std * rh
        by, bx = y1 + i * bh, x1 + i * bw
        yy = by[:, None, None, None] + (s * bh)[None, None, :, None] \
            + dy[:, :, None, None]
        xx = bx[None, :, None, None] + (s * bw)[None, None, None, :] \
            + dx[:, :, None, None]
        yy = yy.expand(p, p, sp, sp).reshape(-1)
        xx = xx.expand(p, p, sp, sp).reshape(-1)
        flat = img[:, gi][:, :, gi].reshape(output_dim, p * p, h * w)

        def at(yi, xi):
            return flat[:, kidx, yi * w + xi]           # (D, K)

        y0 = yy.floor().clamp(0, h - 1).long()
        y1i = (y0 + 1).clamp(0, h - 1)
        wy = (yy - y0).clamp(0.0, 1.0).to(data.dtype)
        x0 = xx.floor().clamp(0, w - 1).long()
        x1i = (x0 + 1).clamp(0, w - 1)
        wx = (xx - x0).clamp(0.0, 1.0).to(data.dtype)
        samp = (at(y0, x0) * ((1 - wy) * (1 - wx))
                + at(y0, x1i) * ((1 - wy) * wx)
                + at(y1i, x0) * (wy * (1 - wx))
                + at(y1i, x1i) * (wy * wx))
        outs.append(samp.reshape(output_dim, p, p, sp * sp).mean(-1))
    return torch.stack(outs) if outs else data.new_zeros(
        (0, output_dim, p, p))


@register("RROIAlign", aliases=("rroi_align", "contrib_RROIAlign"))
def rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Rotated ROI align: rois (R, 6) = [batch, cx, cy, w, h, angle in
    degrees]; a pooled_size grid of bilinear samples over the rotated
    box."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    _, c, h, w = data.shape
    dev = data.device
    iy = (torch.arange(ph, dtype=torch.float32, device=dev) + 0.5) / ph - 0.5
    ix = (torch.arange(pw, dtype=torch.float32, device=dev) + 0.5) / pw - 0.5
    outs = []
    for roi in rois:
        cx, cy = roi[1] * spatial_scale, roi[2] * spatial_scale
        rw = (roi[3] * spatial_scale).clamp_min(1.0)
        rh = (roi[4] * spatial_scale).clamp_min(1.0)
        theta = roi[5] * math.pi / 180.0
        ly, lx = iy[:, None] * rh, ix[None, :] * rw
        ct, st = torch.cos(theta), torch.sin(theta)
        sx = cx + lx * ct - ly * st
        sy = cy + lx * st + ly * ct
        img = data[roi[0].long()].reshape(c, h * w)
        samp = _bilinear(img, sy.reshape(-1), sx.reshape(-1), h, w)
        outs.append(samp.reshape(c, ph, pw))
    return torch.stack(outs) if outs else data.new_zeros((0, c, ph, pw))
