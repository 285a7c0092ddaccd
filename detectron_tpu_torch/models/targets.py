"""Training targets, batched over images (port of detectron_tpu/models/
targets.py: _rank, _iof, rpn_targets_one_image :32-113,
sample_rois_one_image :120-189, mask_targets_one_image :196-239,
keypoint_targets_one_image :246-271).

Each function takes a leading image dimension B where the JAX version is
vmapped over images. Randomness is explicit: the callers pass the uniform
draws (u_fg, u_bg) as tensors, so the same draws give the same samples on
the CPU, on the card and in the JAX package. Sampling without replacement
takes the candidates of highest draw (the exp-race trick); every ranking
is a stable sort, so ties (non-candidates all at -1, the unsampled RoIs all
at the same sort key) resolve lowest index first, as jnp.argsort does, and
argmax ties take the first index, as in JAX.
"""

import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.ops import box_ops


def _rank(x):
    """Dense rank (0 = largest) of the entries of x along the last axis;
    equal entries rank in index order."""
    order = torch.argsort(-x, dim=-1, stable=True)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def _iof(boxes, crowd):
    """Intersection over the box's own area, (B, N, 4) x (B, K, 4) ->
    (B, N, K)."""
    area_b = box_ops.boxes_area(boxes)
    ix1 = torch.maximum(boxes[..., :, None, 0], crowd[..., None, :, 0])
    iy1 = torch.maximum(boxes[..., :, None, 1], crowd[..., None, :, 1])
    ix2 = torch.minimum(boxes[..., :, None, 2], crowd[..., None, :, 2])
    iy2 = torch.minimum(boxes[..., :, None, 3], crowd[..., None, :, 3])
    iw = torch.clamp(ix2 - ix1 + 1.0, min=0.0)
    ih = torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    return (iw * ih) / torch.clamp(area_b[..., :, None], min=1.0)


def _gather_rows(x, idx):
    """x (B, M, ...) and idx (B, K) -> x[b, idx[b]] (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def rpn_targets(anchors, gt_boxes, gt_valid, im_hw, u_fg, u_bg):
    """Anchor labels and regression targets (lib/roi_data/rpn.py ::
    _get_rpn_blobs, with RPN_STRADDLE_THRESH against the scaled image).

    anchors (A, 4) all levels; gt_boxes (B, G, 4); gt_valid (B, G) bool
    (non-crowd gt); im_hw (B, 2) scaled image size; u_fg, u_bg (B, A)
    uniform draws in [0, 1). Returns dict(labels (B, A) int64 in {1, 0,
    -1}, bbox_targets (B, A, 4), fg (B, A) bool)."""
    A = anchors.shape[0]
    straddle = cfg.TRAIN.RPN_STRADDLE_THRESH
    if straddle >= 0:
        inside = ((anchors[:, 0] >= -straddle)
                  & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < im_hw[:, 1:2] + straddle)
                  & (anchors[:, 3] < im_hw[:, 0:1] + straddle))
    else:
        inside = torch.ones((gt_boxes.shape[0], A), dtype=torch.bool,
                            device=anchors.device)

    iou = box_ops.bbox_overlaps(anchors, gt_boxes)             # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    anchor_max = iou.max(dim=2).values
    anchor_argmax = iou.argmax(dim=2)
    # Each gt's best anchors (ties included).
    gt_max = torch.where(inside[:, :, None], iou, -1.0).max(dim=1).values
    is_gt_best = ((iou == gt_max[:, None, :]) & (gt_max[:, None, :] > 0)
                  & gt_valid[:, None, :]).any(dim=2)

    pos = inside & (is_gt_best
                    | (anchor_max >= cfg.TRAIN.RPN_POSITIVE_OVERLAP))
    neg = inside & (anchor_max < cfg.TRAIN.RPN_NEGATIVE_OVERLAP) & ~pos

    batch = cfg.TRAIN.RPN_BATCH_SIZE_PER_IM
    num_fg_cap = int(cfg.TRAIN.RPN_FG_FRACTION * batch)
    fg_sel = pos & (_rank(torch.where(pos, u_fg, -1.0)) < num_fg_cap)
    n_fg = fg_sel.sum(dim=1, keepdim=True)
    bg_sel = neg & (_rank(torch.where(neg, u_bg, -1.0)) < batch - n_fg)

    labels = torch.where(fg_sel, 1, torch.where(bg_sel, 0, -1))
    matched_gt = _gather_rows(gt_boxes, anchor_argmax)
    targets = box_ops.bbox_transform_inv(anchors, matched_gt,
                                         (1.0, 1.0, 1.0, 1.0))
    targets = torch.where(fg_sel[..., None], targets, 0.0)
    return {"labels": labels, "bbox_targets": targets, "fg": fg_sel}


def sample_rois(proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
                crowd_boxes, crowd_valid, u_fg, u_bg):
    """Sample TRAIN.BATCH_SIZE_PER_IM RoIs per image with FG_FRACTION
    foreground, fg first (lib/roi_data/fast_rcnn.py :: _sample_rois).

    proposals (B, P, 4) with prop_valid (B, P); the gt boxes are appended
    as proposals (json_dataset.add_proposals); gt_boxes/classes/valid
    (B, G, ...); crowd_boxes/valid (B, K, ...); u_fg, u_bg (B, P + G)
    uniform draws. Returns, with S = BATCH_SIZE_PER_IM: rois (B, S, 4),
    labels (B, S) int32, valid (B, S), fg (B, S), bbox_targets (B, S, 4)
    (encoded with MODEL.BBOX_REG_WEIGHTS) and gt_idx (B, S) int32."""
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([prop_valid, gt_valid], dim=1)

    iou = box_ops.bbox_overlaps(all_boxes, gt_boxes)           # (B, N, G)
    iou = torch.where(gt_valid[:, None, :] & all_valid[:, :, None], iou, -1.0)
    max_ov = iou.max(dim=2).values
    gt_idx = iou.argmax(dim=2)

    # Proposals mostly inside a crowd region are left out entirely.
    if crowd_boxes.shape[1] > 0:
        iof = torch.where(crowd_valid[:, None, :],
                          _iof(all_boxes, crowd_boxes), 0.0)
        in_crowd = iof.max(dim=2).values > cfg.TRAIN.CROWD_FILTER_THRESH
        max_ov = torch.where(in_crowd, -1.0, max_ov)

    fg_cand = all_valid & (max_ov >= cfg.TRAIN.FG_THRESH)
    bg_cand = all_valid & (max_ov < cfg.TRAIN.BG_THRESH_HI) & \
        (max_ov >= cfg.TRAIN.BG_THRESH_LO)

    S = cfg.TRAIN.BATCH_SIZE_PER_IM
    fg_cap = int(round(cfg.TRAIN.FG_FRACTION * S))
    r_fg = torch.where(fg_cand, u_fg, -1.0)
    fg_sel = fg_cand & (_rank(r_fg) < fg_cap)
    n_fg = fg_sel.sum(dim=1, keepdim=True)
    r_bg = torch.where(bg_cand, u_bg, -1.0)
    bg_sel = bg_cand & (_rank(r_bg) < S - n_fg)

    # fg first (by draw), then bg, then everything else, in index order.
    sort_key = torch.where(fg_sel, 0.0, torch.where(bg_sel, 1.0, 2.0)) \
        * 10.0 - torch.where(fg_sel, r_fg, torch.where(bg_sel, r_bg, 0.0))
    order = torch.argsort(sort_key, dim=1, stable=True)[:, :S]

    rois = _gather_rows(all_boxes, order)
    sel_fg = torch.gather(fg_sel, 1, order)
    valid = sel_fg | torch.gather(bg_sel, 1, order)
    matched = torch.gather(gt_idx, 1, order)
    labels = torch.where(sel_fg, torch.gather(gt_classes, 1, matched), 0)
    labels = torch.where(valid, labels, 0).to(torch.int32)
    targets = box_ops.bbox_transform_inv(
        rois, _gather_rows(gt_boxes, matched),
        tuple(cfg.MODEL.BBOX_REG_WEIGHTS))
    targets = torch.where(sel_fg[..., None], targets, 0.0)
    return {"rois": rois, "labels": labels, "valid": valid, "fg": sel_fg,
            "bbox_targets": targets, "gt_idx": matched.to(torch.int32)}


def _bilinear_axis(coords, size):
    """(B, F, res) cell coordinates -> (B, F, res, size) clamp-to-edge
    bilinear weights, zero for samples outside [-1, size]."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=torch.float32, device=coords.device)
    w = torch.clamp(1.0 - torch.abs(c[..., None] - idx), min=0.0)
    return w * ((coords >= -1.0) & (coords <= size))[..., None]


def mask_targets(rois, fg, gt_idx, gt_boxes, gt_masks, resolution):
    """Binary mask targets of the fg-first RoI slice: each matched gt's
    dense mask (rasterized over its box by the loader), bilinearly sampled
    at the RoI's res x res cell centres and thresholded at 0.5.

    rois (B, F, 4); fg (B, F); gt_idx (B, F); gt_boxes (B, G, 4); gt_masks
    (B, G, Mh, Mw). Returns (targets (B, F, res, res) float32 in {0, 1},
    weights = fg)."""
    Mh, Mw = gt_masks.shape[2:]
    gb = _gather_rows(gt_boxes, gt_idx.long())
    gw = torch.clamp(gb[..., 2] - gb[..., 0], min=1e-3)
    gh = torch.clamp(gb[..., 3] - gb[..., 1], min=1e-3)
    p = (torch.arange(resolution, dtype=torch.float32, device=rois.device)
         + 0.5) / resolution
    ys = rois[..., 1, None] + p * (rois[..., 3] - rois[..., 1])[..., None]
    xs = rois[..., 0, None] + p * (rois[..., 2] - rois[..., 0])[..., None]
    my = (ys - gb[..., 1, None]) / gh[..., None] * Mh - 0.5
    mx = (xs - gb[..., 0, None]) / gw[..., None] * Mw - 0.5
    masks = _gather_rows(gt_masks, gt_idx.long()).to(torch.float32)
    sampled = torch.einsum("bfph,bfhw,bfqw->bfpq", _bilinear_axis(my, Mh),
                           masks, _bilinear_axis(mx, Mw))
    return (sampled >= 0.5).to(torch.float32), fg


def keypoint_targets(rois, fg, gt_idx, gt_keypoints):
    """Heatmap bin targets of the fg-first RoI slice (the JAX package's
    keypoint_targets_one_image, targets.py:246-271, over the batch; the
    discretization of lib/utils/keypoints.py ::
    keypoints_to_heatmap_labels).

    rois (B, F, 4); fg (B, F); gt_idx (B, F); gt_keypoints (B, G, K, 3)
    [x, y, vis]. Returns (bins (B, F, K) int64 in [0, S^2), weights
    (B, F, K) float32: 1 for a visible keypoint of a fg RoI inside it),
    S = KRCNN.HEATMAP_SIZE."""
    S = cfg.KRCNN.HEATMAP_SIZE
    kps = _gather_rows(gt_keypoints, gt_idx.long())  # (B, F, K, 3)
    x, y, vis = kps[..., 0], kps[..., 1], kps[..., 2]
    x1, y1, x2, y2 = (rois[..., i, None] for i in range(4))
    scale_x = S / torch.clamp(x2 - x1, min=1e-3)
    scale_y = S / torch.clamp(y2 - y1, min=1e-3)
    # Offset, then floor; a keypoint on the right or bottom edge goes to
    # the last bin.
    bx = torch.where(x == x2, S - 1.0, torch.floor((x - x1) * scale_x))
    by = torch.where(y == y2, S - 1.0, torch.floor((y - y1) * scale_y))
    valid = (bx >= 0) & (bx < S) & (by >= 0) & (by < S) & (vis > 0) & \
        fg[..., None]
    bins = torch.clamp((by * S + bx).to(torch.int64), 0, S * S - 1)
    return torch.where(valid, bins, 0), valid.to(torch.float32)
