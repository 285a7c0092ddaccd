"""RPN heads and proposal generation (port of detectron_tpu/models/rpn.py:
num_cell_anchors :33-37, apply_rpn_head :54-59, level_anchors,
proposals_prep_one_level :80-101, collect_proposals :147-157, and
fpn_anchor_config as anchor_configs), batched over images. An FPN model
runs one head, shared by its levels, with one anchor size a level; a C4
model runs it on the res4 map alone, with every RPN.SIZES x
RPN.ASPECT_RATIOS anchor at stride RPN.STRIDE.
"""

import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.ops import anchors as anchor_ops
from detectron_tpu_torch.ops import box_ops
from detectron_tpu_torch.ops import topk as topk_ops
from detectron_tpu_torch.utils import tracing


def apply_rpn_head(p, feat):
    """feat (B, H, W, C) -> (cls_logits (B, H, W, A), bbox_pred
    (B, H, W, 4A))."""
    h = L.conv2d(p["conv_rpn"], feat, stride=1, padding=1, relu=True)
    return (L.conv2d(p["rpn_cls_logits"], h, stride=1, padding=0),
            L.conv2d(p["rpn_bbox_pred"], h, stride=1, padding=0))


def level_anchors(stride, sizes, aspect_ratios, feat_h, feat_w, device):
    """The (H*W*A, 4) anchor field of one level (ops/anchors.py)."""
    tracing.sync("rpn.anchors")  # a blocking copy from pageable memory
    return torch.from_numpy(anchor_ops.anchor_field(
        stride, sizes, aspect_ratios, feat_h, feat_w)).to(device)


def is_multilevel():
    return bool(cfg.FPN.FPN_ON and cfg.FPN.MULTILEVEL_RPN)


def num_cell_anchors():
    """Anchors per feature cell: the aspect ratios of an FPN level, or
    every size and ratio of the single-level RPN."""
    if is_multilevel():
        return len(cfg.FPN.RPN_ASPECT_RATIOS)
    return len(cfg.RPN.ASPECT_RATIOS) * len(cfg.RPN.SIZES)


def anchor_configs():
    """(stride, sizes, aspect_ratios) of each RPN level, in the order of
    forward_rpn's outputs: one size a level on the FPN's, from
    RPN_ANCHOR_START_SIZE at RPN_MIN_LEVEL doubling a level."""
    if is_multilevel():
        lo = cfg.FPN.RPN_MIN_LEVEL
        return [(2 ** lvl, (cfg.FPN.RPN_ANCHOR_START_SIZE * 2 ** (lvl - lo),),
                 cfg.FPN.RPN_ASPECT_RATIOS)
                for lvl in range(lo, cfg.FPN.RPN_MAX_LEVEL + 1)]
    return [(cfg.RPN.STRIDE, tuple(cfg.RPN.SIZES), cfg.RPN.ASPECT_RATIOS)]


def proposals_prep(cls_logits, bbox_pred, anchors, im_info, min_size,
                   pre_top_n):
    """Top pre_top_n proposals of one level for every image, before NMS.
    cls_logits (B, H, W, A), bbox_pred (B, H, W, 4A), im_info (B, 3).
    Returns (boxes (B, k, 4) score-descending, scores (B, k) with -inf for
    boxes under min_size * im_scale)."""
    B, H, W, A = cls_logits.shape
    n = H * W * A
    logits = cls_logits.reshape(B, n).to(torch.float32)
    deltas = bbox_pred.reshape(B, n, 4).to(torch.float32)
    top_logits, top_idx = topk_ops.topk_chunked(logits, min(pre_top_n, n))
    top_scores = torch.sigmoid(top_logits)
    boxes = box_ops.bbox_transform(
        anchors[top_idx], torch.gather(
            deltas, 1, top_idx[..., None].expand(-1, -1, 4)))
    boxes = box_ops.clip_boxes_to_image(boxes, im_info[:, 0:1],
                                        im_info[:, 1:2])
    keep = box_ops.small_box_mask(boxes, min_size * im_info[:, 2:3])
    return boxes, torch.where(keep, top_scores, -torch.inf)


def collect_proposals(level_boxes, level_scores, level_valid, post_top_n):
    """Merge per-level proposals (lists of (B, n_l, ...)) into the global
    top post_top_n of each image by score. Returns (boxes (B, R, 4),
    scores (B, R), valid (B, R))."""
    boxes = torch.cat(level_boxes, dim=1)
    scores = torch.where(torch.cat(level_valid, dim=1),
                         torch.cat(level_scores, dim=1), -torch.inf)
    top_scores, top_idx = topk_ops.top_k(scores, min(post_top_n,
                                                     scores.shape[1]))
    return (torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
            top_scores, torch.isfinite(top_scores))
