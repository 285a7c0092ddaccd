"""Box geometry on tensors (port of detectron_tpu/ops/box_ops.py:21-130).

Boxes are [x1, y1, x2, y2] with Detectron's +1 edge convention
(width = x2 - x1 + 1), kept exactly for AP parity.
"""

import math

import torch

BBOX_XFORM_CLIP_DEFAULT = math.log(1000.0 / 16.0)


def boxes_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * \
        (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes, query_boxes):
    """Pairwise IoU (..., N, K) of boxes (..., N, 4) and query_boxes
    (..., K, 4); zero where they do not overlap."""
    area_b = boxes_area(boxes)
    area_q = boxes_area(query_boxes)
    ix1 = torch.maximum(boxes[..., :, None, 0], query_boxes[..., None, :, 0])
    iy1 = torch.maximum(boxes[..., :, None, 1], query_boxes[..., None, :, 1])
    ix2 = torch.minimum(boxes[..., :, None, 2], query_boxes[..., None, :, 2])
    iy2 = torch.minimum(boxes[..., :, None, 3], query_boxes[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1 + 1.0, min=0.0) * \
        torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return torch.where(inter > 0, inter / union, 0.0)


def bbox_transform(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0),
                   clip=BBOX_XFORM_CLIP_DEFAULT):
    """Decode deltas (..., N, 4*C) against boxes (..., N, 4)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = torch.clamp(deltas[..., 2::4] / ww, max=float(clip))
    dh = torch.clamp(deltas[..., 3::4] / wh, max=float(clip))

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack([pred_ctr_x - 0.5 * pred_w,
                       pred_ctr_y - 0.5 * pred_h,
                       pred_ctr_x + 0.5 * pred_w - 1.0,
                       pred_ctr_y + 0.5 * pred_h - 1.0], dim=-1)
    return out.reshape(deltas.shape)


def bbox_transform_inv(boxes, gt_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode the regression targets taking boxes to gt_boxes (..., N, 4);
    box sizes are clamped to >= 1 (padded gt boxes are degenerate)."""
    ex_w = torch.clamp(boxes[..., 2] - boxes[..., 0] + 1.0, min=1.0)
    ex_h = torch.clamp(boxes[..., 3] - boxes[..., 1] + 1.0, min=1.0)
    ex_cx = boxes[..., 0] + 0.5 * (boxes[..., 2] - boxes[..., 0] + 1.0)
    ex_cy = boxes[..., 1] + 0.5 * (boxes[..., 3] - boxes[..., 1] + 1.0)
    gt_w = torch.clamp(gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0, min=1.0)
    gt_h = torch.clamp(gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0, min=1.0)
    gt_cx = gt_boxes[..., 0] + 0.5 * (gt_boxes[..., 2] - gt_boxes[..., 0]
                                      + 1.0)
    gt_cy = gt_boxes[..., 1] + 0.5 * (gt_boxes[..., 3] - gt_boxes[..., 1]
                                      + 1.0)
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)


def _clip_xy(x, y, height, width):
    return (torch.minimum(torch.clamp(x, min=0.0), width - 1.0),
            torch.minimum(torch.clamp(y, min=0.0), height - 1.0))


def clip_boxes_to_image(boxes, height, width):
    """Clip (..., 4) boxes to [0, width-1] x [0, height-1]; height/width are
    tensors broadcastable against the leading dims."""
    x1, y1 = _clip_xy(boxes[..., 0], boxes[..., 1], height, width)
    x2, y2 = _clip_xy(boxes[..., 2], boxes[..., 3], height, width)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def clip_tiled_boxes(boxes, height, width):
    """Clip (..., 4*C) tiled boxes; height/width broadcast against
    (..., C)."""
    x1, y1 = _clip_xy(boxes[..., 0::4], boxes[..., 1::4], height, width)
    x2, y2 = _clip_xy(boxes[..., 2::4], boxes[..., 3::4], height, width)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def small_box_mask(boxes, min_size):
    """True where width and height are both >= min_size."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return (w >= min_size) & (h >= min_size)
