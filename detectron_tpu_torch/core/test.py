"""Batched detection (port of detectron_tpu/core/test.py: detect_graph
:49-63, _detect_tail :77-126, nms_and_limit_graph :129-196, mask_graph
:226-251).

The whole batch runs backbone, RPN, proposals, box head, softmax, per-class
decode, per-class NMS (kernel K1), the cross-class top-D limit and the mask
head on the final detections. Where the JAX graph branches with lax.cond
(the untruncated per-class NMS re-run) the eager port branches in Python.
Keypoints are not ported yet.
"""

import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import mask_rcnn_heads
from detectron_tpu_torch.models import model_builder as mb
from detectron_tpu_torch.ops import box_ops
from detectron_tpu_torch.ops import nms as nms_ops
from detectron_tpu_torch.ops.topk import top_k


@torch.no_grad()
def detect_graph(params, images, im_info):
    """images (B, H, W, 3), im_info (B, 3) [h, w, scale]. Returns a dict:
      boxes (B, D, 4) scaled-image coords, scores (B, D), classes (B, D)
      int32 (1..C-1), valid (B, D) bool, and with MASK_ON mask_probs
      (B, D, M, M); D = TEST.DETECTIONS_PER_IM."""
    features, scales = mb.forward_features(params, images)
    rpn_outs = mb.forward_rpn(params, features)
    rois, _, roi_valid = mb.generate_proposals(rpn_outs, features, im_info)
    return _detect_tail(params, features, scales, rois, roi_valid, im_info)


@torch.no_grad()
def _detect_tail(params, features, scales, rois, roi_valid, im_info):
    """Box head + decode + per-class NMS + top-D limit + mask head."""
    if cfg.MODEL.KEYPOINTS_ON:
        raise NotImplementedError("not ported yet (ROADMAP Queue A item "
                                  "10): keypoint_graph")
    cls_logits, bbox_pred, _ = mb.forward_box_outputs(params, features,
                                                      scales, rois)
    B, R, C = cls_logits.shape
    probs = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    probs = torch.where(roi_valid[..., None], probs, 0.0)
    im_info = im_info.to(torch.float32)

    if cfg.TEST.BBOX_REG:
        pred = box_ops.bbox_transform(
            rois, bbox_pred.to(torch.float32),
            tuple(cfg.MODEL.BBOX_REG_WEIGHTS), clip=cfg.BBOX_XFORM_CLIP)
        pred = box_ops.clip_tiled_boxes(pred, im_info[:, None, 0:1],
                                        im_info[:, None, 1:2])
        n_reg = pred.shape[-1] // 4
        pred = pred.reshape(B, R, n_reg, 4)
        if n_reg == C:
            cls_boxes = pred[:, :, 1:, :]
        else:
            cls_boxes = pred[:, :, 1:2, :].expand(B, R, C - 1, 4)
    else:
        cls_boxes = rois[:, :, None, :].expand(B, R, C - 1, 4)

    cls_scores = probs[..., 1:]
    thresh_scores = torch.where(cls_scores > cfg.TEST.SCORE_THRESH,
                                cls_scores, -torch.inf)
    out_scores, out_boxes, out_classes, out_valid = nms_and_limit_graph(
        cls_boxes.transpose(1, 2), thresh_scores.transpose(1, 2),
        cfg.TEST.DETECTIONS_PER_IM)
    out = {"boxes": out_boxes, "scores": out_scores,
           "classes": torch.where(out_valid, out_classes, 0),
           "valid": out_valid}
    if cfg.MODEL.MASK_ON:
        out["mask_probs"] = mask_graph(params, features, scales, out_boxes,
                                       out["classes"])
    return out


@torch.no_grad()
def nms_and_limit_graph(boxes_c, scores_c, D):
    """Per-class NMS + cross-class top-D (hard-NMS mode of the reference's
    box_results_with_nms_and_limit). boxes_c (B, C-1, R, 4); scores_c
    (B, C-1, R) with -inf below SCORE_THRESH. Returns (scores (B, D),
    boxes (B, D, 4), classes (B, D) 1-based, valid (B, D))."""
    B, Cm1, R = scores_c.shape
    L = B * Cm1
    # A stable ascending sort on -score is lax.top_k's lowest-index-first
    # tie order, as the JAX tail's joint sort relies on.
    neg_sorted, order = torch.sort(-scores_c.reshape(L, R), dim=1,
                                   stable=True)
    boxes_sorted = torch.gather(boxes_c.reshape(L, R, 4), 1,
                                order[..., None].expand(-1, -1, 4))

    def nms_limit_tail(K):
        top_s = -neg_sorted[:, :K]
        top_b = boxes_sorted[:, :K]
        keep = nms_ops.nms_batched_sorted_mask(top_b, top_s, cfg.TEST.NMS)
        kept = torch.where(keep, top_s, -torch.inf).reshape(B, Cm1 * K)
        top_scores, top_idx = top_k(kept, D)
        ob = torch.gather(top_b.reshape(B, Cm1 * K, 4), 1,
                          top_idx[..., None].expand(-1, -1, 4))
        oc = torch.div(top_idx, K, rounding_mode="floor") + 1
        return top_scores, ob, oc.to(torch.int32)

    # Pre-top-K per class: exact unless a class has more than K boxes over
    # the threshold, and then the tail re-runs untruncated.
    K = min(R, max(4 * D, 128))
    if K < R and bool((torch.isfinite(scores_c).sum(-1) > K).any()):
        K = R
    top_scores, out_boxes, out_classes = nms_limit_tail(K)
    out_valid = torch.isfinite(top_scores)
    out_scores = torch.where(out_valid, top_scores, 0.0)
    return out_scores, out_boxes * out_valid[..., None], out_classes, \
        out_valid


@torch.no_grad()
def mask_graph(params, features, scales, det_boxes, det_classes):
    """Mask head on the final detections. det_boxes (B, D, 4) scaled
    coords. Returns (B, D, M, M) sigmoid probs of each detection's class
    channel."""
    B, D = det_boxes.shape[:2]
    roi_feat = mb.roi_feature_transform(
        features, scales, det_boxes, cfg.MRCNN.ROI_XFORM_RESOLUTION,
        cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO, cfg.MRCNN.ROI_XFORM_METHOD)
    h = mask_rcnn_heads.apply_mask_head(
        params["mask_head"], roi_feat.reshape((B * D,) + roi_feat.shape[2:]))
    logits = mask_rcnn_heads.apply_mask_outputs(params["mask_outs"], h)
    M = logits.shape[1]
    if logits.shape[-1] > 1:
        sel = torch.gather(
            logits, 3, det_classes.reshape(B * D, 1, 1, 1).long().expand(
                -1, M, M, 1))[..., 0]
    else:
        sel = logits[..., 0]
    return torch.sigmoid(sel.reshape(B, D, M, M).to(torch.float32))
