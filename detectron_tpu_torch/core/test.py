"""Batched detection and the per-image host paths (port of
detectron_tpu/core/test.py: detect_graph :49-63,
detect_graph_with_proposals :66-74, _detect_tail :77-126,
nms_and_limit_graph :129-196, detect_raw :199-223, mask_graph :226-251,
keypoint_graph :254-266, mask_on_boxes_graph :268-287, kps_on_boxes_graph
:290-293, im_detect_all :296-381, _sel_probs :384-393,
box_results_with_nms_and_limit :400-454).

The whole batch runs backbone, RPN, proposals, box head, softmax, per-class
decode, per-class NMS (kernel K1), the cross-class top-D limit and the mask
and keypoint heads on the final detections. Where the JAX graph branches
with lax.cond (the untruncated per-class NMS re-run) the eager port
branches in Python. im_detect_all is the per-image path of Soft-NMS and box
voting: the raw scores and boxes of detect_raw, NMS on the host in numpy,
then the mask and keypoint heads on the survivors. Test-time augmentation
(ROADMAP Queue A, A9) is not ported yet.
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import mask_rcnn_heads
from detectron_tpu_torch.models import model_builder as mb
from detectron_tpu_torch.ops import box_ops
from detectron_tpu_torch.ops import nms as nms_ops
from detectron_tpu_torch.ops.topk import top_k
from detectron_tpu_torch.utils import boxes as box_utils


@torch.no_grad()
def detect_graph(params, images, im_info):
    """images (B, H, W, 3), im_info (B, 3) [h, w, scale]. Returns a dict:
      boxes (B, D, 4) scaled-image coords, scores (B, D), classes (B, D)
      int32 (1..C-1), valid (B, D) bool, with MASK_ON mask_probs
      (B, D, M, M), and with KEYPOINTS_ON kps_heatmaps (B, D, S, S, K)
      float32 logits; D = TEST.DETECTIONS_PER_IM."""
    features, scales = mb.forward_features(params, images)
    rpn_outs = mb.forward_rpn(params, features)
    rois, _, roi_valid = mb.generate_proposals(rpn_outs, features, im_info,
                                                False)
    return _detect_tail(params, features, scales, rois, roi_valid, im_info)


@torch.no_grad()
def detect_graph_with_proposals(params, images, im_info, proposals,
                                prop_valid):
    """Fast R-CNN mode (cfg.TEST.PRECOMPUTED_PROPOSALS): detect_graph on
    given proposals (B, R, 4) in scaled-image coords with validity
    (B, R), skipping the RPN. DEDUP_BOXES runs on the host before
    (core/test_engine.py)."""
    features, scales = mb.forward_features(params, images)
    return _detect_tail(params, features, scales, proposals, prop_valid,
                        im_info)


@torch.no_grad()
def _detect_tail(params, features, scales, rois, roi_valid, im_info):
    """Box head + decode + per-class NMS + top-D limit + mask and keypoint
    heads."""
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
    if cfg.MODEL.KEYPOINTS_ON:
        out["kps_heatmaps"] = keypoint_graph(params, features, scales,
                                             out_boxes)
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
def detect_raw(params, images, im_info):
    """Pre-NMS detection outputs of the whole batch (the reference's
    im_detect_bbox surface): softmax scores (B, R, C), decoded and clipped
    per-class boxes (B, R, 4C'), the proposals' validity (B, R) and the
    proposals (B, R, 4)."""
    features, scales = mb.forward_features(params, images)
    rpn_outs = mb.forward_rpn(params, features)
    rois, _, roi_valid = mb.generate_proposals(rpn_outs, features, im_info,
                                                False)
    cls_logits, bbox_pred, _ = mb.forward_box_outputs(params, features,
                                                      scales, rois)
    probs = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    probs = torch.where(roi_valid[..., None], probs, 0.0)
    im_info = im_info.to(torch.float32)
    if cfg.TEST.BBOX_REG:
        pred = box_ops.bbox_transform(
            rois, bbox_pred.to(torch.float32),
            tuple(cfg.MODEL.BBOX_REG_WEIGHTS), clip=cfg.BBOX_XFORM_CLIP)
        pred = box_ops.clip_tiled_boxes(pred, im_info[:, None, 0:1],
                                        im_info[:, None, 1:2])
    else:
        pred = rois.repeat(1, 1, bbox_pred.shape[-1] // 4)
    return {"scores": probs, "boxes": pred, "valid": roi_valid,
            "rois": rois}


def _mask_logits(params, features, scales, det_boxes):
    """Mask head logits (B * D, M, M, C') on boxes (B, D, 4) in scaled
    coords; a v0upshare head runs the box head's res5 (JAX core/test.py
    :231-238, :276-283)."""
    B, D = det_boxes.shape[:2]
    roi_feat = mb.roi_feature_transform(
        features, scales, det_boxes, cfg.MRCNN.ROI_XFORM_RESOLUTION,
        cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO, cfg.MRCNN.ROI_XFORM_METHOD)
    h = mask_rcnn_heads.apply_mask_head(
        params["mask_head"], roi_feat.reshape((B * D,) + roi_feat.shape[2:]),
        shared_res5_params=mask_rcnn_heads.shared_res5(params))
    return mask_rcnn_heads.apply_mask_outputs(params["mask_outs"], h)


@torch.no_grad()
def mask_graph(params, features, scales, det_boxes, det_classes):
    """Mask head on the final detections. det_boxes (B, D, 4) scaled
    coords. Returns (B, D, M, M) sigmoid probs of each detection's class
    channel."""
    B, D = det_boxes.shape[:2]
    logits = _mask_logits(params, features, scales, det_boxes)
    M = logits.shape[1]
    if logits.shape[-1] > 1:
        sel = torch.gather(
            logits, 3, det_classes.reshape(B * D, 1, 1, 1).long().expand(
                -1, M, M, 1))[..., 0]
    else:
        sel = logits[..., 0]
    return torch.sigmoid(sel.reshape(B, D, M, M).to(torch.float32))


@torch.no_grad()
def keypoint_graph(params, features, scales, det_boxes):
    """Keypoint head on the final detections (the reference's
    im_detect_keypoints). det_boxes (B, D, 4) scaled coords. Returns the
    raw heatmaps (B, D, S, S, K) in float32."""
    B, D = det_boxes.shape[:2]
    hm = mb.forward_keypoint_outputs(params, features, scales, det_boxes)
    return hm.reshape((B, D) + hm.shape[1:]).to(torch.float32)


@torch.no_grad()
def mask_on_boxes_graph(params, images, im_info, det_boxes):
    """Recompute features and run the mask head on given boxes (B, D, 4)
    in scaled coords (the host-NMS path's im_detect_mask). Returns sigmoid
    probs of every class channel, (B, D, M, M, C')."""
    features, scales = mb.forward_features(params, images)
    B, D = det_boxes.shape[:2]
    logits = _mask_logits(params, features, scales, det_boxes)
    M = logits.shape[1]
    return torch.sigmoid(logits.reshape(B, D, M, M, -1).to(torch.float32))


@torch.no_grad()
def kps_on_boxes_graph(params, images, im_info, det_boxes):
    """Recompute features and run the keypoint head on given boxes
    (B, D, 4) in scaled coords. Returns heatmaps (B, D, S, S, K)."""
    features, scales = mb.forward_features(params, images)
    return keypoint_graph(params, features, scales, det_boxes)


def _on_boxes(graph, params, blob, im_info, boxes, scale, device):
    """graph(params, blob, im_info, boxes) over image boxes (n, 4), padded
    to DETECTIONS_PER_IM at a time: the host limit keeps every box tied
    with the last one it admits, so there can be more. Returns the first
    image's outputs of the n boxes, numpy."""
    D_fix = cfg.TEST.DETECTIONS_PER_IM
    outs = []
    for s in range(0, len(boxes), D_fix):
        n = min(len(boxes) - s, D_fix)
        padded = np.zeros((D_fix, 4), np.float32)
        padded[:n] = boxes[s:s + n]
        out = graph(params, blob, im_info,
                    torch.from_numpy((padded * scale)[None]).to(device))
        outs.append(out[0, :n].cpu().numpy())
    return np.concatenate(outs)


def im_detect_all(params, im, device):
    """One image through detect_raw, host NMS (Soft-NMS and box voting as
    cfg.TEST says) and the mask and keypoint heads on the survivors (the
    reference's lib/core/test.py :: im_detect_all without test-time
    augmentation). im: (H, W, 3) uint8 BGR. Returns (cls_boxes, cls_segms,
    cls_keyps) in the reference's per-class list format, boxes and
    keypoints in original image coordinates; cls_segms without MASK_ON
    and cls_keyps without KEYPOINTS_ON are None. Every box gets its mask
    and keypoints, also past DETECTIONS_PER_IM (the JAX package's copy
    runs the heads on the first DETECTIONS_PER_IM only; its segm
    evaluation then indexes past the end of an image's RLEs, and its
    keypoint results leave such boxes out)."""
    from detectron_tpu_torch.core import test_aug
    from detectron_tpu_torch.core import test_engine

    if cfg.TEST.BBOX_AUG.ENABLED or cfg.TEST.MASK_AUG.ENABLED or \
            cfg.TEST.KPS_AUG.ENABLED:
        raise NotImplementedError("not ported yet (ROADMAP Queue A, A9): "
                                  "test-time augmentation "
                                  "(im_detect_bbox_aug, im_detect_mask_aug, "
                                  "im_detect_kps_aug)")
    blob, scale, im_info = test_aug._prep(im, cfg.TEST.SCALE,
                                          cfg.TEST.MAX_SIZE)
    blob = torch.from_numpy(blob).to(device)
    im_info = torch.from_numpy(im_info).to(device)
    out = detect_raw(params, blob, im_info)
    scores = out["scores"][0].cpu().numpy()
    boxes = out["boxes"][0].cpu().numpy() / scale

    _, _, cls_boxes = box_results_with_nms_and_limit(scores, boxes)

    cls_segms = cls_keyps = None
    num_classes = cfg.MODEL.NUM_CLASSES
    # Flatten per-class results to run the heads once over all
    # detections.
    det_boxes = np.vstack(
        [cls_boxes[j][:, :4] for j in range(1, num_classes)
         if len(cls_boxes[j])] or [np.zeros((0, 4), np.float32)])
    det_classes = np.concatenate(
        [np.full(len(cls_boxes[j]), j, np.int32)
         for j in range(1, num_classes) if len(cls_boxes[j])] or
        [np.zeros((0,), np.int32)])

    if cfg.MODEL.MASK_ON and det_boxes.shape[0] > 0:
        probs_c = _on_boxes(mask_on_boxes_graph, params, blob, im_info,
                            det_boxes, scale, device)
        rles = test_engine.segm_results(
            det_boxes, det_classes,
            _sel_probs(probs_c, det_classes, len(det_classes)),
            im.shape[0], im.shape[1])
        cls_segms = [[] for _ in range(num_classes)]
        for r, j in zip(rles, det_classes):
            cls_segms[j].append(r)

    if cfg.MODEL.KEYPOINTS_ON and det_boxes.shape[0] > 0:
        hm = _on_boxes(kps_on_boxes_graph, params, blob, im_info, det_boxes,
                       scale, device)
        xy = test_engine.keypoint_results(det_boxes, hm)
        cls_keyps = [[] for _ in range(num_classes)]
        for k_i, j in enumerate(det_classes):
            cls_keyps[j].append(xy[k_i])

    return cls_boxes, cls_segms, cls_keyps


def _sel_probs(probs_all_classes, det_classes, n):
    """(D, M, M, C') -> (D, M, M) selecting each detection's class channel."""
    if probs_all_classes.ndim == 4 and probs_all_classes.shape[-1] == 1:
        return probs_all_classes[..., 0]
    out = np.zeros(probs_all_classes.shape[:3], np.float32)
    for i in range(min(n, len(det_classes))):
        out[i] = probs_all_classes[i, :, :, det_classes[i]]
    return out


# ---------------------------------------------------------------------------
# Host-side result assembly (per image)
# ---------------------------------------------------------------------------

def box_results_with_nms_and_limit(scores, boxes):
    """Host path of Soft-NMS / box voting (reference: lib/core/test.py ::
    box_results_with_nms_and_limit). scores: (R, C) softmax; boxes: (R, 4C)
    decoded. Returns (scores, boxes, cls_boxes list per class)."""
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_boxes = [[] for _ in range(num_classes)]
    for j in range(1, num_classes):
        inds = np.where(scores[:, j] > cfg.TEST.SCORE_THRESH)[0]
        scores_j = scores[inds, j]
        if boxes.shape[1] > 8:
            boxes_j = boxes[inds, j * 4:(j + 1) * 4]
        else:
            boxes_j = boxes[inds, 4:8]
        dets_j = np.hstack((boxes_j, scores_j[:, np.newaxis])).astype(
            np.float32, copy=False)
        if cfg.TEST.SOFT_NMS.ENABLED:
            nms_dets, _ = box_utils.soft_nms(
                dets_j,
                sigma=cfg.TEST.SOFT_NMS.SIGMA,
                overlap_thresh=cfg.TEST.NMS,
                score_thresh=0.0001,
                method=cfg.TEST.SOFT_NMS.METHOD,
            )
        else:
            keep = box_utils.nms(dets_j, cfg.TEST.NMS)
            nms_dets = dets_j[keep, :]
        if cfg.TEST.BBOX_VOTE.ENABLED:
            nms_dets = box_utils.box_voting(
                nms_dets, dets_j, cfg.TEST.BBOX_VOTE.VOTE_TH,
                scoring_method=cfg.TEST.BBOX_VOTE.SCORING_METHOD,
                beta=cfg.TEST.BBOX_VOTE.SCORING_METHOD_BETA,
            )
        cls_boxes[j] = nms_dets

    # Limit to DETECTIONS_PER_IM over all classes
    if cfg.TEST.DETECTIONS_PER_IM > 0:
        image_scores = np.hstack(
            [cls_boxes[j][:, -1] for j in range(1, num_classes)
             if len(cls_boxes[j])] or [np.array([])])
        if len(image_scores) > cfg.TEST.DETECTIONS_PER_IM:
            image_thresh = np.sort(image_scores)[
                -cfg.TEST.DETECTIONS_PER_IM]
            for j in range(1, num_classes):
                if len(cls_boxes[j]) == 0:
                    continue
                keep = np.where(cls_boxes[j][:, -1] >= image_thresh)[0]
                cls_boxes[j] = cls_boxes[j][keep, :]

    im_results = np.vstack(
        [cls_boxes[j] for j in range(1, num_classes) if len(cls_boxes[j])]
        or [np.zeros((0, 5), np.float32)])
    boxes_out = im_results[:, :-1]
    scores_out = im_results[:, -1]
    return scores_out, boxes_out, cls_boxes
