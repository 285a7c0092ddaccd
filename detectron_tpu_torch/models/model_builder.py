"""Generalized R-CNN forward pieces (port of detectron_tpu/models/
model_builder.py: forward_features :120-139, forward_rpn :142-144,
generate_proposals :147-235, roi_feature_transform :238-361 on all its
branches, _c4_crop_and_head :364-383, forward_box_outputs :386-420), for
FPN bodies (ResNet-50/101/152 and ResNeXt, AffineChannel or GroupNorm,
conv5 or conv4) with a multilevel RPN, the C4 bodies with a single-level
RPN, any box head of models/registry.py, and the keypoint branch (the JAX
package builds it at :105-112 and runs it in core/test.py:254-266 and
models/train_graph.py:153-170). Every piece serves inference and
training: the RoI transforms (the FPN routes of ops/windowed_roi.py and
the C4 single-level ops/roi_align.py, with kernel K4 in the backward of
their windows; ops/multilevel_roi.py, ops/roi_pool.py, ops/roi_crop.py)
are differentiable w.r.t. the features, and proposals are detached.

One repair of the reference: the JAX package's C4 box head pools with
RoIAlign whatever FAST_RCNN.ROI_XFORM_METHOD says (_c4_crop_and_head
:376-379); the port takes the method, as Detectron does (ROADMAP Queue C).

Params are the bridged tree (models/bridge.py); activations are NHWC in the
compute dtype cfg.TPU.COMPUTE_DTYPE.
"""

import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import fast_rcnn_heads
from detectron_tpu_torch.models import fpn as fpn_mod
from detectron_tpu_torch.models import init as init_mod
from detectron_tpu_torch.models import keypoint_rcnn_heads
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.models import registry
from detectron_tpu_torch.models import resnet
from detectron_tpu_torch.models import rpn as rpn_mod
from detectron_tpu_torch.ops import multilevel_roi as ml_ops
from detectron_tpu_torch.ops import nms as nms_ops
from detectron_tpu_torch.ops import roi_align as ra_ops
from detectron_tpu_torch.ops import roi_crop as rc_ops
from detectron_tpu_torch.ops import roi_pool as rp_ops
from detectron_tpu_torch.ops import windowed_roi as win_ops
from detectron_tpu_torch.utils import tracing


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                   # The port's CPU reference precision (parity checks).
                   "float64": torch.float64}


def compute_dtype():
    return _COMPUTE_DTYPES[cfg.TPU.COMPUTE_DTYPE]


def forward_features(params, images):
    """images (B, H, W, 3) BGR, mean-subtracted, zero-padded (their
    space_to_depth blocks with TPU.S2D_INPUT). Returns (features, scales):
    the FPN's [P2, ..., P6] and their scales, or a C4 body's [res4] and
    [1/16]."""
    init_mod.check_model_supported()
    _, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    body_p, fpn_p = params["body"], params.get("fpn")
    if cfg.TRAIN.FREEZE_CONV_BODY:
        # The whole conv body, FPN included, trains no parameters.
        body_p = L.stop_gradient(body_p)
        if fpn_p is not None:
            fpn_p = L.stop_gradient(fpn_p)
    with tracing.span("body"):
        outs = resnet.apply_body(body_p, images.to(compute_dtype()),
                                 num_stages)
    if cfg.FPN.FPN_ON:
        with tracing.span("fpn"):
            return fpn_mod.apply_fpn(fpn_p, outs)
    return [outs[-1]], [1.0 / 16.0]


@tracing.spanned("rpn")
def forward_rpn(params, features):
    """Per-level (cls_logits, bbox_pred), the RPN head shared by levels."""
    return [rpn_mod.apply_rpn_head(params["rpn"], f) for f in features]


@torch.no_grad()
@tracing.spanned("proposals")
def generate_proposals(rpn_outs, features, im_info, training):
    """Proposals for the whole batch, from the TRAIN.RPN_* settings when
    `training`, else the TEST.RPN_* ones. Returns (rois (B, R, 4),
    roi_scores (B, R), valid (B, R)), R = the phase's RPN_POST_NMS_TOP_N
    (at most the number of slots). Never differentiable: the reference's
    proposals are host numpy, and NMS has no gradient.

    Per level (the FPN's five, or a C4 model's one): top-k preselection,
    decode, clip, min-size filter; then NMS of every level's lanes in one
    K1 call (nms_stacked_mask), and per level one of two forms, as in the
    JAX package: the keep-mask form when post_n covers every slot of the
    level, else the compacted form truncating survivors to post_n."""
    phase = cfg.TRAIN if training else cfg.TEST
    pre_n, post_n = phase.RPN_PRE_NMS_TOP_N, phase.RPN_POST_NMS_TOP_N
    nms_thresh, min_size = phase.RPN_NMS_THRESH, phase.RPN_MIN_SIZE
    im_info = im_info.to(torch.float32)

    prepped = []
    for (cls_logits, bbox_pred), (stride, sizes, ratios) in zip(
            rpn_outs, rpn_mod.anchor_configs()):
        _, H, W, _ = cls_logits.shape
        anchors = rpn_mod.level_anchors(stride, sizes, ratios, H, W,
                                        cls_logits.device)
        prepped.append(rpn_mod.proposals_prep(
            cls_logits, bbox_pred, anchors, im_info, min_size, pre_n))
    keeps = nms_ops.nms_stacked_mask([b for b, _ in prepped],
                                     [s for _, s in prepped], nms_thresh)

    level_boxes, level_scores, level_valid = [], [], []
    for (boxes_b, scores_b), keep in zip(prepped, keeps):
        if post_n >= boxes_b.shape[1]:
            b = boxes_b * keep[..., None]
            s = torch.where(keep, scores_b, -torch.inf)
            valid = keep
        else:
            idx, valid = nms_ops.compact_keep(keep, post_n)
            b = torch.gather(boxes_b, 1, idx[..., None].expand(-1, -1, 4)) \
                * valid[..., None]
            s = torch.where(valid, torch.gather(scores_b, 1, idx),
                            -torch.inf)
        level_boxes.append(b)
        level_scores.append(s)
        level_valid.append(valid)

    if len(level_boxes) == 1:
        return level_boxes[0], level_scores[0], level_valid[0]
    return rpn_mod.collect_proposals(level_boxes, level_scores, level_valid,
                                     post_n)


@tracing.spanned("roi_xform")
def roi_feature_transform(features, scales, rois, resolution,
                          sampling_ratio, method="RoIAlign"):
    """The RoI transform `method`, differentiable w.r.t. the features.
    rois (B, R, 4). Returns (B, R, P, P, C) in (p, q) order.

    - RoIAlign: on one feature map (a C4 model's res4) single-level
      RoIAlign (ops/roi_align.py, K2 / K4). On an FPN's levels the route
      of TPU.ROI_IMPL (ops/windowed_roi.py; JAX model_builder.py:289-361):
      'pallas' takes the window-rung ladder (narrowed under
      TPU.ROI_LADDER_NARROW) where TPU.ROI_LADDER is on and more than one
      level pools, else the single window of TPU.ROI_WINDOW;
      'windowed' the windowed hybrid, image by image; any other value the
      exact gather (ops/multilevel_roi.py), image by image.
    - RoIPoolF (one feature map): ops/roi_pool.py.
    - RoICrop: ops/roi_crop.py at 2P then a 2 x 2 max pool under
      CROP_RESIZE_WITH_MAX_POOL; on an FPN every RoI is cropped from every
      level and takes its own level's crop (JAX model_builder.py:260-287).
    """
    lo = fpn_mod.lowest_backbone_lvl()
    k_min, k_max = cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL
    if method == "RoIPoolF":
        if len(features) != 1:
            raise NotImplementedError(init_mod.NOT_IN_REFERENCE
                                      + "RoIPoolF on an FPN")
        return rp_ops.roi_pool_batched(features[0], rois, scales[0],
                                       resolution)
    if method == "RoICrop":
        mp = cfg.CROP_RESIZE_WITH_MAX_POOL
        if len(features) == 1:
            return rc_ops.roi_crop_batched(features[0], rois, scales[0],
                                           resolution, mp)
        lvls = ml_ops.roi_levels(rois, k_min, k_max,
                                 cfg.FPN.ROI_CANONICAL_SCALE,
                                 cfg.FPN.ROI_CANONICAL_LEVEL)
        out = None
        for lvl in range(k_min, k_max + 1):
            crop = rc_ops.roi_crop_batched(features[lvl - lo], rois,
                                           scales[lvl - lo], resolution, mp)
            sel = (lvls == lvl)[..., None, None, None]
            out = torch.where(sel, crop, 0.0 if out is None else out)
        return out
    if method != "RoIAlign":
        raise ValueError("Unknown ROI_XFORM_METHOD " + method)
    if len(features) == 1:
        return ra_ops.roi_align_batched(features[0], rois, scales[0],
                                        resolution, sampling_ratio)
    feats = list(features[k_min - lo:k_max - lo + 1])
    feat_scales = tuple(scales[k_min - lo:k_max - lo + 1])
    args = (resolution, sampling_ratio, k_min, k_max,
            cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
    if cfg.TPU.ROI_IMPL == "pallas":
        if cfg.TPU.ROI_LADDER and len(feats) > 1:
            return win_ops.multilevel_roi_align_ladder_trainable(
                feats, feat_scales, rois, *args,
                tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS),
                cfg.TPU.ROI_LADDER_NARROW)
        return win_ops.multilevel_roi_align_single_window_hybrid(
            feats, feat_scales, rois, *args, window=cfg.TPU.ROI_WINDOW)
    rois = rois.detach()
    if cfg.TPU.ROI_IMPL == "windowed":
        def one_image(f, r):
            return win_ops.multilevel_roi_align_hybrid(
                f, feat_scales, r, *args, window=cfg.TPU.ROI_WINDOW,
                chunk=cfg.TPU.ROI_CHUNK)
    else:
        def one_image(f, r):
            return ml_ops.multilevel_roi_align(f, feat_scales, r, *args)
    return torch.stack([one_image([f[b] for f in feats], rois[b])
                        for b in range(rois.shape[0])])


def forward_box_outputs(params, features, scales, rois, model_group=None):
    """RoI transform + box head + outputs: the head FAST_RCNN.ROI_BOX_HEAD
    names (models/registry.py; a C4 model's res5 and a spatial mean on
    14 x 14 pooled res4 features), all RoIs of the batch at once (the JAX
    package runs the C4 head in RoI chunks of TPU.ROI_CHUNK to bound its
    RoIAlign's dense intermediate, which K2 does not make). rois (B, R, 4)
    -> (cls_logits (B, R, C), bbox_pred (B, R, 4C'), head features
    (B*R, D)). With a model_group (training on a data x model mesh) the
    box head's fc6 is this rank's column shard (and fc7's weight its row
    shard, parallel/mesh.py::shard_dim); a head without fc6 (C4's res5)
    is replicated."""
    init_mod.check_model_supported()
    B, R = rois.shape[:2]
    roi_feat = roi_feature_transform(
        features, scales, rois, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
        cfg.FAST_RCNN.ROI_XFORM_METHOD)
    head = registry.get_func(init_mod.box_head_name())
    roi_feat = roi_feat.reshape((B * R,) + roi_feat.shape[2:])
    with tracing.span("box_head"):
        if model_group is None or "fc6" not in params["box_head"]:
            feat = head.apply(params["box_head"], roi_feat)
        else:
            feat = head.apply(params["box_head"], roi_feat,
                              model_group=model_group)
        cls_logits, bbox_pred = fast_rcnn_heads.apply_fast_rcnn_outputs(
            params["box_outs"], feat)
    return cls_logits.reshape(B, R, -1), bbox_pred.reshape(B, R, -1), feat


def forward_keypoint_outputs(params, features, scales, rois):
    """The RoI transform at KRCNN.ROI_XFORM_RESOLUTION (on an FPN RoIAlign
    through the ladder: kernels K2 and K3; K4 in the backward) + pose
    head + outputs. rois (B, R, 4)
    -> heatmap logits (B * R, S, S, NUM_KEYPOINTS) in the compute
    dtype."""
    B, R = rois.shape[:2]
    roi_feat = roi_feature_transform(
        features, scales, rois, cfg.KRCNN.ROI_XFORM_RESOLUTION,
        cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO, cfg.KRCNN.ROI_XFORM_METHOD)
    with tracing.span("kps_head"):
        h = keypoint_rcnn_heads.apply_pose_head(
            params["kps_head"],
            roi_feat.reshape((B * R,) + roi_feat.shape[2:]))
        return keypoint_rcnn_heads.apply_keypoint_outputs(
            params["kps_outs"], h)
