"""The training forward: features -> RPN -> proposals -> RoI sampling ->
heads -> losses (port of detectron_tpu/models/train_graph.py: _all_anchors
:31-53, training_losses :56-175), for the box, mask and keypoint branches,
on an FPN or a C4 model (whose v0upshare mask head runs the box head's
res5, so res5 gets the gradient of both branches).
With RPN.RPN_ON off (Fast R-CNN training) the RoIs are the batch's
precomputed proposals, and there are no RPN losses.

Batch layout (padded static shapes, tensors on one device):
  images      (B, H, W, 3)  BGR, mean-subtracted, zero-padded
  im_info     (B, 3)        [scaled_h, scaled_w, scale]
  gt_boxes    (B, G, 4)     scaled coords, non-crowd
  gt_classes  (B, G)        int32 contiguous category ids (1..C-1)
  gt_valid    (B, G)        bool
  crowd_boxes (B, K, 4), crowd_valid (B, K)
  gt_masks    (B, G, Mh, Mw) (only with MASK_ON)
  gt_keypoints (B, G, K, 3) [x, y, visibility], scaled coords (only with
              KEYPOINTS_ON)
  proposals   (B, Rp, 4), prop_valid (B, Rp) (only with the RPN off;
              Rp = TPU.MAX_TRAIN_PROPOSALS, scaled coords)

The JAX step draws its sampling uniforms from a key inside the graph; here
they are an argument, `draws`, made by make_draws from an explicit CPU
torch.Generator: a CPU run and a GPU run with the same generator seed
sample the same anchors and RoIs.
"""

import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import keypoint_rcnn_heads
from detectron_tpu_torch.models import losses as L
from detectron_tpu_torch.models import mask_rcnn_heads
from detectron_tpu_torch.models import model_builder as mb
from detectron_tpu_torch.models import rpn as rpn_mod
from detectron_tpu_torch.models import targets as T


def _check_supported():
    """A keypoint head whose heatmaps differ in size from the targets'
    KRCNN.HEATMAP_SIZE bins has no loss: raise before any work (the JAX
    package's loss reads bins past the heatmap and goes NaN)."""
    if not cfg.MODEL.KEYPOINTS_ON:
        return
    side = keypoint_rcnn_heads.output_side(cfg.KRCNN.ROI_XFORM_RESOLUTION)
    if side != cfg.KRCNN.HEATMAP_SIZE:
        raise ValueError(
            "the keypoint head puts out {0} x {0} heatmaps (KRCNN."
            "ROI_XFORM_RESOLUTION {1}, USE_DECONV {2}, USE_DECONV_OUTPUT "
            "{3}, UP_SCALE {4}), but KRCNN.HEATMAP_SIZE is {5}".format(
                side, cfg.KRCNN.ROI_XFORM_RESOLUTION, cfg.KRCNN.USE_DECONV,
                cfg.KRCNN.USE_DECONV_OUTPUT, cfg.KRCNN.UP_SCALE,
                cfg.KRCNN.HEATMAP_SIZE))


def _level_size(n, lvl):
    """Feature size at level lvl (stride 2**lvl) of an input side n: every
    stride-2 layer of the body (7x7/2 stem, 3x3/2 pool, the stride-2 1x1
    or 3x3 of res3-5) and P6's [::2] map n to (n - 1) // 2 + 1."""
    for _ in range(lvl):
        n = (n - 1) // 2 + 1
    return n


def draw_sizes(image_hw, num_gt):
    """(A_tot, R + G) for images of (H, W): the anchor count over the RPN
    levels (the FPN's, or a C4 model's one at RPN.STRIDE) and the RoI
    candidates per image (the proposals that generate_proposals returns
    in training, plus the gt boxes). With the RPN off: (0,
    TPU.MAX_TRAIN_PROPOSALS + G), the precomputed proposals' padded count
    plus the gt boxes."""
    if not cfg.RPN.RPN_ON:
        return 0, cfg.TPU.MAX_TRAIN_PROPOSALS + num_gt
    pre_n = cfg.TRAIN.RPN_PRE_NMS_TOP_N
    post_n = cfg.TRAIN.RPN_POST_NMS_TOP_N
    n_anchors = 0
    n_props = 0
    for stride, sizes, ratios in rpn_mod.anchor_configs():
        lvl = int(stride).bit_length() - 1
        n = _level_size(image_hw[0], lvl) * _level_size(image_hw[1], lvl) \
            * len(sizes) * len(ratios)
        n_anchors += n
        k = min(pre_n, n)
        n_props += k if post_n >= k else post_n
    return n_anchors, min(post_n, n_props) + num_gt


def make_draws(generator, batch_size, image_hw, num_gt, device):
    """The step's sampling uniforms in [0, 1), float32, drawn on the CPU
    from `generator` and moved to `device`: rpn_fg, rpn_bg (B, A_tot)
    (none with the RPN off) and roi_fg, roi_bg (B, R + G)."""
    n_anchors, n_rois = draw_sizes(image_hw, num_gt)
    names = (("rpn_fg", n_anchors), ("rpn_bg", n_anchors)) \
        if cfg.RPN.RPN_ON else ()
    draws = {}
    for name, n in names + (("roi_fg", n_rois), ("roi_bg", n_rois)):
        draws[name] = torch.rand((batch_size, n), generator=generator,
                                 dtype=torch.float32).to(device)
    return draws


def _all_anchors(rpn_outs):
    """The anchor fields of every RPN level concatenated (A_tot, 4), with
    the logits (B, A_tot) and deltas (B, A_tot, 4) in the same order."""
    anchors, logits, deltas = [], [], []
    for (cls_logits, bbox_pred), (stride, sizes, ratios) in zip(
            rpn_outs, rpn_mod.anchor_configs()):
        B, H, W, A = cls_logits.shape
        anchors.append(rpn_mod.level_anchors(stride, sizes, ratios, H, W,
                                             cls_logits.device))
        logits.append(cls_logits.reshape(B, H * W * A))
        deltas.append(bbox_pred.reshape(B, H * W * A, 4))
    return (torch.cat(anchors, dim=0), torch.cat(logits, dim=1),
            torch.cat(deltas, dim=1))


def _check_draws(draws, name, shape):
    if tuple(draws[name].shape) != shape:
        raise ValueError("draws[{!r}] has shape {}, the step needs {}".format(
            name, tuple(draws[name].shape), shape))


def training_losses(params, batch, draws):
    """Returns (total_loss, dict of the losses and accuracy_cls), all
    float32 scalars on the batch's device."""
    _check_supported()
    images, im_info = batch["images"], batch["im_info"]
    B = images.shape[0]
    im_info = im_info.to(torch.float32)
    features, scales = mb.forward_features(params, images)
    out = {}
    if cfg.RPN.RPN_ON:
        rpn_outs = mb.forward_rpn(params, features)

        # RPN losses over the sampled anchors.
        anchors, rpn_logits, rpn_deltas = _all_anchors(rpn_outs)
        for name in ("rpn_fg", "rpn_bg"):
            _check_draws(draws, name, (B, anchors.shape[0]))
        tgt = T.rpn_targets(anchors, batch["gt_boxes"], batch["gt_valid"],
                            im_info[:, :2], draws["rpn_fg"], draws["rpn_bg"])
        out["loss_rpn_cls"], out["loss_rpn_bbox"] = L.rpn_losses(
            rpn_logits.reshape(-1), rpn_deltas.reshape(-1, 4),
            tgt["labels"].reshape(-1), tgt["bbox_targets"].reshape(-1, 4),
            tgt["fg"].reshape(-1))

        # Proposals (detached) and RoI sampling.
        rois, _, prop_valid = mb.generate_proposals(rpn_outs, features,
                                                    im_info, True)
    else:
        # Fast R-CNN mode: the precomputed proposals (TRAIN.PROPOSAL_FILES,
        # padded by the loader), no RPN losses.
        rois, prop_valid = batch["proposals"], batch["prop_valid"]
    n_rois = rois.shape[1] + batch["gt_boxes"].shape[1]
    for name in ("roi_fg", "roi_bg"):
        _check_draws(draws, name, (B, n_rois))
    sampled = T.sample_rois(rois, prop_valid, batch["gt_boxes"],
                            batch["gt_classes"], batch["gt_valid"],
                            batch["crowd_boxes"], batch["crowd_valid"],
                            draws["roi_fg"], draws["roi_bg"])

    # Box head.
    cls_logits, bbox_pred, _ = mb.forward_box_outputs(
        params, features, scales, sampled["rois"])
    S = sampled["rois"].shape[1]
    out["loss_cls"], out["loss_bbox"], out["accuracy_cls"] = \
        L.fast_rcnn_losses(cls_logits.reshape(B * S, -1),
                           bbox_pred.reshape(B * S, -1),
                           sampled["labels"].reshape(-1),
                           sampled["valid"].reshape(-1),
                           sampled["bbox_targets"].reshape(-1, 4),
                           sampled["fg"].reshape(-1))

    # Mask and keypoint branches on the fg-first slice of the sampled RoIs.
    fg_cap = int(round(cfg.TRAIN.FG_FRACTION * cfg.TRAIN.BATCH_SIZE_PER_IM))
    if cfg.MODEL.MASK_ON:
        mask_rois = sampled["rois"][:, :fg_cap]
        roi_feat = mb.roi_feature_transform(
            features, scales, mask_rois, cfg.MRCNN.ROI_XFORM_RESOLUTION,
            cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO, cfg.MRCNN.ROI_XFORM_METHOD)
        mh = mask_rcnn_heads.apply_mask_head(
            params["mask_head"],
            roi_feat.reshape((B * fg_cap,) + roi_feat.shape[2:]),
            shared_res5_params=mask_rcnn_heads.shared_res5(params))
        mlogits = mask_rcnn_heads.apply_mask_outputs(params["mask_outs"], mh)
        res = cfg.MRCNN.RESOLUTION
        mtgt, mw = T.mask_targets(mask_rois, sampled["fg"][:, :fg_cap],
                                  sampled["gt_idx"][:, :fg_cap],
                                  batch["gt_boxes"], batch["gt_masks"], res)
        out["loss_mask"] = L.mask_rcnn_losses(
            mlogits.reshape(B * fg_cap, res, res, -1),
            mtgt.reshape(B * fg_cap, res, res),
            sampled["labels"][:, :fg_cap].reshape(-1), mw.reshape(-1))

    if cfg.MODEL.KEYPOINTS_ON:
        kps_rois = sampled["rois"][:, :fg_cap]
        klogits = mb.forward_keypoint_outputs(params, features, scales,
                                              kps_rois)
        kbins, kweights = T.keypoint_targets(
            kps_rois, sampled["fg"][:, :fg_cap],
            sampled["gt_idx"][:, :fg_cap], batch["gt_keypoints"])
        K = kbins.shape[-1]
        out["loss_kps"] = L.keypoint_losses(
            klogits, kbins.reshape(B * fg_cap, K),
            kweights.reshape(B * fg_cap, K))

    total = sum(v for k, v in out.items() if k.startswith("loss_"))
    return total, out
