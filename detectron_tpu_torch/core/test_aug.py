"""Test-time augmentation: multi-scale, horizontal-flip and aspect-ratio
passes (port of detectron_tpu/core/test_aug.py :19-206; reference:
lib/core/test.py :: im_detect_bbox_aug, im_detect_mask_aug,
im_detect_keypoints_aug).

- im_detect_bbox_aug: the raw detections (core/test.py::detect_raw) of
  the base pass, its flip (TEST.BBOX_AUG.H_FLIP), each of SCALES at
  MAX_SIZE and its flip (SCALE_H_FLIP), each of ASPECT_RATIOS (the image
  warped to width x ratio) and its flip, in original image coordinates,
  combined by SCORE_HEUR / COORD_HEUR (UNION stacks, AVG averages; both
  or neither UNION). SCALE_SIZE_DEP is not supported, as in the JAX
  package.
- im_detect_mask_aug: the mask probabilities of each detection's class
  over the same scales and flips (TEST.MASK_AUG), combined by SOFT_AVG,
  SOFT_MAX or LOGIT_AVG.
- im_detect_kps_aug: the keypoint heatmaps over TEST.KPS_AUG's scales and
  flips (a flipped pass's maps flipped back and their left / right
  keypoints swapped), combined by HM_AVG or HM_MAX.

Each pass is one call of a batched graph of core/test.py on one image, on
the caller's device; the host moves boxes between coordinate frames and
combines. The mask and keypoint passes run every detection, in chunks of
TEST.DETECTIONS_PER_IM (core/test._on_boxes), where the JAX package runs
the first DETECTIONS_PER_IM alone. The aspect-ratio warp is
utils/image_io.resize of the uint8 image, rounded back to uint8 (the JAX
package calls cv2.resize, whose fixed-point uint8 arithmetic can differ
from it by one level).
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.utils import blob as blob_utils
from detectron_tpu_torch.utils import boxes as box_utils
from detectron_tpu_torch.utils import image_io


def prep_on_device(im, target_size, max_size, device, hflip=False):
    """The image (flipped with hflip) resized to target_size / max_size in
    its static canvas (JAX test_aug._prep): (blob (1, H, W, 3) and im_info
    (1, 3) as tensors on `device`, the scale)."""
    img = im[:, ::-1, :] if hflip else im
    prepped, scale = blob_utils.prep_im_for_blob(
        img, cfg.PIXEL_MEANS, target_size, max_size)
    landscape = prepped.shape[1] >= prepped.shape[0]
    canvas = blob_utils.static_canvas(target_size, max_size, landscape)
    blob = blob_utils.im_to_canvas(prepped, canvas)[None]
    im_info = np.array([[prepped.shape[0], prepped.shape[1], scale]],
                       np.float32)
    return (torch.from_numpy(blob).to(device), scale,
            torch.from_numpy(im_info).to(device))


def raw_outputs(params, blob, scale, im_info):
    """detect_raw on a prepped image -> (scores (R, C), boxes (R, 4C') in
    the original image's coordinates), numpy."""
    from detectron_tpu_torch.core import test as test_ops

    out = test_ops.detect_raw(params, blob, im_info)
    return (out["scores"][0].cpu().numpy(),
            out["boxes"][0].cpu().numpy() / scale)


def run_raw(params, im, target_size, max_size, device, hflip=False):
    """One pass of detect_raw on im at target_size / max_size (flipped
    with hflip, its boxes flipped back)."""
    scores, boxes = raw_outputs(params, *prep_on_device(
        im, target_size, max_size, device, hflip))
    if hflip:
        boxes = box_utils.flip_boxes(boxes, im.shape[1])
    return scores, boxes


def aspect_ratio_rel(im, aspect_ratio):
    """The uint8 image warped to width round(W x aspect_ratio), height
    kept (reference: lib/utils/image.py :: aspect_ratio_rel)."""
    new_w = int(np.round(im.shape[1] * aspect_ratio))
    warped = image_io.resize(im.astype(np.float32), (new_w, im.shape[0]))
    return np.clip(np.rint(warped), 0, 255).astype(np.uint8)


def im_detect_bbox_aug(params, im, device):
    """(scores, boxes) of every augmented pass, combined; the caller runs
    NMS on them (core/test.box_results_with_nms_and_limit)."""
    aug = cfg.TEST.BBOX_AUG
    if aug.SCALE_SIZE_DEP:
        raise NotImplementedError("TEST.BBOX_AUG.SCALE_SIZE_DEP is not "
                                  "supported (nor in the JAX package)")
    if (aug.SCORE_HEUR == "UNION") != (aug.COORD_HEUR == "UNION"):
        raise ValueError("TEST.BBOX_AUG: UNION must be used for both "
                         "SCORE_HEUR and COORD_HEUR or neither")
    passes = [run_raw(params, im, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE,
                      device)]
    if aug.H_FLIP:
        passes.append(run_raw(params, im, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE,
                              device, hflip=True))
    for scale in aug.SCALES:
        passes.append(run_raw(params, im, scale, aug.MAX_SIZE, device))
        if aug.SCALE_H_FLIP:
            passes.append(run_raw(params, im, scale, aug.MAX_SIZE, device,
                                  hflip=True))
    for ar in aug.ASPECT_RATIOS:
        im_ar = aspect_ratio_rel(im, ar)
        for hflip in (False, True)[:1 + bool(aug.ASPECT_RATIO_H_FLIP)]:
            s, b = run_raw(params, im_ar, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE,
                           device, hflip=hflip)
            passes.append((s, box_utils.aspect_ratio(b, 1.0 / ar)))
    scores_ts, boxes_ts = zip(*passes)
    return (_combine(scores_ts, aug.SCORE_HEUR, "SCORE_HEUR"),
            _combine(boxes_ts, aug.COORD_HEUR, "COORD_HEUR"))


def _combine(arrays, heur, key):
    if heur == "UNION":
        return np.vstack(arrays)
    if heur == "AVG":
        return np.mean(arrays, axis=0)
    raise NotImplementedError("TEST.BBOX_AUG.{} {}".format(key, heur))


def _head_passes(aug, run):
    """run(target_size, max_size, hflip) over the base pass and aug's
    flips and scales, in the JAX package's order."""
    outs = [run(cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, False)]
    if aug.H_FLIP:
        outs.append(run(cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, True))
    for scale in aug.SCALES:
        outs.append(run(scale, aug.MAX_SIZE, False))
        if aug.SCALE_H_FLIP:
            outs.append(run(scale, aug.MAX_SIZE, True))
    return outs


def im_detect_mask_aug(params, im, boxes, det_classes, device):
    """Mask probabilities (n, M, M) of each box (n, 4, image coordinates)
    in its class's channel, combined over TEST.MASK_AUG's passes."""
    from detectron_tpu_torch.core import test as test_ops

    def run(target_size, max_size, hflip):
        blob, scale, im_info = prep_on_device(im, target_size, max_size,
                                              device, hflip)
        b = box_utils.flip_boxes(boxes, im.shape[1]) if hflip else boxes
        probs = test_ops._sel_probs(
            test_ops._on_boxes(test_ops.mask_on_boxes_graph, params, blob,
                               im_info, b, scale, device),
            det_classes, len(det_classes))
        return probs[:, :, ::-1] if hflip else probs

    masks_ts = _head_passes(cfg.TEST.MASK_AUG, run)
    heur = cfg.TEST.MASK_AUG.HEUR
    if heur == "SOFT_AVG":
        return np.mean(masks_ts, axis=0)
    if heur == "SOFT_MAX":
        return np.amax(masks_ts, axis=0)
    if heur == "LOGIT_AVG":
        logits = [np.log(m / np.clip(1 - m, 1e-12, None) + 1e-12)
                  for m in masks_ts]
        return 1.0 / (1.0 + np.exp(-np.mean(logits, axis=0)))
    raise NotImplementedError("TEST.MASK_AUG.HEUR " + heur)


def im_detect_kps_aug(params, im, boxes, device):
    """Keypoint heatmaps (n, S, S, K) of the boxes (n, 4, image
    coordinates), combined over TEST.KPS_AUG's passes."""
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.utils import keypoints as kp_utils

    names, flip_map = kp_utils.get_keypoints()
    perm = list(range(len(names)))
    for left, right in flip_map.items():
        li, ri = names.index(left), names.index(right)
        perm[li], perm[ri] = ri, li

    def run(target_size, max_size, hflip):
        blob, scale, im_info = prep_on_device(im, target_size, max_size,
                                              device, hflip)
        b = box_utils.flip_boxes(boxes, im.shape[1]) if hflip else boxes
        hm = test_ops._on_boxes(test_ops.kps_on_boxes_graph, params, blob,
                                im_info, b, scale, device)
        return hm[:, :, ::-1, :][..., perm] if hflip else hm

    hms_ts = _head_passes(cfg.TEST.KPS_AUG, run)
    heur = cfg.TEST.KPS_AUG.HEUR
    if heur == "HM_AVG":
        return np.mean(hms_ts, axis=0)
    if heur == "HM_MAX":
        return np.amax(hms_ts, axis=0)
    raise NotImplementedError("TEST.KPS_AUG.HEUR " + heur)
