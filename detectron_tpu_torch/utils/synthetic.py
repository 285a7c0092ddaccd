"""Numpy twins of detectron_tpu.utils.synthetic: calibrate_detector_params
and synthetic_train_batch.

Random-init heads give a pathological work mix (a uniform 81-way softmax
sends every proposal over TEST.SCORE_THRESH; rpn_bbox_pred deltas rail at
the decode clip). The calibration moves the tree toward a trained
detector's output statistics, the same way and with the same random draws
as the JAX version, on a numpy params tree (models/init.init_model, or a
JAX tree after np.asarray on each leaf).
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.utils import blob as blob_utils


def calibrate_detector_params(params, rng=None):
    """cls_score bias: background +4.5 plus N(0, 0.5) fg noise;
    rpn_bbox_pred w and b scaled by 0.005. Updates and returns `params`."""
    if rng is None:
        rng = np.random.RandomState(0)
    b = np.asarray(params["box_outs"]["cls_score"]["b"]).copy()
    b[0] += 4.5
    b[1:] += rng.randn(b.size - 1).astype(np.float32) * 0.5
    params["box_outs"]["cls_score"]["b"] = b
    for k in ("w", "b"):
        params["rpn"]["rpn_bbox_pred"][k] = (
            np.asarray(params["rpn"]["rpn_bbox_pred"][k]) * 0.005)
    return params


def synthetic_train_batch(B, H, W, device, rng=None, im_scale=1.6):
    """A COCO-like synthetic training batch at a (H, W) canvas: 4 + (i % 5)
    gt boxes of 40-190 px per image, random classes, N(0, 20) images,
    random binary gt masks (with MASK_ON) and visible gt keypoints
    anywhere on the canvas (with KEYPOINTS_ON), from the same RandomState
    draws, in the same order, as the JAX version; tensors on `device`."""
    if rng is None:
        rng = np.random.RandomState(0)
    G = cfg.TPU.MAX_GT_BOXES
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_valid = np.zeros((B, G), bool)
    gt_classes = np.zeros((B, G), np.int32)
    for i in range(B):
        n = 4 + (i % 5)
        x1 = rng.uniform(0, W - 200, n)
        y1 = rng.uniform(0, H - 200, n)
        gt_boxes[i, :n] = np.stack(
            [x1, y1, x1 + rng.uniform(40, 190, n),
             y1 + rng.uniform(40, 190, n)], axis=1)
        gt_valid[i, :n] = True
        gt_classes[i, :n] = rng.randint(1, cfg.MODEL.NUM_CLASSES, n)
    images = rng.randn(B, H, W, 3).astype(np.float32) * 20.0
    if cfg.TPU.S2D_INPUT:
        images = blob_utils.space_to_depth(images)
    batch = {
        "images": images,
        "im_info": np.array([[H - 32.0, W - 11.0, im_scale]] * B,
                            np.float32),
        "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_valid": gt_valid,
        "crowd_boxes": np.zeros((B, 2, 4), np.float32),
        "crowd_valid": np.zeros((B, 2), bool),
    }
    if cfg.MODEL.MASK_ON:
        Mg = cfg.TPU.GT_MASK_SIZE
        batch["gt_masks"] = (rng.rand(B, G, Mg, Mg) > 0.5).astype(np.float32)
    if cfg.MODEL.KEYPOINTS_ON:
        kps = np.zeros((B, G, cfg.KRCNN.NUM_KEYPOINTS, 3), np.float32)
        kps[..., 0] = rng.uniform(0, W, kps.shape[:3])
        kps[..., 1] = rng.uniform(0, H, kps.shape[:3])
        kps[..., 2] = 2.0
        batch["gt_keypoints"] = kps
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
