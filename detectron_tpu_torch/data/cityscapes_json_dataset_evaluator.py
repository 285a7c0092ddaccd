"""Cityscapes instance-segmentation evaluation (the port's copy of
detectron_tpu/data/cityscapes_json_dataset_evaluator.py; reference:
lib/datasets/cityscapes_json_dataset_evaluator.py and the
lib/datasets/cityscapes/coco_to_cityscapes_id.py remap).

The reference shells out to cityscapesscripts'
evalInstanceLevelSemanticLabeling on dumped .txt masks; cityscapesscripts
is not a dependency, so box and mask AP run through the COCO protocol over
the cityscapes-converted json (the standard instancesonly_filtered_gtFine
jsons are COCO-format), and evaluate_masks_official re-implements the
official instance-level protocol. The id remap and the mask dump are kept.
"""

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

# model trained on COCO classes -> cityscapes instance classes
# (reference: lib/datasets/cityscapes/coco_to_cityscapes_id.py)
def cityscapes_to_coco(cityscapes_id):
    lookup = {
        "person": 1, "rider": -1, "car": 3, "truck": 8, "bus": 6,
        "train": 7, "motorcycle": 4, "bicycle": 2,
    }
    return lookup


def coco_to_cityscapes_id(coco_cat_name):
    lookup = {
        "person": 24, "rider": 25, "car": 26, "truck": 27, "bus": 28,
        "train": 31, "motorcycle": 32, "bicycle": 33,
    }
    return lookup.get(coco_cat_name, -1)


def evaluate_boxes(dataset, all_boxes, output_dir):
    from detectron_tpu_torch.data import json_dataset_evaluator

    return json_dataset_evaluator.evaluate_boxes(
        dataset, all_boxes, output_dir)


def evaluate_masks(dataset, all_boxes, all_segms, output_dir):
    """Cityscapes instance-seg evaluation: dumps cityscapesscripts-format
    .txt/.png results (with cv2) and runs the official instance-level
    protocol (evalInstanceLevelSemanticLabeling semantics, re-implemented
    below). Returns evaluate_masks_official's dict with the COCO-protocol
    COCOeval under "coco_eval" (the JAX package's copy calls .update on
    the COCOeval and raises AttributeError)."""
    from detectron_tpu_torch.data import json_dataset_evaluator

    _dump_cityscapes_txt(dataset, all_boxes, all_segms, output_dir)
    res = {"coco_eval": json_dataset_evaluator.evaluate_masks(
        dataset, all_boxes, all_segms, output_dir)}
    res.update(evaluate_masks_official(dataset, all_boxes, all_segms))
    return res


# ---------------------------------------------------------------------------
# Official instance-level protocol
# (cityscapesscripts/evaluation/evalInstanceLevelSemanticLabeling.py
# semantics: AP averaged over IoU thresholds 0.5:0.05:0.95, greedy matching
# by score, gt instances below minRegionSize ignored, crowd/group regions
# absorb otherwise-FP predictions, all-point AP integration.)
# ---------------------------------------------------------------------------

MIN_REGION_SIZE = 100  # official minRegionSizes = [100]
OVERLAPS = np.arange(0.5, 1.0, 0.05)


def _gt_instances_for_image(dataset, img_id, cat_id, h, w):
    """Returns (gt_rles, ignore_rles): real instances vs ignore regions
    (crowd/group annotations + instances under MIN_REGION_SIZE)."""
    from detectron_tpu_torch.data import rle as mask_util

    gt_rles, ignore_rles = [], []
    for a in dataset.COCO.img_to_anns.get(img_id, []):
        if a["category_id"] != cat_id:
            continue
        segm = a.get("segmentation")
        if segm is None:
            continue
        if isinstance(segm, list):
            r = mask_util.merge(mask_util.frPyObjects(segm, h, w))
        else:
            r = segm if isinstance(segm.get("counts"), (str, bytes)) else \
                mask_util.frPyObjects(segm, h, w)
        if a.get("iscrowd", 0):
            ignore_rles.append(r)
        elif mask_util.area(r) < MIN_REGION_SIZE:
            ignore_rles.append(r)
        else:
            gt_rles.append(r)
    return gt_rles, ignore_rles


def evaluate_masks_official(dataset, all_boxes, all_segms):
    """Returns {'ap_official': mAP, 'ap50_official': mAP50,
    'aps_official': {class: ap}}."""
    from detectron_tpu_torch.data import rle as mask_util

    image_ids = sorted(dataset.COCO.getImgIds())
    aps = {}
    ap50s = {}
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__":
            continue
        cat_id = dataset.category_to_id_map[cls]
        # Per image: iou matrices + pred scores + ignore-overlap fractions
        per_image = []
        n_gt = 0
        for i, img_id in enumerate(image_ids):
            info = dataset.COCO.imgs[img_id]
            h, w = info["height"], info["width"]
            gt_rles, ign_rles = _gt_instances_for_image(
                dataset, img_id, cat_id, h, w)
            n_gt += len(gt_rles)
            segms = all_segms[cls_ind][i] if all_segms else []
            boxes = all_boxes[cls_ind][i]
            preds = [(float(boxes[k][-1]), segms[k])
                     for k in range(min(len(boxes), len(segms)))]
            if not preds:
                per_image.append((np.zeros((0, len(gt_rles))),
                                  np.zeros(0), np.zeros(0)))
                continue
            scores = np.array([p[0] for p in preds])
            dt_rles = [p[1] for p in preds]
            ious = mask_util.iou(dt_rles, gt_rles,
                                 [0] * len(gt_rles)) if gt_rles else \
                np.zeros((len(dt_rles), 0))
            # Fraction of each pred covered by ignore regions (crowd
            # semantics: intersection / pred area).
            if ign_rles:
                ign = mask_util.iou(dt_rles, ign_rles, [1] * len(ign_rles))
                ign_frac = np.asarray(ign).max(axis=1)
            else:
                ign_frac = np.zeros(len(dt_rles))
            per_image.append((np.asarray(ious), scores, ign_frac))

        ap_per_t = []
        for t in OVERLAPS:
            y_score = []
            y_true = []
            hard_fns = 0
            for ious, scores, ign_frac in per_image:
                order = np.argsort(-scores)
                matched_gt = np.zeros(ious.shape[1], bool)
                for k in order:
                    cand = np.where(~matched_gt & (ious[k] > t))[0] \
                        if ious.shape[1] else np.array([], int)
                    if len(cand):
                        j = cand[np.argmax(ious[k][cand])]
                        matched_gt[j] = True
                        y_score.append(scores[k])
                        y_true.append(1)
                    else:
                        # FP unless mostly covered by an ignore region
                        if ign_frac[k] <= t:
                            y_score.append(scores[k])
                            y_true.append(0)
                hard_fns += int((~matched_gt).sum())
            if n_gt == 0:
                ap_per_t.append(float("nan"))
                continue
            if not y_true:
                ap_per_t.append(0.0)
                continue
            order = np.argsort(-np.asarray(y_score))
            y = np.asarray(y_true)[order]
            tp = np.cumsum(y)
            fp = np.cumsum(1 - y)
            rec = tp / float(n_gt)
            prec = tp / np.maximum(tp + fp, 1e-12)
            # all-point AP
            mrec = np.concatenate(([0.0], rec, [1.0]))
            mpre = np.concatenate(([0.0], prec, [0.0]))
            for k in range(mpre.size - 1, 0, -1):
                mpre[k - 1] = max(mpre[k - 1], mpre[k])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap_per_t.append(
                float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])))
        ap_arr = np.asarray(ap_per_t, np.float64)
        if np.all(np.isnan(ap_arr)):
            continue
        aps[cls] = float(np.nanmean(ap_arr))
        ap50s[cls] = float(ap_arr[0])
        logger.info("Cityscapes official AP for %s = %.4f (AP50 %.4f)",
                    cls, aps[cls], ap50s[cls])
    m_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    m_ap50 = float(np.mean(list(ap50s.values()))) if ap50s else 0.0
    logger.info("Cityscapes official mAP = %.4f, mAP50 = %.4f", m_ap, m_ap50)
    return {"ap_official": m_ap, "ap50_official": m_ap50,
            "aps_official": aps}


def _dump_cityscapes_txt(dataset, all_boxes, all_segms, output_dir):
    """Write per-image result .txt + instance mask .pngs in the layout
    cityscapesscripts' evalInstanceLevelSemanticLabeling consumes."""
    import cv2

    from detectron_tpu_torch.data import rle as mask_util

    res_dir = os.path.join(output_dir, "cityscapes_results")
    os.makedirs(res_dir, exist_ok=True)
    image_ids = sorted(dataset.COCO.getImgIds())
    for i, img_id in enumerate(image_ids):
        info = dataset.COCO.imgs[img_id]
        base = os.path.splitext(os.path.basename(info["file_name"]))[0]
        lines = []
        inst = 0
        for cls_ind, cls in enumerate(dataset.classes):
            if cls == "__background__":
                continue
            cs_id = coco_to_cityscapes_id(cls)
            boxes = all_boxes[cls_ind][i]
            segms = all_segms[cls_ind][i] if all_segms else []
            for k in range(len(boxes)):
                if k >= len(segms):
                    break
                score = float(boxes[k][-1])
                mask = mask_util.decode(segms[k])
                png = "{}_{}.png".format(base, inst)
                cv2.imwrite(os.path.join(res_dir, png), mask * 255)
                lines.append("{} {} {:.6f}".format(
                    png, cs_id if cs_id > 0 else cls_ind, score))
                inst += 1
        with open(os.path.join(res_dir, base + ".txt"), "w") as f:
            f.write("\n".join(lines))
    logger.info("Cityscapes-format results dumped to %s", res_dir)
