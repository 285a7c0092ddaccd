"""COCO-style result writing + evaluation of boxes, masks and keypoints
(the port's copy of detectron_tpu/data/json_dataset_evaluator.py;
reference: lib/datasets/json_dataset_evaluator.py :: evaluate_boxes,
evaluate_masks, evaluate_keypoints) on the port's COCO API and COCOeval
(data/coco_json.py, data/coco_eval.py). The RPN-only proposal recall waits
for RPN-only models, which the port does not run.
"""

import json
import logging
import os

import numpy as np

from detectron_tpu_torch.data.coco_eval import COCOeval
from detectron_tpu_torch.utils import boxes as box_utils

logger = logging.getLogger(__name__)


def _results_one_category_boxes(dataset, boxes, cat_id):
    results = []
    image_ids = dataset.COCO.getImgIds()
    image_ids.sort()
    assert len(boxes) == len(image_ids)
    for i, image_id in enumerate(image_ids):
        dets = boxes[i]
        if isinstance(dets, list) and len(dets) == 0:
            continue
        dets = dets.astype(np.float64)
        scores = dets[:, -1]
        xywh_dets = box_utils.xyxy_to_xywh(dets[:, 0:4])
        xs = xywh_dets[:, 0]
        ys = xywh_dets[:, 1]
        ws = xywh_dets[:, 2]
        hs = xywh_dets[:, 3]
        results.extend([
            {"image_id": image_id, "category_id": cat_id,
             "bbox": [float(xs[k]), float(ys[k]), float(ws[k]),
                      float(hs[k])],
             "score": float(scores[k])}
            for k in range(dets.shape[0])
        ])
    return results


def write_coco_bbox_results_file(dataset, all_boxes, res_file):
    results = []
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__" or cls_ind >= len(all_boxes):
            continue
        cat_id = dataset.category_to_id_map[cls]
        results.extend(
            _results_one_category_boxes(dataset, all_boxes[cls_ind], cat_id))
    logger.info("Writing bbox results json to: %s",
                os.path.abspath(res_file))
    with open(res_file, "w") as f:
        json.dump(results, f)
    return res_file


def evaluate_boxes(dataset, all_boxes, output_dir):
    res_file = os.path.join(output_dir, "bbox_" + dataset.name +
                            "_results.json")
    os.makedirs(output_dir, exist_ok=True)
    write_coco_bbox_results_file(dataset, all_boxes, res_file)
    coco_dt = dataset.COCO.loadRes(res_file)
    coco_eval = COCOeval(dataset.COCO, coco_dt, "bbox")
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    _log_detection_eval_metrics(dataset, coco_eval)
    return coco_eval


def _results_one_category_segms(dataset, boxes, segms, cat_id):
    results = []
    image_ids = dataset.COCO.getImgIds()
    image_ids.sort()
    assert len(boxes) == len(image_ids)
    for i, image_id in enumerate(image_ids):
        dets = boxes[i]
        rles = segms[i]
        if isinstance(dets, list) and len(dets) == 0:
            continue
        dets = dets.astype(np.float64)
        scores = dets[:, -1]
        results.extend([
            {"image_id": image_id, "category_id": cat_id,
             "segmentation": rles[k], "score": float(scores[k])}
            for k in range(dets.shape[0])
        ])
    return results


def evaluate_masks(dataset, all_boxes, all_segms, output_dir):
    res_file = os.path.join(output_dir, "segm_" + dataset.name +
                            "_results.json")
    os.makedirs(output_dir, exist_ok=True)
    results = []
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__" or cls_ind >= len(all_boxes):
            continue
        cat_id = dataset.category_to_id_map[cls]
        results.extend(_results_one_category_segms(
            dataset, all_boxes[cls_ind], all_segms[cls_ind], cat_id))
    with open(res_file, "w") as f:
        json.dump(results, f)
    coco_dt = dataset.COCO.loadRes(res_file)
    coco_eval = COCOeval(dataset.COCO, coco_dt, "segm")
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    _log_detection_eval_metrics(dataset, coco_eval)
    return coco_eval


def _log_detection_eval_metrics(dataset, coco_eval):
    IoU_lo_thresh = 0.5
    IoU_hi_thresh = 0.95
    ap = coco_eval.stats[0]
    logger.info("~~~~ Mean and per-category AP @ IoU=[{:.2f},{:.2f}] "
                "~~~~".format(IoU_lo_thresh, IoU_hi_thresh))
    logger.info("{:.1f}".format(100 * ap))
    precision = coco_eval.eval["precision"]
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__":
            continue
        p = precision[:, :, cls_ind - 1, 0, 2 if precision.shape[-1] > 2
                      else -1]
        ap_c = np.mean(p[p > -1]) if len(p[p > -1]) else -1
        logger.info("{}: {:.1f}".format(cls, 100 * ap_c))


def _results_one_category_kps(dataset, boxes, kps, cat_id):
    """COCO keypoint results of one category: each detection's keypoints
    as [x, y, 1] triples, scored by its box score
    (KRCNN.KEYPOINT_CONFIDENCE 'bbox')."""
    results = []
    image_ids = dataset.COCO.getImgIds()
    image_ids.sort()
    assert len(boxes) == len(image_ids)
    for i, image_id in enumerate(image_ids):
        if len(boxes[i]) == 0:
            continue
        kps_dets = kps[i]
        scores = boxes[i][:, -1].astype(np.float64)
        for k in range(len(kps_dets)):
            xy = []
            for kp_i in range(kps_dets[k].shape[1]):
                xy += [float(kps_dets[k][0, kp_i]),
                       float(kps_dets[k][1, kp_i]),
                       1.0]
            results.append({
                "image_id": image_id, "category_id": cat_id,
                "keypoints": xy, "score": float(scores[k])})
    return results


def evaluate_keypoints(dataset, all_boxes, all_keyps, output_dir):
    """Write the person class's keypoint results json and run COCOeval's
    OKS protocol on it. Returns the COCOeval."""
    res_file = os.path.join(output_dir, "keypoints_" + dataset.name +
                            "_results.json")
    os.makedirs(output_dir, exist_ok=True)
    person_idx = dataset.classes.index("person")
    cat_id = dataset.category_to_id_map["person"]
    results = _results_one_category_kps(
        dataset, all_boxes[person_idx], all_keyps[person_idx], cat_id)
    logger.info("Writing keypoint results json to: %s",
                os.path.abspath(res_file))
    with open(res_file, "w") as f:
        json.dump(results, f)
    coco_dt = dataset.COCO.loadRes(res_file)
    coco_eval = COCOeval(dataset.COCO, coco_dt, "keypoints")
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    return coco_eval
