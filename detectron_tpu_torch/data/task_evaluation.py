"""Task-level evaluation dispatch (the port's copy of
detectron_tpu/data/task_evaluation.py; reference:
lib/datasets/task_evaluation.py): evaluate_all -> evaluate_boxes /
evaluate_masks / evaluate_keypoints, the result-dict schema,
check_expected_results (the reference's golden-number hook) and
copy-paste-friendly logging.

The JAX package's routing: COCO datasets (and any with
TEST.FORCE_JSON_DATASET_EVAL) and Cityscapes go to the COCO-protocol json
evaluator for boxes and masks; VOC boxes go to voc_dataset_evaluator
(the devkit-XML protocol when the devkit is on disk, the converted json
otherwise), reported as box AP and AP50. Detectron sends Cityscapes masks
to its Cityscapes evaluator; the port keeps the JAX routing, and
cityscapes_json_dataset_evaluator.evaluate_masks_official gives the
official instance-level protocol by a direct call.
"""

import logging
from collections import OrderedDict

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.data import json_dataset_evaluator
from detectron_tpu_torch.data import voc_dataset_evaluator

logger = logging.getLogger(__name__)


def evaluate_all(dataset, all_boxes, all_segms, all_keyps, output_dir):
    results = evaluate_boxes(dataset, all_boxes, output_dir)
    logger.info("Evaluating bounding boxes is done!")
    if cfg.MODEL.MASK_ON:
        res = evaluate_masks(dataset, all_boxes, all_segms, output_dir)
        results[dataset.name].update(res[dataset.name])
        logger.info("Evaluating segmentations is done!")
    if cfg.MODEL.KEYPOINTS_ON:
        res = evaluate_keypoints(dataset, all_boxes, all_keyps, output_dir)
        results[dataset.name].update(res[dataset.name])
        logger.info("Evaluating keypoints is done!")
    log_copy_paste_friendly_results(results)
    return results


def _use_json_dataset_evaluator(dataset):
    return "coco" in dataset.name or cfg.TEST.FORCE_JSON_DATASET_EVAL


def evaluate_boxes(dataset, all_boxes, output_dir):
    name = dataset.name
    if _use_json_dataset_evaluator(dataset) or "cityscapes" in name:
        coco_eval = json_dataset_evaluator.evaluate_boxes(
            dataset, all_boxes, output_dir)
        box_results = _coco_eval_to_box_results(coco_eval)
    elif "voc" in name:
        voc_eval = voc_dataset_evaluator.evaluate_boxes(
            dataset, all_boxes, output_dir)
        box_results = _voc_eval_to_box_results(voc_eval)
    else:
        raise NotImplementedError("No evaluator for dataset: " + name)
    return OrderedDict([(name, box_results)])


def evaluate_masks(dataset, all_boxes, all_segms, output_dir):
    name = dataset.name
    if _use_json_dataset_evaluator(dataset) or "cityscapes" in name:
        coco_eval = json_dataset_evaluator.evaluate_masks(
            dataset, all_boxes, all_segms, output_dir)
        results = _coco_eval_to_mask_results(coco_eval)
    else:
        raise NotImplementedError("No mask evaluator for dataset: " + name)
    return OrderedDict([(name, results)])


def evaluate_keypoints(dataset, all_boxes, all_keyps, output_dir):
    if "coco" not in dataset.name:
        raise ValueError("the keypoint evaluation is COCO's only, not "
                         + dataset.name)
    coco_eval = json_dataset_evaluator.evaluate_keypoints(
        dataset, all_boxes, all_keyps, output_dir)
    return OrderedDict([(dataset.name,
                         _coco_eval_to_keypoint_results(coco_eval))])


# ---------------------------------------------------------------------------
# Result-dict schema (identical key names to the reference)
# ---------------------------------------------------------------------------

def _coco_eval_to_box_results(coco_eval):
    res = OrderedDict(
        [("box",
          OrderedDict([("AP", -1), ("AP50", -1), ("AP75", -1), ("APs", -1),
                       ("APm", -1), ("APl", -1)]))])
    if coco_eval is not None:
        s = coco_eval.stats
        res["box"] = OrderedDict(
            zip(["AP", "AP50", "AP75", "APs", "APm", "APl"],
                [float(v) for v in s[:6]]))
    return res


def _coco_eval_to_mask_results(coco_eval):
    res = OrderedDict(
        [("mask",
          OrderedDict([("AP", -1), ("AP50", -1), ("AP75", -1), ("APs", -1),
                       ("APm", -1), ("APl", -1)]))])
    if coco_eval is not None:
        s = coco_eval.stats
        res["mask"] = OrderedDict(
            zip(["AP", "AP50", "AP75", "APs", "APm", "APl"],
                [float(v) for v in s[:6]]))
    return res


def _coco_eval_to_keypoint_results(coco_eval):
    res = OrderedDict(
        [("keypoint",
          OrderedDict([("AP", -1), ("AP50", -1), ("AP75", -1), ("APm", -1),
                       ("APl", -1)]))])
    if coco_eval is not None:
        s = coco_eval.stats
        res["keypoint"] = OrderedDict(
            zip(["AP", "AP50", "AP75", "APm", "APl"],
                [float(v) for v in s[:5]]))
    return res


def _voc_eval_to_box_results(voc_eval):
    return OrderedDict([("box", OrderedDict([("AP", voc_eval["map"]),
                                             ("AP50", voc_eval["map"])]))])


# ---------------------------------------------------------------------------

def log_copy_paste_friendly_results(results):
    for dataset in results.keys():
        logger.info("copypaste: Dataset: %s", dataset)
        for task, metrics in results[dataset].items():
            logger.info("copypaste: Task: %s", task)
            logger.info("copypaste: %s", ",".join(metrics.keys()))
            logger.info("copypaste: %s", ",".join(
                "{:.4f}".format(v) for v in metrics.values()))


def check_expected_results(results, atol=0.005, rtol=0.1):
    """Assert results match cfg.EXPECTED_RESULTS entries
    [dataset, task, metric, expected_val] (the reference's golden-number
    mechanism, lib/datasets/task_evaluation.py :: check_expected_results)."""
    expected = cfg.EXPECTED_RESULTS
    if not expected:
        return
    for dataset, task, metric, expected_val in expected:
        assert dataset in results, "Unknown dataset: " + dataset
        assert task in results[dataset], "Unknown task: " + task
        assert metric in results[dataset][task], "Unknown metric: " + metric
        actual_val = results[dataset][task][metric]
        err = abs(actual_val - expected_val)
        tol = atol + rtol * abs(expected_val)
        # The JAX package's message has one placeholder too few and
        # formats the metric's name with {:.3f}, which raises ValueError.
        msg = (
            "{} > {} > {} sanity check (actual vs. expected): {:.3f} vs. "
            "{:.3f}, err={:.3f}, tol={:.3f}".format(
                dataset, task, metric, actual_val, expected_val, err, tol))
        if err > tol:
            raise AssertionError("FAIL: " + msg)
        logger.info("PASS: %s", msg)
