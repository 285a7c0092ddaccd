"""roidb assembly for training (the port's copy of
detectron_tpu/data/roidb.py :20-156; reference: lib/datasets/roidb.py):
combined_roidb_for_training (several datasets concatenated),
extend_with_flipped_entries, filter_for_training, rank_for_training
(aspect-ratio grouping, ASPECT_CROPPING) and compute_and_log_stats.

Ground-truth keypoints wait for Keypoint R-CNN (ROADMAP Queue A, A6): a
dataset whose person category names keypoints raises.
"""

import logging

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.utils import segms as segm_utils

logger = logging.getLogger(__name__)

_NO_KEYPOINTS = ("not ported yet (ROADMAP Queue A, A6): ground-truth "
                 "keypoints of dataset ")


def combined_roidb_for_training(dataset_names, proposal_files=()):
    """Load and concatenate one or more datasets' training roidbs, with
    flipping/filtering/ranking. Returns (roidb, ratio_list, ratio_index)."""
    if isinstance(dataset_names, str):
        dataset_names = (dataset_names,)
    if isinstance(proposal_files, str):
        proposal_files = (proposal_files,)
    if len(proposal_files) == 0:
        proposal_files = (None,) * len(dataset_names)
    assert len(dataset_names) == len(proposal_files)

    roidbs = []
    for name, pf in zip(dataset_names, proposal_files):
        ds = JsonDataset(name)
        if ds.keypoints is not None:
            raise NotImplementedError(_NO_KEYPOINTS + name)
        roidb = ds.get_roidb(
            gt=True,
            proposal_file=pf,
            crowd_filter_thresh=cfg.TRAIN.CROWD_FILTER_THRESH,
        )
        if cfg.TRAIN.USE_FLIPPED:
            extend_with_flipped_entries(roidb, ds)
        roidbs.append(roidb)

    roidb = roidbs[0]
    for r in roidbs[1:]:
        roidb.extend(r)
    roidb = filter_for_training(roidb)

    ratio_list, ratio_index = rank_for_training(roidb)
    compute_and_log_stats(roidb)
    return roidb, ratio_list, ratio_index


def extend_with_flipped_entries(roidb, dataset):
    """Append a horizontally flipped copy of every entry (boxes with
    Detectron's +1 rule, segms flipped; images flipped at load time via
    entry['flipped'])."""
    if dataset.keypoints is not None:
        raise NotImplementedError(_NO_KEYPOINTS + dataset.name)
    flipped_roidb = []
    for entry in roidb:
        width = entry["width"]
        boxes = entry["boxes"].copy()
        oldx1 = boxes[:, 0].copy()
        oldx2 = boxes[:, 2].copy()
        boxes[:, 0] = width - oldx2 - 1
        boxes[:, 2] = width - oldx1 - 1
        assert (boxes[:, 2] >= boxes[:, 0]).all()
        flipped_entry = {}
        dont_copy = ("boxes", "segms", "gt_keypoints", "flipped")
        for k, v in entry.items():
            if k not in dont_copy:
                flipped_entry[k] = v
        flipped_entry["boxes"] = boxes
        flipped_entry["segms"] = segm_utils.flip_segms(
            entry["segms"], entry["height"], entry["width"])
        flipped_entry["flipped"] = True
        flipped_roidb.append(flipped_entry)
    roidb.extend(flipped_roidb)


def filter_for_training(roidb):
    """Remove entries without usable RoIs (>=1 fg or bg-assignable box;
    with the RPN on, any gt box)."""

    def is_valid(entry):
        overlaps = entry["gt_overlaps"].max(axis=1) \
            if entry["gt_overlaps"].size else np.zeros((0,))
        fg_inds = np.where(overlaps >= cfg.TRAIN.FG_THRESH)[0]
        bg_inds = np.where(
            (overlaps < cfg.TRAIN.BG_THRESH_HI)
            & (overlaps >= cfg.TRAIN.BG_THRESH_LO))[0]
        valid = len(fg_inds) > 0 or len(bg_inds) > 0
        # For RPN-based training, having any gt box is the usable criterion.
        if cfg.RPN.RPN_ON:
            valid = valid or entry["boxes"].shape[0] > 0
        if cfg.MODEL.KEYPOINTS_ON:
            valid = valid and entry["has_visible_keypoints"]
        return valid

    num = len(roidb)
    filtered_roidb = [entry for entry in roidb if is_valid(entry)]
    num_after = len(filtered_roidb)
    logger.info("Filtered %d roidb entries: %d -> %d",
                num - num_after, num, num_after)
    return filtered_roidb


def rank_for_training(roidb):
    """Rank entries by aspect ratio for grouped batching (the reference's
    ratio_list/ratio_index contract; with ASPECT_CROPPING the extremes are
    clamped)."""
    need_crop_cnt = 0
    ratio_list = []
    for entry in roidb:
        width = entry["width"]
        height = entry["height"]
        ratio = width / float(height)
        if cfg.TRAIN.ASPECT_CROPPING:
            if ratio > cfg.TRAIN.ASPECT_HI:
                entry["need_crop"] = True
                ratio = cfg.TRAIN.ASPECT_HI
                need_crop_cnt += 1
            elif ratio < cfg.TRAIN.ASPECT_LO:
                entry["need_crop"] = True
                ratio = cfg.TRAIN.ASPECT_LO
                need_crop_cnt += 1
            else:
                entry["need_crop"] = False
        else:
            entry["need_crop"] = False
        ratio_list.append(ratio)
    if cfg.TRAIN.ASPECT_CROPPING:
        logger.info("Clamped %d entries' aspect ratios to [%.2f, %.2f]",
                    need_crop_cnt, cfg.TRAIN.ASPECT_LO, cfg.TRAIN.ASPECT_HI)
    ratio_list = np.array(ratio_list)
    ratio_index = np.argsort(ratio_list)
    return ratio_list[ratio_index], ratio_index


def compute_and_log_stats(roidb):
    classes = roidb[0]["dataset"].classes if roidb else []
    gt_hist = np.zeros(len(classes), np.int64)
    for entry in roidb:
        gt_inds = np.where(
            (entry["gt_classes"] > 0) & (entry["is_crowd"] == 0))[0]
        gt_hist += np.histogram(
            entry["gt_classes"][gt_inds], bins=len(classes),
            range=(0, len(classes)))[0]
    logger.info("Ground-truth class histogram: total %d", int(gt_hist.sum()))
