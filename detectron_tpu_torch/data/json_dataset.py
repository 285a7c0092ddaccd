"""COCO-style JSON dataset -> roidb (the port's copy of the evaluation
half of detectron_tpu/data/json_dataset.py; reference:
lib/datasets/json_dataset.py :: JsonDataset).

Roidb entries carry boxes (xyxy), segms, gt_classes, seg_areas,
gt_overlaps (dense (N, C)), is_crowd and box_to_gt_ind_map, with the
contiguous category remapping and the filtering of degenerate gt boxes;
precomputed proposals are read from a file (TEST.PRECOMPUTED_PROPOSALS)
and appended as non-gt rows. Ground-truth keypoints wait for Keypoint
R-CNN (ROADMAP Queue A, A6), and the training-time proposal merge and
crowd filter for Fast R-CNN training (A5).
"""

import os
import pickle

import numpy as np

from detectron_tpu_torch.data import dataset_catalog
from detectron_tpu_torch.data.coco_json import COCO
from detectron_tpu_torch.utils import boxes as box_utils


class JsonDataset:
    def __init__(self, name):
        assert name in dataset_catalog.DATASETS, \
            "Unknown dataset name: {}".format(name)
        ann_fn = dataset_catalog.get_ann_fn(name)
        im_dir = dataset_catalog.get_im_dir(name)
        assert os.path.exists(ann_fn), "Ann file not found: " + ann_fn
        assert os.path.exists(im_dir), "Image dir not found: " + im_dir
        self.name = name
        self.image_directory = im_dir
        self.image_prefix = dataset_catalog.get_im_prefix(name)
        self.COCO = COCO(ann_fn)
        category_ids = self.COCO.getCatIds()
        categories = [c["name"] for c in self.COCO.loadCats(category_ids)]
        self.category_to_id_map = dict(zip(categories, category_ids))
        self.classes = ["__background__"] + categories
        self.num_classes = len(self.classes)
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(category_ids)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }

    def get_roidb(self, gt=False, proposal_file=None, min_proposal_size=2,
                  proposal_limit=-1):
        image_ids = self.COCO.getImgIds()
        roidb = list(self.COCO.loadImgs(image_ids))
        for entry in roidb:
            self._prep_roidb_entry(entry)
        if gt:
            for entry in roidb:
                self._add_gt_annotations(entry)
        if proposal_file is not None:
            self._add_proposals_from_file(
                roidb, proposal_file, min_proposal_size, proposal_limit)
        return roidb

    def _prep_roidb_entry(self, entry):
        entry["dataset"] = self
        entry["image"] = os.path.join(
            self.image_directory, self.image_prefix + entry["file_name"])
        entry["flipped"] = False
        entry["has_visible_keypoints"] = False
        entry["boxes"] = np.empty((0, 4), np.float32)
        entry["segms"] = []
        entry["gt_classes"] = np.empty((0,), np.int32)
        entry["seg_areas"] = np.empty((0,), np.float32)
        entry["gt_overlaps"] = np.empty((0, self.num_classes), np.float32)
        entry["is_crowd"] = np.empty((0,), bool)
        entry["box_to_gt_ind_map"] = np.empty((0,), np.int32)
        for k in ["date_captured", "url", "license"]:
            entry.pop(k, None)

    def _add_gt_annotations(self, entry):
        ann_ids = self.COCO.getAnnIds(imgIds=entry["id"])
        objs = self.COCO.loadAnns(ann_ids)
        width = entry["width"]
        height = entry["height"]
        valid_objs = []
        valid_segms = []
        for obj in objs:
            if "ignore" in obj and obj["ignore"] == 1:
                continue
            x1, y1, x2, y2 = box_utils.xywh_to_xyxy(obj["bbox"])
            x1, y1, x2, y2 = box_utils.clip_xyxy_to_image(
                x1, y1, x2, y2, height, width)
            if obj.get("area", 0) > 0 and x2 > x1 and y2 > y1:
                obj["clean_bbox"] = [x1, y1, x2, y2]
                valid_objs.append(obj)
                valid_segms.append(obj.get("segmentation", []))
        num_valid = len(valid_objs)

        boxes = np.zeros((num_valid, 4), np.float32)
        gt_classes = np.zeros((num_valid,), np.int32)
        seg_areas = np.zeros((num_valid,), np.float32)
        gt_overlaps = np.zeros((num_valid, self.num_classes), np.float32)
        is_crowd = np.zeros((num_valid,), bool)
        box_to_gt_ind_map = np.zeros((num_valid,), np.int32)
        for ix, obj in enumerate(valid_objs):
            cls = self.json_category_id_to_contiguous_id[obj["category_id"]]
            boxes[ix, :] = obj["clean_bbox"]
            gt_classes[ix] = cls
            seg_areas[ix] = obj.get("area", 0)
            is_crowd[ix] = obj.get("iscrowd", 0)
            box_to_gt_ind_map[ix] = ix
            if obj.get("iscrowd", 0):
                gt_overlaps[ix, :] = -1.0
            else:
                gt_overlaps[ix, cls] = 1.0
        entry["boxes"] = np.append(entry["boxes"], boxes, axis=0)
        entry["segms"].extend(valid_segms)
        entry["gt_classes"] = np.append(entry["gt_classes"], gt_classes)
        entry["seg_areas"] = np.append(entry["seg_areas"], seg_areas)
        entry["gt_overlaps"] = np.append(entry["gt_overlaps"], gt_overlaps,
                                         axis=0)
        entry["is_crowd"] = np.append(entry["is_crowd"], is_crowd)
        entry["box_to_gt_ind_map"] = np.append(
            entry["box_to_gt_ind_map"], box_to_gt_ind_map)

    def _add_proposals_from_file(self, roidb, proposal_file,
                                 min_proposal_size, top_k):
        with open(proposal_file, "rb") as f:
            proposals = pickle.load(f, encoding="latin1")
        id_field = "indexes" if "indexes" in proposals else "ids"
        _sort_proposals(proposals, id_field)
        box_list = []
        for i, entry in enumerate(roidb):
            boxes = proposals["boxes"][i]
            assert entry["id"] == proposals[id_field][i]
            boxes = box_utils.clip_boxes_to_image(
                boxes, entry["height"], entry["width"])
            keep = box_utils.unique_boxes(boxes)
            boxes = boxes[keep, :]
            keep = box_utils.filter_small_boxes(boxes, min_proposal_size)
            boxes = boxes[keep, :]
            if top_k > 0:
                boxes = boxes[:top_k, :]
            box_list.append(boxes)
        _merge_proposal_boxes_into_roidb(roidb, box_list)


def _sort_proposals(proposals, id_field):
    order = np.argsort(proposals[id_field])
    fields_to_sort = ["boxes", id_field, "scores"]
    for k in fields_to_sort:
        if k in proposals:
            proposals[k] = [proposals[k][i] for i in order]


def _merge_proposal_boxes_into_roidb(roidb, box_list):
    assert len(box_list) == len(roidb)
    for i, entry in enumerate(roidb):
        boxes = box_list[i]
        num_boxes = boxes.shape[0]
        gt_overlaps = np.zeros((num_boxes, entry["gt_overlaps"].shape[1]),
                               np.float32)
        box_to_gt_ind_map = -np.ones((num_boxes,), np.int32)
        gt_inds = np.where(entry["gt_classes"] > 0)[0]
        if len(gt_inds) > 0 and num_boxes > 0:
            gt_boxes = entry["boxes"][gt_inds, :]
            gt_classes = entry["gt_classes"][gt_inds]
            proposal_to_gt_overlaps = box_utils.bbox_overlaps(boxes, gt_boxes)
            argmaxes = proposal_to_gt_overlaps.argmax(axis=1)
            maxes = proposal_to_gt_overlaps.max(axis=1)
            I = np.where(maxes > 0)[0]
            gt_overlaps[I, gt_classes[argmaxes[I]]] = maxes[I]
            box_to_gt_ind_map[I] = gt_inds[argmaxes[I]]
        entry["boxes"] = np.append(
            entry["boxes"], boxes.astype(np.float32), axis=0)
        entry["gt_classes"] = np.append(
            entry["gt_classes"], np.zeros(num_boxes, np.int32))
        entry["seg_areas"] = np.append(
            entry["seg_areas"], np.zeros(num_boxes, np.float32))
        entry["gt_overlaps"] = np.append(
            entry["gt_overlaps"], gt_overlaps, axis=0)
        entry["is_crowd"] = np.append(
            entry["is_crowd"], np.zeros(num_boxes, bool))
        entry["box_to_gt_ind_map"] = np.append(
            entry["box_to_gt_ind_map"], box_to_gt_ind_map)
