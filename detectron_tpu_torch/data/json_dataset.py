"""COCO-style JSON dataset -> roidb (the port's copy of
detectron_tpu/data/json_dataset.py; reference:
lib/datasets/json_dataset.py :: JsonDataset).

Roidb entries carry boxes (xyxy), segms, gt_classes, seg_areas,
gt_overlaps (dense (N, C)), is_crowd and box_to_gt_ind_map, with the
contiguous category remapping and the filtering of degenerate gt boxes;
for a dataset whose person category names keypoints, also gt_keypoints
(N, 3, K) and has_visible_keypoints.
Precomputed proposals are read from a file (TEST.PROPOSAL_FILES for
evaluation, TRAIN.PROPOSAL_FILES for Fast R-CNN training) and appended as
non-gt rows, with the crowd filter (proposals that lie inside a crowd
region take overlap -1); add_proposals merges runtime proposals and fills
max_classes / max_overlaps.
"""

import os
import pickle

import numpy as np

from detectron_tpu_torch.data import dataset_catalog
from detectron_tpu_torch.data.coco_json import COCO
from detectron_tpu_torch.utils import boxes as box_utils
from detectron_tpu_torch.utils import keypoints as keypoint_utils


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
        self._init_keypoints()

    def get_roidb(self, gt=False, proposal_file=None, min_proposal_size=2,
                  proposal_limit=-1, crowd_filter_thresh=0):
        image_ids = self.COCO.getImgIds()
        roidb = list(self.COCO.loadImgs(image_ids))
        for entry in roidb:
            self._prep_roidb_entry(entry)
        if gt:
            for entry in roidb:
                self._add_gt_annotations(entry)
        if proposal_file is not None:
            self._add_proposals_from_file(
                roidb, proposal_file, min_proposal_size, proposal_limit,
                crowd_filter_thresh)
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
        if self.keypoints is not None:
            entry["gt_keypoints"] = np.empty((0, 3, self.num_keypoints),
                                             np.float32)
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
        if self.keypoints is not None:
            gt_keypoints = np.zeros((num_valid, 3, self.num_keypoints),
                                    np.float32)

        im_has_visible_keypoints = False
        for ix, obj in enumerate(valid_objs):
            cls = self.json_category_id_to_contiguous_id[obj["category_id"]]
            boxes[ix, :] = obj["clean_bbox"]
            gt_classes[ix] = cls
            seg_areas[ix] = obj.get("area", 0)
            is_crowd[ix] = obj.get("iscrowd", 0)
            box_to_gt_ind_map[ix] = ix
            if self.keypoints is not None:
                gt_keypoints[ix] = self._get_gt_keypoints(obj)
                if np.sum(gt_keypoints[ix, 2, :]) > 0:
                    im_has_visible_keypoints = True
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
        if self.keypoints is not None:
            entry["gt_keypoints"] = np.append(
                entry["gt_keypoints"], gt_keypoints, axis=0)
            entry["has_visible_keypoints"] = im_has_visible_keypoints

    def _init_keypoints(self):
        """The person category's keypoint names (None when the dataset has
        none), their count and the COCO flip pairs."""
        self.keypoints = None
        self.keypoint_flip_map = None
        self.num_keypoints = 0
        if "person" in self.category_to_id_map:
            cat_info = self.COCO.loadCats([self.category_to_id_map["person"]])
            keypoints = cat_info[0].get("keypoints")
            if keypoints is not None:
                self.keypoints = keypoints
                self.num_keypoints = len(keypoints)
                self.keypoint_flip_map = keypoint_utils.get_keypoints()[1]

    def _get_gt_keypoints(self, obj):
        """An annotation's keypoints as (3, K): x, y, visibility (zeros
        when it has none)."""
        gt_kps = np.zeros((3, self.num_keypoints), np.float32)
        if "keypoints" not in obj:
            return gt_kps
        kp = np.array(obj["keypoints"], dtype=np.float32)
        if len(kp) != 3 * self.num_keypoints:
            raise ValueError("annotation {} has {} keypoint values, the "
                             "person category names {} keypoints".format(
                                 obj.get("id"), len(kp), self.num_keypoints))
        gt_kps[0] = kp[0::3]
        gt_kps[1] = kp[1::3]
        gt_kps[2] = kp[2::3]
        return gt_kps

    def _add_proposals_from_file(self, roidb, proposal_file,
                                 min_proposal_size, top_k,
                                 crowd_filter_thresh):
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
        if crowd_filter_thresh > 0:
            _filter_crowd_proposals(roidb, crowd_filter_thresh)

    def add_proposals(self, roidb, rois, scales, crowd_thresh):
        """Merge runtime proposals (rows [image index, x1, y1, x2, y2] in
        scaled coordinates) into the roidb, then the crowd filter and the
        class assignments."""
        box_list = []
        for i in range(len(roidb)):
            inv_im_scale = 1.0 / scales[i]
            idx = np.where(rois[:, 0] == i)[0]
            box_list.append(rois[idx, 1:] * inv_im_scale)
        _merge_proposal_boxes_into_roidb(roidb, box_list)
        if crowd_thresh > 0:
            _filter_crowd_proposals(roidb, crowd_thresh)
        _add_class_assignments(roidb)


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


def _filter_crowd_proposals(roidb, crowd_thresh):
    """Mark proposals inside crowd regions as unusable (overlap -1)."""
    for entry in roidb:
        gt_overlaps = entry["gt_overlaps"]
        crowd_inds = np.where(entry["is_crowd"])[0]
        non_gt_inds = np.where(entry["gt_classes"] == 0)[0]
        if len(crowd_inds) == 0 or len(non_gt_inds) == 0:
            continue
        crowd_boxes = box_utils.xyxy_to_xywh(entry["boxes"][crowd_inds, :])
        non_gt_boxes = box_utils.xyxy_to_xywh(entry["boxes"][non_gt_inds, :])
        ious = _iof_xywh(non_gt_boxes, crowd_boxes)
        bad_inds = np.where(ious.max(axis=1) > crowd_thresh)[0]
        gt_overlaps[non_gt_inds[bad_inds], :] = -1.0
        entry["gt_overlaps"] = gt_overlaps


def _iof_xywh(boxes, query):
    """Intersection over (box) area for xywh boxes."""
    b = np.asarray(boxes, np.float64)
    q = np.asarray(query, np.float64)
    bx2 = b[:, 0] + b[:, 2]
    by2 = b[:, 1] + b[:, 3]
    qx2 = q[:, 0] + q[:, 2]
    qy2 = q[:, 1] + q[:, 3]
    ix1 = np.maximum(b[:, None, 0], q[None, :, 0])
    iy1 = np.maximum(b[:, None, 1], q[None, :, 1])
    ix2 = np.minimum(bx2[:, None], qx2[None, :])
    iy2 = np.minimum(by2[:, None], qy2[None, :])
    iw = np.maximum(ix2 - ix1, 0)
    ih = np.maximum(iy2 - iy1, 0)
    inter = iw * ih
    area = (b[:, 2] * b[:, 3])[:, None]
    return np.where(area > 0, inter / area, 0)


def _add_class_assignments(roidb):
    for entry in roidb:
        gt_overlaps = entry["gt_overlaps"]
        max_overlaps = gt_overlaps.max(axis=1)
        max_classes = gt_overlaps.argmax(axis=1)
        entry["max_classes"] = max_classes
        entry["max_overlaps"] = max_overlaps
        zero_inds = np.where(max_overlaps == 0)[0]
        assert all(max_classes[zero_inds] == 0)
        nonzero_inds = np.where(max_overlaps > 0)[0]
        assert all(max_classes[nonzero_inds] != 0)


def add_proposals(roidb, rois, scales, crowd_thresh):
    """Module-level form of JsonDataset.add_proposals (the reference's
    json_dataset.add_proposals free function)."""
    _merge_proposal_boxes_into_roidb(
        roidb, [rois[np.where(rois[:, 0] == i)[0], 1:] / scales[i]
                for i in range(len(roidb))])
    if crowd_thresh > 0:
        _filter_crowd_proposals(roidb, crowd_thresh)
    _add_class_assignments(roidb)
