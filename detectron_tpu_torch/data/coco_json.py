"""Minimal COCO JSON API (pycocotools.coco.COCO replacement; the port's
copy of detectron_tpu/data/coco_json.py): images, annotations indexed by
image, categories, and result loading for box, mask and keypoint
evaluation.
"""

import json
from collections import defaultdict

import numpy as np

from detectron_tpu_torch.data import rle as mask_util


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file, "r") as f:
                self.dataset = json.load(f)
            self.create_index()

    def create_index(self):
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # -- pycocotools-compatible accessors -------------------------------
    def getImgIds(self):
        return sorted(self.imgs.keys())

    def getCatIds(self):
        return sorted(c["id"] for c in self.dataset.get("categories", []))

    def getAnnIds(self, imgIds):
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        return [a["id"] for i in imgIds for a in self.img_to_anns[i]]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, results):
        """Load detection results (list of dicts or a json path) into a new
        COCO object sharing this one's images/categories."""
        res = COCO()
        res.dataset["images"] = list(self.dataset.get("images", []))
        res.dataset["categories"] = list(self.dataset.get("categories", []))
        if isinstance(results, str):
            with open(results, "r") as f:
                anns = json.load(f)
        else:
            anns = results
        for i, ann in enumerate(anns):
            ann = dict(ann)
            ann["id"] = i + 1
            if "bbox" in ann and "area" not in ann:
                ann["area"] = ann["bbox"][2] * ann["bbox"][3]
            if "segmentation" in ann and "area" not in ann:
                ann["area"] = mask_util.area(ann["segmentation"])
            if "keypoints" in ann and "area" not in ann:
                # pycocotools loadRes: area and bbox from the keypoints'
                # extent.
                k = np.asarray(ann["keypoints"])
                xs, ys = k[0::3], k[1::3]
                x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
                ann["area"] = float((x1 - x0) * (y1 - y0))
                ann["bbox"] = [float(x0), float(y0), float(x1 - x0),
                               float(y1 - y0)]
            ann.setdefault("iscrowd", 0)
            res.dataset.setdefault("annotations", []).append(ann)
        res.create_index()
        return res
