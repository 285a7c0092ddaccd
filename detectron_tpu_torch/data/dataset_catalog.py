"""Dataset name -> paths registry (the port's copy of
detectron_tpu/data/dataset_catalog.py; reference:
lib/datasets/dataset_catalog.py): the same dataset keys and the data/
symlink conventions (IM_DIR under data/<set>, ANN_FN under
data/<set>/annotations), resolved against the port's cfg.DATA_DIR.
"""

import os

from detectron_tpu_torch.core.config import cfg

IM_DIR = "image_directory"
ANN_FN = "annotation_file"
IM_PREFIX = "image_prefix"
DEVKIT_DIR = "devkit_directory"
RAW_DIR = "raw_dir"


class _D(str):
    """DATA_DIR-relative path, resolved lazily against cfg.DATA_DIR (which
    yaml files may override after this module imports)."""

    def resolve(self):
        return os.path.join(cfg.DATA_DIR, str(self))


def _coco(im_sub, ann_sub, prefix=""):
    d = {IM_DIR: _D("coco/" + im_sub),
         ANN_FN: _D("coco/annotations/" + ann_sub)}
    if prefix:
        d[IM_PREFIX] = prefix
    return d


DATASETS = {
    "coco_2014_train": _coco("coco_train2014", "instances_train2014.json"),
    "coco_2014_val": _coco("coco_val2014", "instances_val2014.json"),
    "coco_2014_minival": _coco("coco_val2014", "instances_minival2014.json"),
    "coco_2014_valminusminival": _coco(
        "coco_val2014", "instances_valminusminival2014.json"),
    "coco_2015_test": _coco("coco_test2015", "image_info_test2015.json"),
    "coco_2015_test-dev": _coco("coco_test2015",
                                "image_info_test-dev2015.json"),
    "coco_2017_train": _coco("train2017", "instances_train2017.json"),
    "coco_2017_val": _coco("val2017", "instances_val2017.json"),
    "coco_2017_test": _coco("test2017", "image_info_test2017.json"),
    "coco_2017_test-dev": _coco("test2017", "image_info_test-dev2017.json"),
    "keypoints_coco_2014_train": _coco(
        "coco_train2014", "person_keypoints_train2014.json"),
    "keypoints_coco_2014_val": _coco(
        "coco_val2014", "person_keypoints_val2014.json"),
    "keypoints_coco_2014_minival": _coco(
        "coco_val2014", "person_keypoints_minival2014.json"),
    "keypoints_coco_2014_valminusminival": _coco(
        "coco_val2014", "person_keypoints_valminusminival2014.json"),
    "keypoints_coco_2017_train": _coco(
        "train2017", "person_keypoints_train2017.json"),
    "keypoints_coco_2017_val": _coco(
        "val2017", "person_keypoints_val2017.json"),
    "voc_2007_trainval": {
        IM_DIR: _D("VOC2007/JPEGImages"),
        ANN_FN: _D("VOC2007/annotations/voc_2007_trainval.json"),
        DEVKIT_DIR: _D("VOC2007/VOCdevkit2007"),
    },
    "voc_2007_test": {
        IM_DIR: _D("VOC2007/JPEGImages"),
        ANN_FN: _D("VOC2007/annotations/voc_2007_test.json"),
        DEVKIT_DIR: _D("VOC2007/VOCdevkit2007"),
    },
    "voc_2012_trainval": {
        IM_DIR: _D("VOC2012/JPEGImages"),
        ANN_FN: _D("VOC2012/annotations/voc_2012_trainval.json"),
        DEVKIT_DIR: _D("VOC2012/VOCdevkit2012"),
    },
    "cityscapes_fine_instanceonly_seg_train": {
        IM_DIR: _D("cityscapes/images"),
        ANN_FN: _D("cityscapes/annotations/instancesonly_filtered_"
                   "gtFine_train.json"),
        RAW_DIR: _D("cityscapes/raw"),
    },
    "cityscapes_fine_instanceonly_seg_val": {
        IM_DIR: _D("cityscapes/images"),
        ANN_FN: _D("cityscapes/annotations/instancesonly_filtered_"
                   "gtFine_val.json"),
        RAW_DIR: _D("cityscapes/raw"),
    },
    "cityscapes_fine_instanceonly_seg_test": {
        IM_DIR: _D("cityscapes/images"),
        ANN_FN: _D("cityscapes/annotations/instancesonly_filtered_"
                   "gtFine_test.json"),
        RAW_DIR: _D("cityscapes/raw"),
    },
}


def _resolve(v):
    return v.resolve() if isinstance(v, _D) else v


def get_im_dir(name):
    return _resolve(DATASETS[name][IM_DIR])


def get_ann_fn(name):
    return _resolve(DATASETS[name][ANN_FN])


def get_im_prefix(name):
    return DATASETS[name].get(IM_PREFIX, "")

