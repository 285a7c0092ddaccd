"""The port's VOC and Cityscapes evaluators and task_evaluation's dispatch
to them, against the JAX package's, on the fixtures of
tests/test_voc_eval.py and tests/test_cityscapes_eval.py (copied here):
results dicts equal, exactly.

- VOC: evaluate_boxes by the devkit-XML protocol and by the converted
  json (devkit hidden), the comp4 results files, voc_ap (11-point and
  all-point) and voc_eval_class on seeded curves and detections;
- Cityscapes: evaluate_masks_official (perfect, crowd-absorbed and
  low-IoU predictions), evaluate_masks (dump, COCO protocol and official
  protocol; the JAX copy raises AttributeError after its dump, a fault
  of the reference the port repairs) and the id remaps;
- task_evaluation.evaluate_all on both datasets (VOC boxes to box AP /
  AP50, Cityscapes boxes and masks to the COCO protocol);
- the ground truth fed back as detections scores 1.0, on the fixtures and
  on make_synthetic_valset's VOC and Cityscapes sets.
"""

import json
import os

import numpy as np
import pytest

from detectron_tpu.core import config as jax_config
from detectron_tpu.data import cityscapes_json_dataset_evaluator as jax_cs
from detectron_tpu.data import dataset_catalog as jax_cat
from detectron_tpu.data import json_dataset_evaluator as jax_json_eval
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.data import task_evaluation as jax_te
from detectron_tpu.data import voc_dataset_evaluator as jax_voc
from detectron_tpu.data.json_dataset import JsonDataset as JaxJsonDataset
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.data import cityscapes_json_dataset_evaluator as cs
from detectron_tpu_torch.data import dataset_catalog as cat
from detectron_tpu_torch.data import rle
from detectron_tpu_torch.data import task_evaluation as te
from detectron_tpu_torch.data import voc_dataset_evaluator as voc
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.tools import make_synthetic_valset as maker
from test_torch_util import set_cfgs

CLASSES = ("aeroplane", "bicycle")
# A perfect AP: the 11-point metric adds 1/11 eleven times.
ONE = pytest.approx(1.0, rel=0, abs=1e-12)


def _data_dir(path, mask_on):
    set_cfgs(mask_on=mask_on)
    for c in (port_config, jax_config):
        c.merge_cfg_from_list(["DATA_DIR", str(path)])


# ---------------------------------------------------------------------------
# VOC (tests/test_voc_eval.py's fixture)
# ---------------------------------------------------------------------------

@pytest.fixture
def voc_env(tmp_path):
    """data/VOC2007 with both a converted json and a devkit tree."""
    gt = {
        1: [("aeroplane", [10, 10, 60, 50], 0),
            ("bicycle", [70, 20, 110, 70], 0)],
        2: [("aeroplane", [5, 5, 45, 45], 1)],  # difficult
        3: [("bicycle", [30, 30, 90, 90], 0)],
    }
    ann_dir = tmp_path / "VOC2007" / "annotations"
    ann_dir.mkdir(parents=True)
    images, annotations = [], []
    aid = 1
    for img_id, objs in gt.items():
        images.append({"id": img_id, "width": 128, "height": 96,
                       "file_name": "{:06d}.jpg".format(img_id)})
        for name, (x1, y1, x2, y2), diff in objs:
            annotations.append({
                "id": aid, "image_id": img_id,
                "category_id": CLASSES.index(name) + 1,
                "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                "area": (x2 - x1 + 1) * (y2 - y1 + 1),
                "iscrowd": 0, "difficult": diff,
            })
            aid += 1
    (ann_dir / "voc_2007_test.json").write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": i + 1, "name": n, "supercategory": "voc"}
                       for i, n in enumerate(CLASSES)],
    }))
    (tmp_path / "VOC2007" / "JPEGImages").mkdir()
    devkit = tmp_path / "VOC2007" / "VOCdevkit2007" / "VOC2007"
    (devkit / "Annotations").mkdir(parents=True)
    (devkit / "ImageSets" / "Main").mkdir(parents=True)
    stems = []
    for img_id, objs in gt.items():
        stem = "{:06d}".format(img_id)
        stems.append(stem)
        objs_xml = "".join(
            "<object><name>{}</name><difficult>{}</difficult>"
            "<bndbox><xmin>{}</xmin><ymin>{}</ymin>"
            "<xmax>{}</xmax><ymax>{}</ymax></bndbox></object>".format(
                name, diff, x1 + 1, y1 + 1, x2 + 1, y2 + 1)
            for name, (x1, y1, x2, y2), diff in objs)
        (devkit / "Annotations" / (stem + ".xml")).write_text(
            "<annotation>{}</annotation>".format(objs_xml))
    (devkit / "ImageSets" / "Main" / "test.txt").write_text(
        "\n".join(stems) + "\n")
    _data_dir(tmp_path, mask_on=False)
    return tmp_path


def _fake_detections(num_images=3):
    """[cls][img] (N, 5): one good det per gt + one false positive."""
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(num_images)]
                 for _ in range(len(CLASSES) + 1)]
    all_boxes[1][0] = np.array([[11, 11, 59, 49, 0.9]], np.float32)
    all_boxes[1][1] = np.array([[6, 6, 44, 44, 0.8]], np.float32)
    all_boxes[1][2] = np.array([[0, 0, 20, 20, 0.3]], np.float32)
    all_boxes[2][0] = np.array([[71, 21, 109, 69, 0.95]], np.float32)
    all_boxes[2][2] = np.array([[31, 31, 89, 89, 0.7]], np.float32)
    return all_boxes


def _gt_detections(dataset, exclude_difficult=False):
    """The dataset's ground truth as [cls][img] (N, 5) detections, score 1
    (xyxy, Detectron's +1 convention)."""
    ids = sorted(dataset.COCO.getImgIds())
    out = [[np.zeros((0, 5), np.float32) for _ in ids]
           for _ in dataset.classes]
    for i, img_id in enumerate(ids):
        for a in dataset.COCO.img_to_anns.get(img_id, []):
            if exclude_difficult and a.get("difficult", 0):
                continue
            j = dataset.json_category_id_to_contiguous_id[a["category_id"]]
            x, y, w, h = a["bbox"]
            out[j][i] = np.vstack([out[j][i], np.array(
                [[x, y, x + w - 1, y + h - 1, 1.0]], np.float32)])
    return out


def _hide_devkit(name):
    """Both catalogs' devkit entry for `name` pointed at a missing dir;
    returns the restore function."""
    saved = [(c, c.DATASETS[name][c.DEVKIT_DIR]) for c in (cat, jax_cat)]
    for c, _ in saved:
        c.DATASETS[name][c.DEVKIT_DIR] = "/nonexistent"

    def restore():
        for c, v in saved:
            c.DATASETS[name][c.DEVKIT_DIR] = v
    return restore


def test_voc_both_protocols_equal_jax(voc_env, tmp_path):
    ds, jds = JsonDataset("voc_2007_test"), JaxJsonDataset("voc_2007_test")
    all_boxes = _fake_detections()
    got = voc.evaluate_boxes(ds, all_boxes, str(tmp_path / "p1"))
    ref = jax_voc.evaluate_boxes(jds, all_boxes, str(tmp_path / "j1"))
    assert got == ref and got["protocol"] == "devkit_xml"
    assert got["use_07_metric"] is True
    for c in CLASSES:
        name = "comp4_det_test_{}.txt".format(c)
        assert (tmp_path / "p1" / name).read_text() == \
            (tmp_path / "j1" / name).read_text()
    restore = _hide_devkit("voc_2007_test")
    try:
        got_json = voc.evaluate_boxes(ds, all_boxes, str(tmp_path / "p2"))
        ref_json = jax_voc.evaluate_boxes(jds, all_boxes,
                                          str(tmp_path / "j2"))
    finally:
        restore()
    assert got_json == ref_json and "protocol" not in got_json
    assert got_json["map"] == got["map"]
    assert got["aps"]["bicycle"] == ONE


def test_voc_ground_truth_scores_map_one(voc_env, tmp_path):
    ds = JsonDataset("voc_2007_test")
    gt = _gt_detections(ds)
    assert voc.evaluate_boxes(ds, gt, str(tmp_path / "x"))["map"] == ONE
    restore = _hide_devkit("voc_2007_test")
    try:
        assert voc.evaluate_boxes(ds, gt, str(tmp_path / "y"))["map"] == ONE
    finally:
        restore()


def test_voc_ap_and_eval_class_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        n = rng.randint(1, 40)
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for use_07 in (True, False):
            assert voc.voc_ap(rec, prec, use_07) == \
                jax_voc.voc_ap(rec, prec, use_07)
        gt = {}
        for img in range(4):
            xy = rng.randint(0, 50, (3, 2)).astype(np.float64)
            gt[img] = (np.hstack([xy, xy + rng.randint(5, 30, (3, 2))]),
                       rng.rand(3) < 0.2)
        dets = [(int(rng.randint(5)), float(rng.rand()),
                 *map(float, rng.randint(0, 60, 2)),
                 *map(float, rng.randint(60, 90, 2))) for _ in range(n)]
        for use_07 in (True, False):
            got = voc.voc_eval_class(gt, dets, use_07_metric=use_07)
            ref = jax_voc.voc_eval_class(gt, dets, use_07_metric=use_07)
            assert got[0] == ref[0]
            np.testing.assert_array_equal(got[1], ref[1])
            np.testing.assert_array_equal(got[2], ref[2])


def test_task_evaluation_scores_voc_as_jax(voc_env, tmp_path):
    ds, jds = JsonDataset("voc_2007_test"), JaxJsonDataset("voc_2007_test")
    all_boxes = _fake_detections()
    got = te.evaluate_all(ds, all_boxes, None, None, str(tmp_path / "p"))
    ref = jax_te.evaluate_all(jds, all_boxes, None, None,
                              str(tmp_path / "j"))
    assert got == ref
    assert list(got["voc_2007_test"]["box"]) == ["AP", "AP50"]
    with pytest.raises(NotImplementedError, match="mask evaluator"):
        te.evaluate_masks(ds, all_boxes, [], str(tmp_path / "p"))


# ---------------------------------------------------------------------------
# Cityscapes (tests/test_cityscapes_eval.py's fixture)
# ---------------------------------------------------------------------------

def _rect_mask(h, w, y1, y2, x1, x2):
    m = np.zeros((h, w), np.uint8)
    m[y1:y2, x1:x2] = 1
    return m


@pytest.fixture
def cs_dataset(tmp_path):
    h, w = 64, 96
    ann_dir = tmp_path / "cityscapes" / "annotations"
    ann_dir.mkdir(parents=True)
    (tmp_path / "cityscapes" / "images").mkdir()
    imgs, anns = [], []
    for i in (1, 2):
        imgs.append({"id": i, "width": w, "height": h,
                     "file_name": "f{}_leftImg8bit.png".format(i)})
    # img1: a car (24 x 24), a crowd car region and a 5 x 5 car (under 100
    # px: ignored); img2: a car.
    anns.append({"id": 1, "image_id": 1, "category_id": 1, "iscrowd": 0,
                 "bbox": [8, 8, 24, 24], "area": 576,
                 "segmentation": [[8, 8, 32, 8, 32, 32, 8, 32]]})
    anns.append({"id": 2, "image_id": 1, "category_id": 1, "iscrowd": 1,
                 "bbox": [60, 10, 20, 20], "area": 400,
                 "segmentation": [[60, 10, 80, 10, 80, 30, 60, 30]]})
    anns.append({"id": 3, "image_id": 1, "category_id": 1, "iscrowd": 0,
                 "bbox": [40, 50, 5, 5], "area": 25,
                 "segmentation": [[40, 50, 45, 50, 45, 55, 40, 55]]})
    anns.append({"id": 4, "image_id": 2, "category_id": 1, "iscrowd": 0,
                 "bbox": [10, 10, 30, 30], "area": 900,
                 "segmentation": [[10, 10, 40, 10, 40, 40, 10, 40]]})
    (ann_dir / "instancesonly_filtered_gtFine_val.json").write_text(
        json.dumps({"images": imgs, "annotations": anns, "categories": [
            {"id": 1, "name": "car", "supercategory": "v"}]}))
    for c in (cat, jax_cat):
        c.DATASETS["cityscapes_test_tiny"] = {
            c.IM_DIR: c._D("cityscapes/images"),
            c.ANN_FN: c._D("cityscapes/annotations/"
                           "instancesonly_filtered_gtFine_val.json"),
        }
    _data_dir(tmp_path, mask_on=True)
    yield (JsonDataset("cityscapes_test_tiny"),
           JaxJsonDataset("cityscapes_test_tiny"), (h, w))
    for c in (cat, jax_cat):
        del c.DATASETS["cityscapes_test_tiny"]


def _results(hw, perfect=True, add_crowd_pred=False):
    h, w = hw
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(2)]
                 for _ in range(2)]
    all_segms = [[[] for _ in range(2)] for _ in range(2)]
    m1 = _rect_mask(h, w, 8, 32, 8, 32)
    m2 = _rect_mask(h, w, 10, 40, 10, 40) if perfect else \
        _rect_mask(h, w, 25, 40, 25, 40)
    boxes1 = [[8, 8, 31, 31, 0.9]]
    segs1 = [rle.encode(m1)]
    if add_crowd_pred:
        boxes1.append([62, 12, 77, 27, 0.95])
        segs1.append(rle.encode(_rect_mask(h, w, 12, 28, 62, 78)))
    all_boxes[1][0] = np.array(boxes1, np.float32)
    all_segms[1][0] = segs1
    all_boxes[1][1] = np.array([[10, 10, 39, 39, 0.8]], np.float32)
    all_segms[1][1] = [rle.encode(m2)]
    return all_boxes, all_segms


@pytest.mark.parametrize("perfect,crowd,ap", [
    (True, False, 1.0), (True, True, 1.0), (False, False, None)])
def test_cityscapes_official_protocol_equals_jax(cs_dataset, perfect, crowd,
                                                 ap):
    ds, jds, hw = cs_dataset
    all_boxes, all_segms = _results(hw, perfect, crowd)
    got = cs.evaluate_masks_official(ds, all_boxes, all_segms)
    assert got == jax_cs.evaluate_masks_official(jds, all_boxes, all_segms)
    if ap is not None:
        assert got["ap_official"] == got["ap50_official"] == ap
    else:
        assert got["ap50_official"] < 1.0
        assert got["ap_official"] < got["ap50_official"] + 1e-9


def test_cityscapes_evaluate_masks_and_dispatch_equal_jax(cs_dataset,
                                                          tmp_path):
    ds, jds, hw = cs_dataset
    all_boxes, all_segms = _results(hw, perfect=False, add_crowd_pred=True)
    got = cs.evaluate_masks(ds, all_boxes, all_segms, str(tmp_path / "p"))
    # A fault of the reference: its evaluate_masks calls .update on the
    # COCOeval the json evaluator returns (after the dump).
    with pytest.raises(AttributeError, match="update"):
        jax_cs.evaluate_masks(jds, all_boxes, all_segms,
                              str(tmp_path / "j"))
    ref = jax_json_eval.evaluate_masks(jds, all_boxes, all_segms,
                                       str(tmp_path / "j"))
    assert got["coco_eval"].stats.tolist() == ref.stats.tolist()
    assert {k: v for k, v in got.items() if k != "coco_eval"} == \
        jax_cs.evaluate_masks_official(jds, all_boxes, all_segms)
    for res in ("p", "j"):
        assert sorted(os.listdir(tmp_path / res / "cityscapes_results")) \
            == ["f1_leftImg8bit.txt", "f1_leftImg8bit_0.png",
                "f1_leftImg8bit_1.png", "f2_leftImg8bit.txt",
                "f2_leftImg8bit_0.png"]
    assert (tmp_path / "p" / "cityscapes_results" / "f1_leftImg8bit.txt"
            ).read_text() == (tmp_path / "j" / "cityscapes_results" /
                              "f1_leftImg8bit.txt").read_text()
    got = te.evaluate_all(ds, all_boxes, all_segms, None,
                          str(tmp_path / "p"))
    ref = jax_te.evaluate_all(jds, all_boxes, all_segms, None,
                              str(tmp_path / "j"))
    assert got == ref and list(got["cityscapes_test_tiny"]) == ["box",
                                                                "mask"]
    for name in ("car", "person", "bicycle", "bus", "tree"):
        assert cs.coco_to_cityscapes_id(name) == \
            jax_cs.coco_to_cityscapes_id(name)
    assert cs.cityscapes_to_coco(None) == jax_cs.cityscapes_to_coco(None)


# ---------------------------------------------------------------------------
# make_synthetic_valset's sets: the ground truth fed back scores 1.0
# ---------------------------------------------------------------------------

def test_synthetic_voc_set_ground_truth_scores_one(tmp_path):
    maker.make_vocset(str(tmp_path), 4, 7)
    _data_dir(tmp_path, mask_on=False)
    ds, jds = JsonDataset("voc_2007_test"), JaxJsonDataset("voc_2007_test")
    assert len(ds.classes) == 21
    gt = _gt_detections(ds)
    got = voc.evaluate_boxes(ds, gt, str(tmp_path / "o"))
    assert got == jax_voc.evaluate_boxes(jds, gt, str(tmp_path / "j"))
    assert got["protocol"] == "devkit_xml" and got["map"] == ONE
    restore = _hide_devkit("voc_2007_test")
    try:
        assert voc.evaluate_boxes(ds, gt, str(tmp_path / "o2"))["map"] == ONE
    finally:
        restore()
    assert len(JsonDataset("voc_2007_trainval").COCO.getImgIds()) == 4


def test_synthetic_cityscapes_set_ground_truth_scores_one(tmp_path):
    n_ann = maker.make_cityscapes_set(str(tmp_path), 2, size=(96, 192))
    _data_dir(tmp_path, mask_on=True)
    name = "cityscapes_fine_instanceonly_seg_val"
    ds, jds = JsonDataset(name), JaxJsonDataset(name)
    ids = sorted(ds.COCO.getImgIds())
    anns = [a for i in ids for a in ds.COCO.img_to_anns[i]]
    assert len(anns) == n_ann and any(a["iscrowd"] for a in anns)
    assert any(rle.area(rle.frPyObjects(a["segmentation"], 96, 192)[0])
               < cs.MIN_REGION_SIZE for a in anns if not a["iscrowd"])
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in ids]
                 for _ in ds.classes]
    all_segms = [[[] for _ in ids] for _ in ds.classes]
    for i, img_id in enumerate(ids):
        for a in ds.COCO.img_to_anns[img_id]:
            if a["iscrowd"]:
                continue
            j = ds.json_category_id_to_contiguous_id[a["category_id"]]
            x, y, w, h = a["bbox"]
            all_boxes[j][i] = np.vstack([all_boxes[j][i], np.array(
                [[x, y, x + w - 1, y + h - 1, 1.0]], np.float32)])
            all_segms[j][i].append(
                rle.merge(rle.frPyObjects(a["segmentation"], 96, 192)))
    got = cs.evaluate_masks_official(ds, all_boxes, all_segms)
    ref = jax_cs.evaluate_masks_official(
        jds, all_boxes, [[[dict(r) for r in s] for s in c]
                         for c in all_segms])
    assert got == ref and got["ap_official"] == 1.0
    assert jax_rle.merge([all_segms[j][0][0]]) == rle.merge(
        [all_segms[j][0][0]])
