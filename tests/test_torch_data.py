"""The port's data layer against the JAX package's on one small COCO-format
dataset (polygon, RLE and crowd annotations, an ignored and a degenerate
box, a category with no annotation): JsonDataset.get_roidb (with and
without a proposal file), COCOeval box and segm stats on the same gt and
detections (equal to 1e-12), the keypoint protocol's params,
task_evaluation.evaluate_all and the files it writes, and
check_expected_results."""

import json
import pickle

import numpy as np
import pytest

from detectron_tpu.core import config as jax_config
from detectron_tpu.data import coco_eval as jax_coco_eval
from detectron_tpu.data import json_dataset as jax_json_dataset
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.data import task_evaluation as jax_task_evaluation
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.data import coco_eval
from detectron_tpu_torch.data import json_dataset
from detectron_tpu_torch.data import task_evaluation

SIZES = [(120, 160), (160, 120), (100, 100), (90, 140)]
CATS = [(1, "widget"), (3, "gadget"), (7, "sprocket"), (8, "unused")]


def _annotations(rng):
    anns = []
    for i, (h, w) in enumerate(SIZES):
        for k in range(5 + i):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            a = {"id": len(anns) + 1, "image_id": i + 1,
                 "category_id": CATS[k % 3][0],
                 "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                 "segmentation": [[x, y, x + bw, y + bh * 0.2, x + bw * 0.8,
                                   y + bh, x, y + bh * 0.9]]}
            if k == 1:  # an uncompressed-RLE crowd region
                m = np.zeros((h, w), np.uint8)
                m[int(y):int(y + bh), int(x):int(x + bw)] = 1
                a.update(iscrowd=1, segmentation={
                    "size": [h, w], "counts": jax_rle.encode_counts(m)})
            if k == 2 and i == 1:
                a["ignore"] = 1
            if k == 3 and i == 2:  # degenerate: dropped from the roidb
                a["bbox"] = [x, y, 0.5, bh]
            anns.append(a)
    return anns


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    (root / "coco" / "val2017").mkdir(parents=True)
    (root / "coco" / "annotations").mkdir()
    rng = np.random.RandomState(0)
    gt = {"images": [{"id": i + 1, "height": h, "width": w,
                      "file_name": "{:012d}.ppm".format(i + 1)}
                     for i, (h, w) in enumerate(SIZES)],
          "annotations": _annotations(rng),
          "categories": [{"id": c, "name": n, "supercategory": "t"}
                         for c, n in CATS]}
    (root / "coco" / "annotations" / "instances_val2017.json").write_text(
        json.dumps(gt))
    # A proposal file with image ids out of order, as the reference's
    # proposal pickles may be.
    order = [2, 0, 3, 1]
    props = {"ids": [i + 1 for i in order], "boxes": [], "scores": []}
    for i in order:
        h, w = SIZES[i]
        xy = rng.uniform(-10, min(h, w), (30, 2))
        b = np.concatenate([xy, xy + rng.uniform(0.5, 60, (30, 2))], 1)
        b[5] = b[4]  # a duplicate, dropped by unique_boxes
        props["boxes"].append(b.astype(np.float32))
        props["scores"].append(rng.rand(30).astype(np.float32))
    with open(root / "props.pkl", "wb") as f:
        pickle.dump(props, f)
    return root


def _set_both(root, mask_on=True):
    for c in (jax_config, port_config):
        if c is port_config:
            c.reset_cfg()
        c.merge_cfg_from_list(["DATA_DIR", str(root), "MODEL.MASK_ON",
                               str(mask_on), "MODEL.NUM_CLASSES", "5"])
        c.assert_and_infer_cfg(make_immutable=False)


def _same_roidb(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in g:
            if k == "dataset":
                continue
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], r[k])
                assert g[k].dtype == r[k].dtype, k
            else:
                assert g[k] == r[k], k


@pytest.mark.parametrize("proposals", [False, True])
def test_get_roidb_matches_jax(dataset_dir, proposals):
    _set_both(dataset_dir)
    kw = {}
    if proposals:
        kw = dict(proposal_file=str(dataset_dir / "props.pkl"),
                  proposal_limit=20)
    got = json_dataset.JsonDataset("coco_2017_val").get_roidb(gt=True, **kw)
    ref = jax_json_dataset.JsonDataset("coco_2017_val").get_roidb(gt=True,
                                                                  **kw)
    _same_roidb(got, ref)
    n_gt = [int((e["gt_classes"] > 0).sum()) for e in got]
    assert n_gt == [5, 5, 6, 8]  # one ignored, one degenerate box dropped
    if proposals:
        assert all((e["gt_classes"] == 0).sum() == 20 for e in got)


def _detections(dataset, rng):
    """Per-class, per-image detections near the gt (and some far off),
    with polygon-derived or random-blob RLE masks: all_boxes[j][i] (n, 5),
    all_segms[j][i] a list of n RLEs."""
    n_cls = dataset.num_classes
    n_im = len(SIZES)
    all_boxes = [[[] for _ in range(n_im)] for _ in range(n_cls)]
    all_segms = [[[] for _ in range(n_im)] for _ in range(n_cls)]
    roidb = dataset.get_roidb(gt=True)
    for i, e in enumerate(roidb):
        h, w = e["height"], e["width"]
        for j in range(1, n_cls):
            gt = e["boxes"][e["gt_classes"] == j]
            n = len(gt) + 2
            b = np.zeros((n, 5), np.float32)
            if len(gt):
                b[:len(gt), :4] = gt + rng.normal(0, 3, gt.shape)
            xy = rng.uniform(0, min(h, w) / 2, (2, 2))
            b[len(gt):, :2] = xy
            b[len(gt):, 2:4] = xy + rng.uniform(5, 40, (2, 2))
            b[:, 4] = rng.permutation(n) / n * 0.9 + 0.05
            segms = []
            for k in range(n):
                m = np.zeros((h, w), np.uint8)
                x1, y1, x2, y2 = np.clip(b[k, :4], 0, [w, h, w, h]).astype(
                    int)
                m[y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.2
                segms.append(jax_rle.encode(m))
            all_boxes[j][i] = b
            all_segms[j][i] = segms
    return all_boxes, all_segms


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_cocoeval_matches_jax(dataset_dir, iou_type, tmp_path):
    """The same gt and detections through both COCOeval implementations,
    via each package's result writer."""
    from detectron_tpu.data import json_dataset_evaluator as jax_eval
    from detectron_tpu_torch.data import json_dataset_evaluator as port_eval

    _set_both(dataset_dir)
    rng = np.random.RandomState(1)
    port_ds = json_dataset.JsonDataset("coco_2017_val")
    jax_ds = jax_json_dataset.JsonDataset("coco_2017_val")
    all_boxes, all_segms = _detections(port_ds, rng)
    if iou_type == "bbox":
        got = port_eval.evaluate_boxes(port_ds, all_boxes, str(tmp_path / "p"))
        ref = jax_eval.evaluate_boxes(jax_ds, all_boxes, str(tmp_path / "j"))
    else:
        got = port_eval.evaluate_masks(port_ds, all_boxes, all_segms,
                                       str(tmp_path / "p"))
        ref = jax_eval.evaluate_masks(jax_ds, all_boxes, all_segms,
                                      str(tmp_path / "j"))
    assert isinstance(got, coco_eval.COCOeval)
    assert isinstance(ref, jax_coco_eval.COCOeval)
    assert len(got.stats) == 12
    assert 0.05 < got.stats[0] < 0.95  # a score that can move
    np.testing.assert_allclose(got.stats, ref.stats, rtol=0, atol=1e-12)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_allclose(got.eval[k], ref.eval[k], rtol=0,
                                   atol=1e-12)
    name = "{}_coco_2017_val_results.json".format(iou_type)
    assert json.loads((tmp_path / "p" / name).read_text()) == json.loads(
        (tmp_path / "j" / name).read_text())


def test_keypoint_params_match_jax():
    """COCOeval's OKS protocol: maxDets [20], the all / medium / large
    area ranges and the 17 keypoint sigmas, as the JAX package's."""
    got, ref = coco_eval.Params("keypoints"), jax_coco_eval.Params(
        "keypoints")
    assert got.maxDets == ref.maxDets == [20]
    assert got.areaRng == ref.areaRng and got.areaRngLbl == ref.areaRngLbl
    assert got.areaRngLbl == ["all", "medium", "large"]
    for k in ("kpt_oks_sigmas", "iouThrs", "recThrs"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.kpt_oks_sigmas.shape == (17,)
    with pytest.raises(ValueError):
        coco_eval.Params("keypoint")


def test_evaluate_all_matches_jax(dataset_dir, tmp_path):
    _set_both(dataset_dir)
    rng = np.random.RandomState(2)
    port_ds = json_dataset.JsonDataset("coco_2017_val")
    jax_ds = jax_json_dataset.JsonDataset("coco_2017_val")
    all_boxes, all_segms = _detections(port_ds, rng)
    keyps = [[[] for _ in SIZES] for _ in range(port_ds.num_classes)]
    got = task_evaluation.evaluate_all(port_ds, all_boxes, all_segms, keyps,
                                       str(tmp_path / "p"))
    ref = jax_task_evaluation.evaluate_all(jax_ds, all_boxes, all_segms,
                                           keyps, str(tmp_path / "j"))
    assert list(got) == list(ref) == ["coco_2017_val"]
    assert list(got["coco_2017_val"]) == ["box", "mask"]
    for task in ("box", "mask"):
        g, r = got["coco_2017_val"][task], ref["coco_2017_val"][task]
        assert list(g) == list(r)
        np.testing.assert_allclose(list(g.values()), list(r.values()),
                                   rtol=0, atol=1e-12)


def test_check_expected_results():
    """Passes within atol + rtol * |expected| and raises past it. (The JAX
    package's copy raises ValueError for any EXPECTED_RESULTS entry, from
    its log message; the port's formats it.)"""
    port_config.reset_cfg()
    results = {"coco_2017_val": {"box": {"AP": 0.30}}}
    port_config.cfg.EXPECTED_RESULTS = [["coco_2017_val", "box", "AP",
                                         0.32]]
    task_evaluation.check_expected_results(results, atol=0.005, rtol=0.1)
    with pytest.raises(AssertionError, match="FAIL: coco_2017_val > box > "
                                             "AP sanity check"):
        task_evaluation.check_expected_results(results, atol=0.005,
                                               rtol=0.01)
    port_config.reset_cfg()
