"""The port's keypoint data and evaluation layers against the JAX package's,
on a 3-image person-keypoints dataset (PPM images of 96 x 128, one
orientation bucket; a person category naming the 17 COCO keypoints; one
image whose only person has no visible keypoint):

- heatmaps_to_keypoints (numpy bicubic resize) against the JAX package's
  (cv2.resize INTER_CUBIC) on random maps, for boxes smaller and larger
  than the 56 x 56 maps: x and y within 1e-3 px (so the same argmax
  cell), logits within 1e-5 and probabilities within 1e-4 relative;
- flip_keypoints, the training roidb with flips and the visible-keypoint
  filter, and a loader batch's gt_keypoints: exactly;
- COCOeval's OKS protocol on the same gt and results: stats, precision,
  recall and scores within 1e-12;
- run_inference end to end (batched test_net, the keypoint decode,
  evaluate_keypoints) against the JAX engine on the same checkpoint: the
  same detections (tests/test_torch_test_engine.py's matching), matched
  detections' keypoints within 1e-3 px, keypoint AP within 1e-12;
- the host path (im_detect_all): every box gets its keypoints, and
  without flags they equal the batched path's;
- the trainer (train_net_step --dataset keypoints_coco2017) for 2 steps
  on the CPU."""

import json
import os
import types

import numpy as np
import pytest
import torch

from detectron_tpu.core import test_engine as jax_engine
from detectron_tpu.data import coco_eval as jax_coco_eval
from detectron_tpu.data import coco_json as jax_coco_json
from detectron_tpu.data import loader as jax_loader
from detectron_tpu.data import roidb as jax_roidb
from detectron_tpu.data import task_evaluation as jax_task_evaluation
from detectron_tpu.data.json_dataset import JsonDataset as JaxJsonDataset
from detectron_tpu.utils import keypoints as jax_kp
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.data import coco_eval
from detectron_tpu_torch.data import coco_json
from detectron_tpu_torch.data import loader
from detectron_tpu_torch.data import roidb as port_roidb
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.models import init
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import keypoints as port_kp
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_test_engine import _assert_results_match
from test_torch_util import KPS_KEYS, set_cfgs

torch.set_num_threads(2)

NAMES = port_kp.get_keypoints()[0]
H, W = 96, 128
VAL = "keypoints_coco_2017_val"
# The engine at TINY_INFER_KEYS' sizes (tests/test_torch_test_engine.py).
ENGINE_KEYS = ["TEST.SCALE", "96", "TEST.MAX_SIZE", "128",
               "TEST.RPN_PRE_NMS_TOP_N", "64", "TEST.RPN_POST_NMS_TOP_N",
               "16", "TEST.DETECTIONS_PER_IM", "8", "TEST.SCORE_THRESH",
               "0.0", "TPU.NMS_TILE_SIZE", "32", "TRAIN.SCALES", "(96,)",
               "TRAIN.MAX_SIZE", "128", "TEST.DATASETS", "('{}',)".format(
                   VAL)]


def _person(rng, ann_id, image_id, visible=True):
    bh = rng.uniform(30, 80)
    bw = bh / rng.uniform(2.0, 3.0)
    x, y = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
    vis = rng.choice(3, 17, p=(0.2, 0.3, 0.5)) if visible else \
        np.zeros(17, int)
    xs = np.where(vis > 0, x + rng.uniform(0, bw, 17), 0.0)
    ys = np.where(vis > 0, y + rng.uniform(0, bh, 17), 0.0)
    return {"id": ann_id, "image_id": image_id, "category_id": 1,
            "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            "keypoints": [v for t in zip(xs, ys, vis) for v in
                          (float(t[0]), float(t[1]), int(t[2]))],
            "num_keypoints": int((vis > 0).sum())}


def _write_dataset(root):
    """PIXEL_MEANS + N(0, 1) images (scores that do not saturate under
    random weights) with 2, 1 (no visible keypoint) and 3 persons, as
    keypoints_coco_2017_val and keypoints_coco_2017_train."""
    rng = np.random.RandomState(0)
    means = np.array([102.9801, 115.9465, 122.7717])
    images, anns = [], []
    for i, n in enumerate((2, 1, 3)):
        name = "{:012d}.ppm".format(i + 1)
        im = np.clip(np.round(means + rng.randn(H, W, 3)), 0, 255)
        for split in ("val2017", "train2017"):
            os.makedirs(root / "coco" / split, exist_ok=True)
            image_io.write_ppm(str(root / "coco" / split / name),
                               im.astype(np.uint8))
        images.append({"id": i + 1, "width": W, "height": H,
                       "file_name": name})
        for _ in range(n):
            anns.append(_person(rng, len(anns) + 1, i + 1, visible=i != 1))
    gt = json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": 1, "name": "person", "supercategory": "person",
         "keypoints": NAMES, "skeleton": []}]})
    os.makedirs(root / "coco" / "annotations", exist_ok=True)
    for split in ("val2017", "train2017"):
        (root / "coco" / "annotations" /
         "person_keypoints_{}.json".format(split)).write_text(gt)


def _set(root, extra=()):
    set_cfgs(mask_on=False, extra=KPS_KEYS + ENGINE_KEYS + [
        "DATA_DIR", str(root)] + list(extra))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kps")
    _write_dataset(root)
    return root


@pytest.mark.parametrize("lo,hi", [(8, 50), (60, 300)])
def test_heatmaps_to_keypoints_matches_jax(lo, hi):
    set_cfgs(mask_on=False, extra=KPS_KEYS)
    rng = np.random.RandomState(lo)
    n = 12
    maps = (rng.randn(n, 17, 56, 56) * 3).astype(np.float32)
    xy = rng.uniform(0, 400, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(lo, hi, (n, 2))],
                          1).astype(np.float32)
    ref = jax_kp.heatmaps_to_keypoints(maps, rois)
    got = port_kp.heatmaps_to_keypoints(maps, rois)
    assert got.shape == ref.shape == (n, 4, 17) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=1e-4, atol=0)


def test_flip_keypoints_matches_jax():
    rng = np.random.RandomState(3)
    kps = np.zeros((4, 3, 17), np.float32)
    kps[:, :2] = rng.uniform(0, 120, (4, 2, 17))
    kps[:, 2] = rng.randint(0, 3, (4, 17))
    names, flip_map = port_kp.get_keypoints()
    got = port_kp.flip_keypoints(names, flip_map, kps, 128)
    ref = jax_kp.flip_keypoints(*jax_kp.get_keypoints(), kps, 128)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, kps)


def _roidbs(root):
    _set(root, ["TRAIN.USE_FLIPPED", "True"])
    got = port_roidb.combined_roidb_for_training(
        ("keypoints_coco_2017_train",))
    ref = jax_roidb.combined_roidb_for_training(
        ("keypoints_coco_2017_train",))
    return got, ref


def test_training_roidb_with_flips_matches_jax(root):
    (got, got_ratio, got_index), (ref, ref_ratio, ref_index) = _roidbs(root)
    # Image 2's only person has no visible keypoint: its entry and its
    # flip are filtered out.
    assert len(got) == len(ref) == 4
    assert sorted(e["id"] for e in got) == [1, 1, 3, 3]
    np.testing.assert_array_equal(got_ratio, ref_ratio)
    np.testing.assert_array_equal(got_index, ref_index)
    for g, r in zip(got, ref):
        assert g["flipped"] == r["flipped"] and g["id"] == r["id"]
        assert g["has_visible_keypoints"] and r["has_visible_keypoints"]
        for k in ("boxes", "gt_keypoints", "gt_classes", "is_crowd"):
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["gt_keypoints"].shape[1:] == (3, 17)


def test_loader_gt_keypoints_match_jax(root):
    (got, _, _), (ref, _, _) = _roidbs(root)
    rng_args = (np.random.RandomState(0), np.random.RandomState(0))
    g = loader.make_minibatch(got[:2], rng_args[0])
    r = jax_loader.make_minibatch(ref[:2], rng_args[1])
    assert set(g) == set(r) and "gt_keypoints" in g
    assert g["gt_keypoints"].shape == (2, 8, 17, 3)
    for k in ("gt_keypoints", "gt_boxes", "gt_valid", "im_info"):
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert (g["gt_keypoints"][..., 2] > 0).any()


def _oks_results(ds, rng):
    """Per gt person: its keypoints moved by 0.1-2 px (invisible ones
    anywhere in the image), and one false positive per image."""
    res = []
    for ann in ds.COCO.dataset["annotations"]:
        k = np.array(ann["keypoints"], np.float64).reshape(17, 3)
        k[:, :2] += rng.randn(17, 2) * rng.uniform(0.1, 2)
        k[k[:, 2] == 0, :2] = rng.uniform(0, 96, (int((k[:, 2] == 0).sum()),
                                                  2))
        res.append({"image_id": ann["image_id"], "category_id": 1,
                    "keypoints": [float(v) for v in
                                  np.c_[k[:, :2], np.ones(17)].ravel()],
                    "score": float(rng.uniform(0.1, 1))})
    for img in ds.COCO.dataset["images"]:
        res.append({"image_id": img["id"], "category_id": 1,
                    "keypoints": [float(v) for v in np.c_[
                        rng.uniform(0, 96, (17, 2)), np.ones(17)].ravel()],
                    "score": float(rng.uniform(0.1, 1))})
    return res


def test_keypoint_cocoeval_matches_jax(root):
    _set(root)
    ann = str(root / "coco" / "annotations" / "person_keypoints_val2017.json")
    results = _oks_results(JsonDataset(VAL), np.random.RandomState(1))
    evals = []
    for api, ev in ((coco_json, coco_eval), (jax_coco_json, jax_coco_eval)):
        gt = api.COCO(ann)
        e = ev.COCOeval(gt, gt.loadRes(json.loads(json.dumps(results))),
                        "keypoints")
        e.evaluate()
        e.accumulate()
        e.summarize()
        evals.append(e)
    got, ref = evals
    assert len(got.stats) == 10
    assert 0.05 < got.stats[0] < 0.95
    np.testing.assert_allclose(got.stats, ref.stats, rtol=0, atol=1e-12)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_allclose(got.eval[k], ref.eval[k], rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def engine(root):
    """The same checkpoint through the port's run_inference and the JAX
    package's test_net + evaluate_all (one compile: one canvas)."""
    from detectron_tpu.utils import net as jax_net

    _set(root)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    ckpt = net.save_ckpt(str(root / "weights"), 0, tree)
    args = types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None)
    got_results = test_engine.run_inference(
        args, dataset_name=VAL, output_dir=str(root / "port_out"),
        batch_size=2, device="cpu")
    ds = JaxJsonDataset(VAL)
    ref = jax_engine.test_net(jax_net.load_ckpt_params(ckpt),
                              ds.get_roidb(gt=True), ds, batch_size=2)
    ref_results = jax_task_evaluation.evaluate_all(
        ds, *ref, str(root / "jax_out"))
    with open(root / "port_out" / "detections.pkl", "rb") as f:
        import pickle
        got = pickle.load(f)
    return types.SimpleNamespace(args=args, got=got, got_results=got_results,
                                 ref=ref, ref_results=ref_results)


def test_run_inference_with_keypoints_matches_jax(root, engine):
    got, (ref_boxes, _, ref_keyps) = engine.got, engine.ref
    n = _assert_results_match(got["all_boxes"], ref_boxes)
    assert n >= 3 * 8 * 0.75
    n_kps = 0
    for i in range(3):
        g, r = got["all_boxes"][1][i], ref_boxes[1][i]
        assert len(got["all_keyps"][1][i]) == len(g)
        for k in range(len(r)):
            m = int(np.abs(g[:, :4] - r[k, :4]).max(1).argmin())
            gk, rk = got["all_keyps"][1][i][m], ref_keyps[1][i][k]
            assert gk.shape == rk.shape == (4, 17)
            np.testing.assert_allclose(gk[:2], rk[:2], rtol=0, atol=1e-3)
            np.testing.assert_allclose(gk[2], rk[2], rtol=1e-4, atol=1e-5)
            n_kps += 1
    assert n_kps == n
    g = engine.got_results[VAL]
    r = engine.ref_results[VAL]
    assert list(g) == list(r) == ["box", "keypoint"]
    for task in ("box", "keypoint"):
        assert list(g[task]) == list(r[task])
        np.testing.assert_allclose(list(g[task].values()),
                                   list(r[task].values()), rtol=0,
                                   atol=1e-12)
    assert os.path.exists(root / "port_out" /
                          "keypoints_{}_results.json".format(VAL))


def test_im_detect_all_keypoints_match_batched_path(root, engine):
    """Without flags the host path finds the batched path's detections
    and keypoints (images at scale 1: TEST.SCALE is their short side);
    with Soft-NMS every box it keeps has its keypoints."""
    _set(root)
    roidb = JsonDataset(VAL).get_roidb(gt=True)
    params = test_engine.initialize_model_from_cfg(engine.args,
                                                   device="cpu")
    cpu = torch.device("cpu")
    for i, entry in enumerate(roidb):
        im = image_io.imread(entry["image"])
        cls_boxes, cls_segms, cls_keyps = port_test.im_detect_all(
            params, im, cpu)
        assert cls_segms is None and len(cls_keyps[1]) == len(cls_boxes[1])
        d = engine.got["all_boxes"][1][i]
        hs, ds = np.argsort(-cls_boxes[1][:, 4]), np.argsort(-d[:, 4])
        np.testing.assert_allclose(d[ds, :4], cls_boxes[1][hs, :4],
                                   rtol=1e-3, atol=0.05)
        got = np.stack(cls_keyps[1])[hs]
        ref = np.stack(engine.got["all_keyps"][1][i])[ds]
        np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0,
                                   atol=0.05)
    _set(root, ["TEST.SOFT_NMS.ENABLED", "True"])
    boxes, _, keyps = test_engine.test_net(params, roidb[:1], None,
                                           batch_size=2, device="cpu")
    assert len(keyps[1][0]) == len(boxes[1][0]) > 0
    assert keyps[1][0][0].shape == (4, 17)


def test_train_net_step_trains_keypoint_rcnn(root, tmp_path):
    """The trainer on the person set (--dataset keypoints_coco2017, with
    flips): finite losses, loss_kps among them, on every step, and a
    checkpoint that the JAX package reads as the model's tree."""
    from detectron_tpu.utils import net as jax_net
    from detectron_tpu_torch.parallel import optimizer as port_opt
    from detectron_tpu_torch.tools import train_net_step
    from test_torch_util import KPS_TRAIN_KEYS

    set_cfgs(mask_on=False, extra=KPS_TRAIN_KEYS + ENGINE_KEYS + [
        "DATA_DIR", str(root), "OUTPUT_DIR", str(tmp_path), "NUM_GPUS", "1",
        "SOLVER.BASE_LR", "0.002", "SOLVER.CLIP_GRADIENTS", "10",
        "SOLVER.MAX_ITER", "2", "TRAIN.USE_FLIPPED", "True"])
    run = train_net_step.main([
        "--dataset", "keypoints_coco2017", "--bs", "2", "--nw", "2",
        "--device", "cpu", "--disp_interval", "1"])
    assert len(run["stats"]) == 2
    for s in run["stats"]:
        assert "loss_kps" in s and np.isfinite(list(s.values())).all()
    tree = init.init_model(0)
    got = jax_net.load_ckpt_params(run["ckpt"])
    assert {p for p, _ in port_opt.flatten(got)} == \
        {p for p, _ in port_opt.flatten(tree)}
    assert "kps_head" in got


def test_im_detect_all_keypoints_every_box_past_the_limit(root, engine,
                                                          monkeypatch):
    """Boxes tied at the DETECTIONS_PER_IM limit all stay, so the host
    path can keep more than DETECTIONS_PER_IM boxes: each gets its
    keypoints (the JAX package's copy decodes the first
    DETECTIONS_PER_IM only). The limit is lifted inside
    box_results_with_nms_and_limit to make that case, with 64 proposals
    and a loose NMS."""
    _set(root, ["TEST.RPN_POST_NMS_TOP_N", "64", "TEST.NMS", "0.9"])
    entry = JsonDataset(VAL).get_roidb(gt=True)[2]
    params = test_engine.initialize_model_from_cfg(engine.args,
                                                   device="cpu")
    real = port_test.box_results_with_nms_and_limit

    def unlimited(scores, boxes):
        port_test.cfg.TEST.DETECTIONS_PER_IM = 0
        try:
            return real(scores, boxes)
        finally:
            port_test.cfg.TEST.DETECTIONS_PER_IM = 8

    monkeypatch.setattr(port_test, "box_results_with_nms_and_limit",
                        unlimited)
    cls_boxes, _, cls_keyps = port_test.im_detect_all(
        params, image_io.imread(entry["image"]), torch.device("cpu"))
    assert len(cls_boxes[1]) > 8
    assert len(cls_keyps[1]) == len(cls_boxes[1])
    assert all(np.isfinite(k).all() for k in cls_keyps[1])
