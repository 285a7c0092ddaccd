"""The port's dataset inference engine against the JAX package's, on a
4-image PPM dataset (96 x 128 and 128 x 96, both orientation buckets) with
tests/test_e2e_inference.py::_tiny_infer_cfg's keys on the RoIAlign ladder
(TPU.ROI_IMPL 'pallas', the default route; tests/test_torch_roi_routes.py
holds the 'windowed' route of that cfg), and the same weights:
the port's numpy init (models/init.py: the JAX package's tree, keys,
shapes and fills, from a numpy RandomState; the JAX init takes ~20 s
here), calibrated by calibrate_detector_params, written once with the
port's save_ckpt, and loaded by the JAX package's load_ckpt_params and
the port's initialize_model_from_cfg (--load_ckpt).

Pixels are PIXEL_MEANS + N(0, 1): with random weights and no trained BN
statistics, higher-contrast images saturate every score at 1.0 and the
order of ties decides which boxes survive.

Compared, with the tolerances of tests/test_torch_detect.py:
- run_inference (batched test_net, then COCO evaluation): per class and
  image the same number of detections, each JAX detection matched by a
  port detection with IoU > 0.99 and |score diff| < 1e-4; matched masks
  agree on >= 99.9% of the image's pixels; COCO box and segm stats equal
  (to 1e-12);
- the host path (test_net_im_detect_all) with TEST.SOFT_NMS and with
  TEST.BBOX_VOTE, as test_net routes them, the same way;
- TEST.PRECOMPUTED_PROPOSALS from a proposal file (Fast R-CNN mode, RPN
  off), the same way, on the landscape images.
The port alone: im_detect_all without flags against its batched test_net
(tests/test_e2e_inference.py's tolerances), ind_range, and the CLI in a
subprocess."""

import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from detectron_tpu.core import config as jax_config
from detectron_tpu.core import test_engine as jax_engine
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.data.json_dataset import JsonDataset as JaxJsonDataset
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.models import init
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(96, 128), (128, 96), (96, 128), (128, 96)]

# tests/test_e2e_inference.py::_tiny_infer_cfg's keys, less its
# TPU.ROI_IMPL 'windowed' / ROI_WINDOW / ROI_CHUNK (this file runs the
# default ladder).
TINY_INFER_KEYS = [
    "MODEL.CONV_BODY", "FPN.fpn_ResNet50_conv5_body",
    "MODEL.FASTER_RCNN", "True",
    "MODEL.NUM_CLASSES", "4",
    "FPN.FPN_ON", "True",
    "FPN.MULTILEVEL_ROIS", "True",
    "FPN.MULTILEVEL_RPN", "True",
    "FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_2mlp_head",
    "FAST_RCNN.ROI_XFORM_METHOD", "RoIAlign",
    "FAST_RCNN.ROI_XFORM_RESOLUTION", "7",
    "FAST_RCNN.ROI_XFORM_SAMPLING_RATIO", "2",
    "FAST_RCNN.MLP_HEAD_DIM", "32",
    "MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs",
    "MRCNN.RESOLUTION", "14",
    "MRCNN.ROI_XFORM_RESOLUTION", "7",
    "MRCNN.ROI_XFORM_SAMPLING_RATIO", "2",
    "MRCNN.DILATION", "1",
    "TEST.SCALE", "96",
    "TEST.MAX_SIZE", "128",
    "TEST.RPN_PRE_NMS_TOP_N", "64",
    "TEST.RPN_POST_NMS_TOP_N", "16",
    "TEST.DETECTIONS_PER_IM", "8",
    "TEST.SCORE_THRESH", "0.0",
    "TPU.NMS_TILE_SIZE", "32",
    "TEST.DATASETS", "('coco_2017_val',)",
]
PROPOSAL_KEYS = ["MODEL.MASK_ON", "False",
                 "MODEL.FASTER_RCNN", "False",
                 "TEST.PRECOMPUTED_PROPOSALS", "True",
                 "TEST.PROPOSAL_LIMIT", "8"]
SOFT_NMS = ["TEST.SOFT_NMS.ENABLED", "True", "TEST.SOFT_NMS.METHOD",
            "gaussian"]
BBOX_VOTE = ["TEST.BBOX_VOTE.ENABLED", "True",
             "TEST.BBOX_VOTE.SCORING_METHOD", "IOU_AVG"]


def _set(config, root, mask_on=True, extra=()):
    """Reset `config` (either package's) to the tiny inference cfg."""
    config.reset_cfg()
    config.merge_cfg_from_list(
        TINY_INFER_KEYS + ["MODEL.MASK_ON", str(mask_on),
                           "DATA_DIR", str(root)] + list(extra))
    if "TEST.PRECOMPUTED_PROPOSALS" in extra:
        config.cfg.RPN.RPN_ON = False
    config.assert_and_infer_cfg(make_immutable=False)


def _write_dataset(root):
    img_dir = root / "coco" / "val2017"
    img_dir.mkdir(parents=True)
    (root / "coco" / "annotations").mkdir()
    rng = np.random.RandomState(0)
    means = np.array([102.9801, 115.9465, 122.7717])
    images, anns, props = [], [], {"ids": [], "boxes": []}
    for i, (h, w) in enumerate(SIZES):
        name = "{:012d}.ppm".format(i + 1)
        im = np.clip(np.round(means + rng.randn(h, w, 3)), 0, 255)
        image_io.write_ppm(str(img_dir / name), im.astype(np.uint8))
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": name})
        for k in range(3):
            bw, bh = rng.uniform(12, w / 2), rng.uniform(12, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({
                "id": len(anns) + 1, "image_id": i + 1,
                "category_id": 1 + k, "bbox": [x, y, bw, bh],
                "area": bw * bh, "iscrowd": 0,
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh,
                                  x, y + bh]]})
        xy = rng.uniform(0, min(h, w) / 2, (12, 2))
        props["ids"].append(i + 1)
        props["boxes"].append(np.concatenate(
            [xy, xy + rng.uniform(8, min(h, w) / 2, (12, 2))], 1).astype(
                np.float32))
    cats = [{"id": c, "name": n, "supercategory": "thing"}
            for c, n in ((1, "widget"), (2, "gadget"), (3, "sprocket"))]
    (root / "coco" / "annotations" / "instances_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns,
                    "categories": cats}))
    with open(root / "props.pkl", "wb") as f:
        pickle.dump(props, f)


def _load(out_dir, name="detections.pkl"):
    with open(os.path.join(out_dir, name), "rb") as f:
        return pickle.load(f)


def _jax_run(tree, out_dir):
    """The JAX package's run_inference on a given params tree: its
    JsonDataset, test_net, and evaluate_all (its own run_inference would
    draw its own init before loading the checkpoint)."""
    from detectron_tpu.data import task_evaluation

    ds = JaxJsonDataset("coco_2017_val")
    roidb = ds.get_roidb(gt=True)
    dets = jax_engine.test_net(tree, roidb, ds, batch_size=2,
                               output_dir=out_dir)
    return task_evaluation.evaluate_all(ds, *dets, out_dir), _load(out_dir)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The dataset, the checkpoint, and every JAX-side run (compiled once
    per graph and canvas shape)."""
    from detectron_tpu.utils import net as jax_net

    root = tmp_path_factory.mktemp("engine")
    _write_dataset(root)
    _set(port_config, root)
    ckpt = net.save_ckpt(str(root / "train"), 0, calibrate_detector_params(
        init.init_model(0), np.random.RandomState(0)))
    args = types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None)
    tree = jax_net.load_ckpt_params(ckpt)

    _set(jax_config, root)
    ref = {}
    ref["results"], ref["dets"] = _jax_run(tree, str(root / "jax_out"))

    # The host path on the two landscape images, one compile per graph:
    # detect_raw and mask_on_boxes_graph read no Soft-NMS or voting key.
    roidb = JaxJsonDataset("coco_2017_val").get_roidb(gt=True)[::2]
    for name, keys in (("soft_nms", SOFT_NMS), ("bbox_vote", BBOX_VOTE)):
        jax_config.merge_cfg_from_list(keys)
        ref[name] = jax_engine.test_net(tree, roidb, None, batch_size=2)
        jax_config.merge_cfg_from_list([keys[0], "False"])

    # Precomputed proposals on the landscape images (one compile).
    props = str(root / "props.pkl")
    _set(jax_config, root, mask_on=False, extra=PROPOSAL_KEYS)
    roidb = JaxJsonDataset("coco_2017_val").get_roidb(
        gt=True, proposal_file=props, proposal_limit=8)[::2]
    ref["props"] = jax_engine.test_net(tree, roidb, None, batch_size=2)
    return types.SimpleNamespace(root=root, ckpt=ckpt, args=args, ref=ref)


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt + 1, 0, None).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2] + 1).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _assert_results_match(got_boxes, ref_boxes, got_segms=None,
                          ref_segms=None, iou=0.99, score_tol=1e-4):
    """Per class and image: equal counts, every reference detection
    matched (IoU, |score diff|); matched masks agree on >= 99.9% of the
    image's pixels. Returns the number of detections compared."""
    assert len(got_boxes) == len(ref_boxes)
    n = 0
    for j in range(1, len(ref_boxes)):
        assert len(got_boxes[j]) == len(ref_boxes[j])
        for i, (g, r) in enumerate(zip(got_boxes[j], ref_boxes[j])):
            g, r = np.asarray(g).reshape(-1, 5), np.asarray(r).reshape(-1, 5)
            assert len(g) == len(r), (j, i)
            if not len(r):
                continue
            ok = ((_iou(r[:, :4], g[:, :4]) > iou)
                  & (np.abs(r[:, None, 4] - g[None, :, 4]) < score_tol))
            assert ok.any(1).all(), (j, i, g, r)
            n += len(r)
            if ref_segms is not None:
                for k, m in enumerate(ok.argmax(1)):
                    gm = jax_rle.decode(got_segms[j][i][m])
                    rm = jax_rle.decode(ref_segms[j][i][k])
                    assert (gm == rm).mean() >= 0.999, (j, i, k)
    return n


def _scores(all_boxes):
    return np.concatenate([np.asarray(b).reshape(-1, 5)[:, 4]
                           for cls in all_boxes[1:] for b in cls])


def test_run_inference_matches_jax(env, tmp_path):
    _set(port_config, env.root)
    out = str(tmp_path / "out")
    results = test_engine.run_inference(
        env.args, dataset_name="coco_2017_val", output_dir=out,
        batch_size=2, device="cpu")
    got = _load(out)
    ref = env.ref["dets"]
    n = _assert_results_match(got["all_boxes"], ref["all_boxes"],
                              got["all_segms"], ref["all_segms"])
    assert n >= 4 * 8 * 0.75  # most of the D = 8 slots hold a detection
    scores = _scores(got["all_boxes"])
    assert len(np.unique(scores)) > 0.9 * len(scores)  # no tied scores
    for task in ("box", "mask"):
        g = results["coco_2017_val"][task]
        r = env.ref["results"]["coco_2017_val"][task]
        assert list(g) == list(r)
        np.testing.assert_allclose(list(g.values()), list(r.values()),
                                   rtol=0, atol=1e-12)
    for name in ("bbox", "segm"):
        assert os.path.exists(os.path.join(
            out, "{}_coco_2017_val_results.json".format(name)))


@pytest.mark.parametrize("flag", ["soft_nms", "bbox_vote"])
def test_flagged_host_path_matches_jax(env, flag):
    """test_net routes TEST.SOFT_NMS / TEST.BBOX_VOTE through
    test_net_im_detect_all (detect_raw, host NMS, mask_on_boxes_graph)."""
    _set(port_config, env.root,
         extra=SOFT_NMS if flag == "soft_nms" else BBOX_VOTE)
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)[::2]
    params = test_engine.initialize_model_from_cfg(env.args, device="cpu")
    got = test_engine.test_net(params, roidb, None, batch_size=2,
                               device="cpu")
    ref = env.ref[flag]
    n = _assert_results_match(got[0], ref[0], got[1], ref[1])
    assert n > 0
    # The flag changed the result: not the batched (hard NMS) detections.
    hard = [cls[::2] for cls in env.ref["dets"]["all_boxes"]]
    assert sorted(_scores(got[0])) != sorted(_scores(hard))


def test_im_detect_all_matches_batched_path(env):
    """Without flags, im_detect_all (host NMS in numpy) finds the batched
    path's detections (device NMS), within tests/test_e2e_inference.py's
    tolerances (rtol 1e-4 / atol 1e-5 scores, rtol 1e-3 / atol 0.05
    boxes). The images are at scale 1 (short side TEST.SCALE = 96), where
    the host's image coordinates are the device's scaled ones: with the
    +1 box convention an IoU near TEST.NMS may differ between the two."""
    _set(port_config, env.root)
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)
    params = test_engine.initialize_model_from_cfg(env.args, device="cpu")
    batched = test_engine.test_net(params, roidb, None, batch_size=2,
                                   device="cpu")[0]
    for i, entry in enumerate(roidb):
        cls_boxes, cls_segms, _ = port_test.im_detect_all(
            params, image_io.imread(entry["image"]), torch.device("cpu"))
        assert sum(len(s) for s in cls_segms) == \
            sum(len(b) for b in cls_boxes[1:])
        h = np.concatenate([b for b in cls_boxes[1:] if len(b)])
        d = np.concatenate([batched[j][i] for j in range(1, 4)])
        assert len(h) == len(d) > 0
        hs, ds = np.argsort(-h[:, 4]), np.argsort(-d[:, 4])
        np.testing.assert_allclose(d[ds, 4], h[hs, 4], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(d[ds, :4], h[hs, :4], rtol=1e-3,
                                   atol=0.05)


def test_im_detect_all_masks_every_box_past_the_limit(env, monkeypatch):
    """Boxes tied at the DETECTIONS_PER_IM limit all stay, so the host
    path can return more than DETECTIONS_PER_IM boxes: each gets its own
    mask, the same as the first DETECTIONS_PER_IM get. Here the limit is
    lifted (0) inside box_results_with_nms_and_limit to make that case."""
    _set(port_config, env.root)
    entry = JsonDataset("coco_2017_val").get_roidb(gt=True)[0]
    im = image_io.imread(entry["image"])
    params = test_engine.initialize_model_from_cfg(env.args, device="cpu")
    cpu = torch.device("cpu")
    limited = port_test.im_detect_all(params, im, cpu)
    real = port_test.box_results_with_nms_and_limit

    def unlimited(scores, boxes):
        port_config.cfg.TEST.DETECTIONS_PER_IM = 0
        try:
            return real(scores, boxes)
        finally:
            port_config.cfg.TEST.DETECTIONS_PER_IM = 8

    monkeypatch.setattr(port_test, "box_results_with_nms_and_limit",
                        unlimited)
    cls_boxes, cls_segms, _ = port_test.im_detect_all(params, im, cpu)
    assert sum(len(b) for b in cls_boxes[1:]) > 2 * 8
    for j in range(1, 4):
        assert len(cls_segms[j]) == len(cls_boxes[j])
        # The limited run's boxes are the top of this one's, with the
        # same masks.
        k = len(limited[0][j])
        np.testing.assert_array_equal(cls_boxes[j][:k], limited[0][j])
        assert cls_segms[j][:k] == limited[1][j]


def test_precomputed_proposals_match_jax(env, tmp_path):
    _set(port_config, env.root, mask_on=False,
         extra=PROPOSAL_KEYS + ["TEST.PROPOSAL_FILES",
                                "('{}',)".format(env.root / "props.pkl")])
    out = str(tmp_path / "out")
    results = test_engine.run_inference(
        env.args, dataset_name="coco_2017_val", output_dir=out,
        batch_size=2, device="cpu")
    assert list(results["coco_2017_val"]) == ["box"]
    got = [cls[::2] for cls in _load(out)["all_boxes"]]
    assert _assert_results_match(got, env.ref["props"][0]) > 0


def test_ind_range_writes_its_range(env, tmp_path):
    """--range [1, 3): detection_range_1_3.pkl with the full run's
    detections of images 1 and 2 (batched on their own), no evaluation."""
    _set(port_config, env.root)
    out = str(tmp_path / "out")
    assert test_engine.run_inference(
        env.args, dataset_name="coco_2017_val", output_dir=out,
        batch_size=2, ind_range=(1, 3), device="cpu") is None
    got = _load(out, "detection_range_1_3.pkl")
    assert (got["start"], got["end"]) == (1, 3)
    assert not os.path.exists(os.path.join(out, "detections.pkl"))
    ref = env.ref["dets"]
    _assert_results_match(
        got["all_boxes"], [cls[1:3] for cls in ref["all_boxes"]],
        got["all_segms"], [cls[1:3] for cls in ref["all_segms"]])
    with pytest.raises(ValueError):
        test_engine.run_inference(env.args, dataset_name="coco_2017_val",
                                  ind_range=(3, 9), device="cpu")


def test_cli_writes_detections(env, tmp_path):
    """python -m detectron_tpu_torch.tools.test_net --device cpu, with the
    cfg in a yaml file and the checkpoint's weights, given as --load_ckpt
    and as a Detectron .pkl (--load_detectron)."""
    yaml = tmp_path / "tiny.yaml"
    keys = TINY_INFER_KEYS + ["MODEL.MASK_ON", "True", "DATA_DIR",
                              str(env.root)]
    lines, d = [], {}
    for k, v in zip(keys[::2], keys[1::2]):
        d.setdefault(k.split(".")[0], {})
        if "." in k:
            d[k.split(".")[0]][k.split(".", 1)[1]] = v
        else:
            d[k] = v
    for top, v in d.items():
        if isinstance(v, dict):
            lines.append(top + ":")
            lines += ["  {}: {}".format(k, x) for k, x in v.items()]
        else:
            lines.append("{}: {}".format(top, v))
    yaml.write_text("\n".join(lines) + "\n")
    out = tmp_path / "cli_out"
    env_vars = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "detectron_tpu_torch.tools.test_net",
         "--cfg", str(yaml), "--load_ckpt", env.ckpt, "--output_dir",
         str(out), "--batch_size", "2", "--device", "cpu"],
        cwd=str(tmp_path), env=env_vars, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "copypaste: Task: mask" in proc.stdout
    got = _load(str(out))
    _assert_results_match(got["all_boxes"], env.ref["dets"]["all_boxes"])
    # --load_detectron: the same weights as a Detectron .pkl (Caffe2
    # layouts) give the same detections.
    _set(port_config, env.root)
    with open(tmp_path / "model.pkl", "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(
            net.load_ckpt_params(env.ckpt))}, f)
    out_pkl = tmp_path / "cli_out_pkl"
    proc = subprocess.run(
        [sys.executable, "-m", "detectron_tpu_torch.tools.test_net",
         "--cfg", str(yaml), "--output_dir", str(out_pkl), "--batch_size",
         "2", "--device", "cpu", "--load_detectron", "model.pkl"],
        cwd=str(tmp_path), env=env_vars, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    _assert_results_match(_load(str(out_pkl))["all_boxes"],
                          env.ref["dets"]["all_boxes"])
