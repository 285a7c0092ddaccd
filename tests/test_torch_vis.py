"""The port's visualization and demo helpers against the JAX package's, on
the same seeded inputs, exactly: colormap, the COCO dummy dataset,
kp_connections, get_class_string, utils/env's output dirs, the arrays
vis_one_image_opencv draws (boxes, classes, RLE masks and keypoints,
bit for bit), and the PNG vis_one_image writes with matplotlib's Agg
backend (decoded pixels; PDFs carry a timestamp)."""

import cv2
import numpy as np
import pytest

from detectron_tpu.core import config as jax_config
from detectron_tpu.data import dummy_datasets as jax_dummy
from detectron_tpu.utils import env as jax_env
from detectron_tpu.utils import vis as jax_vis
from detectron_tpu.utils.colormap import colormap as jax_colormap
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.data import dummy_datasets
from detectron_tpu_torch.data import rle
from detectron_tpu_torch.utils import env
from detectron_tpu_torch.utils import keypoints as keypoint_utils
from detectron_tpu_torch.utils import vis
from detectron_tpu_torch.utils.colormap import colormap

H, W, C = 120, 160, 4


@pytest.mark.parametrize("rgb", [False, True])
def test_colormap_equals_jax(rgb):
    got, ref = colormap(rgb), jax_colormap(rgb)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_dummy_dataset_names_and_class_strings_equal_jax():
    got, ref = dummy_datasets.get_coco_dataset(), jax_dummy.get_coco_dataset()
    assert got == ref and got.classes == ref.classes
    assert len(got.classes) == 81
    names, _ = keypoint_utils.get_keypoints()
    assert vis.kp_connections(names) == jax_vis.kp_connections(names)
    for cls, score in [(1, 0.987), (80, 0.05), (17, 1.0), (3, 0.5049)]:
        for ds in (got, None):
            assert vis.get_class_string(cls, score, ds) == \
                jax_vis.get_class_string(cls, score, ds)


@pytest.mark.parametrize("run_name,training", [
    (None, True), ("Oct17-10-00-00_host", True), (None, False)])
def test_output_dir_equals_jax(run_name, training):
    saved = [c.cfg.OUTPUT_DIR for c in (port_config, jax_config)]
    try:
        for c in (port_config, jax_config):
            c.merge_cfg_from_list(["OUTPUT_DIR", "/tmp/outs"])
        for cfg_file in (None,
                         "configs/baselines/e2e_mask_rcnn_R-50-FPN_1x.yaml"):
            assert env.get_output_dir(cfg_file, run_name, training) == \
                jax_env.get_output_dir(cfg_file, run_name, training)
    finally:
        for c, v in zip((port_config, jax_config), saved):
            c.merge_cfg_from_list(["OUTPUT_DIR", v])
    assert env.get_run_name().endswith("_" + jax_env.get_run_name().split(
        "_", 1)[1])


def _detections(seed=0):
    """Seeded cls-format results: per class (n, 5) boxes, one RLE mask and
    one (4, 17) keypoint array per box; scores spread over [0.3, 1)."""
    rng = np.random.RandomState(seed)
    names, _ = keypoint_utils.get_keypoints()
    cls_boxes, cls_segms, cls_keyps = [np.zeros((0, 5), np.float32)], [[]], \
        [[]]
    for _ in range(1, C):
        n = rng.randint(1, 4)
        xy = rng.uniform(0, [W - 40, H - 40], (n, 2))
        wh = rng.uniform(12, 40, (n, 2))
        s = rng.uniform(0.3, 1.0, n)
        cls_boxes.append(np.hstack([xy, xy + wh, s[:, None]]).astype(
            np.float32))
        segms, keyps = [], []
        for b in cls_boxes[-1]:
            m = np.zeros((H, W), np.uint8)
            x0, y0, x1, y1 = b[:4].astype(int)
            m[y0:y1, x0:x1] = rng.rand(y1 - y0, x1 - x0) < 0.8
            segms.append(rle.encode(m))
            kps = np.zeros((4, len(names)), np.float32)
            kps[0] = rng.uniform(b[0], b[2], len(names))
            kps[1] = rng.uniform(b[1], b[3], len(names))
            kps[2] = rng.uniform(-1, 6, len(names))
            kps[3] = rng.rand(len(names))
            keyps.append(kps)
        cls_segms.append(segms)
        cls_keyps.append(keyps)
    im = rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
    return im, cls_boxes, cls_segms, cls_keyps


@pytest.mark.parametrize("kwargs", [
    dict(thresh=0.5, show_box=True, show_class=True),
    dict(thresh=0.0, show_box=False, show_class=True, kp_thresh=1),
    dict(thresh=0.9)])
def test_vis_one_image_opencv_equals_jax(kwargs):
    im, boxes, segms, keyps = _detections()
    ds = dummy_datasets.get_coco_dataset()
    got = vis.vis_one_image_opencv(im.copy(), boxes, segms, keyps,
                                   dataset=ds, **kwargs)
    ref = jax_vis.vis_one_image_opencv(im.copy(), boxes, segms, keyps,
                                       dataset=ds, **kwargs)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert (got != im).any()


def test_vis_one_image_png_equals_jax(tmp_path):
    im, boxes, segms, keyps = _detections(1)
    ds = dummy_datasets.get_coco_dataset()
    for mod, sub in ((vis, "port"), (jax_vis, "jax")):
        mod.vis_one_image(im, "im1", str(tmp_path / sub), boxes, segms,
                          keyps, thresh=0.4, dataset=ds, show_class=True,
                          ext="png", dpi=100)
    got = cv2.imread(str(tmp_path / "port" / "im1.png"))
    ref = cv2.imread(str(tmp_path / "jax" / "im1.png"))
    assert got is not None and got.shape == ref.shape == (H, W, 3)
    np.testing.assert_array_equal(got, ref)
    # Below the threshold nothing is drawn and no file is written.
    vis.vis_one_image(im, "none", str(tmp_path / "port"), boxes, segms,
                      keyps, thresh=1.5, ext="png")
    assert not (tmp_path / "port" / "none.png").exists()
