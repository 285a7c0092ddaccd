"""Shared set-up of the PyTorch port's parity tests: both packages' cfgs set
from one list of keys (the port has a cfg object of its own), the port's
freedom from the JAX package, and that cfg separation."""

import re
from pathlib import Path

import numpy as np
import pytest

from __graft_entry__ import _tiny_cfg
from detectron_tpu.core import config as jax_config
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core.configs_presets import (
    keypoint_rcnn_r50_fpn_keys, mask_rcnn_r50_fpn)

ROOT = Path(__file__).resolve().parents[1]

# __graft_entry__._tiny_cfg's keys after the mask_rcnn_r50_fpn preset: a
# 256 x 320 canvas, 64 post-NMS RoIs, D = 20.
TINY_KEYS = [
    "TRAIN.BATCH_SIZE_PER_IM", "64",
    "TRAIN.RPN_PRE_NMS_TOP_N", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.RPN_BATCH_SIZE_PER_IM", "64",
    "TEST.RPN_PRE_NMS_TOP_N", "256",
    "TEST.RPN_POST_NMS_TOP_N", "64",
    "TEST.DETECTIONS_PER_IM", "20",
    "TPU.NMS_TILE_SIZE", "64",
    "TPU.MAX_GT_BOXES", "8",
]

# A tiny training step on top of TINY_KEYS, as tests/test_train_step.py's
# _tiny_train_cfg: 4 classes, a 32-wide MLP head, 32 RoIs and 32 anchors
# per image, RPN 64 -> 16 (the compacted NMS form), mask head 7 -> 14.
TRAIN_KEYS = [
    "MODEL.NUM_CLASSES", "4",
    "FAST_RCNN.MLP_HEAD_DIM", "32",
    "MRCNN.RESOLUTION", "14",
    "MRCNN.ROI_XFORM_RESOLUTION", "7",
    "MRCNN.DIM_REDUCED", "32",
    "TRAIN.BATCH_SIZE_PER_IM", "32",
    "TRAIN.RPN_PRE_NMS_TOP_N", "64",
    "TRAIN.RPN_POST_NMS_TOP_N", "16",
    "TRAIN.RPN_BATCH_SIZE_PER_IM", "32",
    "SOLVER.BASE_LR", "0.01",
    "SOLVER.WARM_UP_ITERS", "2",
    "SOLVER.STEPS", "[0, 100]",
    "SOLVER.MAX_ITER", "200",
]


# Keypoint R-CNN at the tiny sizes: the keypoint_rcnn_r50_fpn preset's keys,
# TINY_KEYS again (the preset sets its own RPN and RoI counts), then
# tests/test_keypoints.py's tiny head: 2 stacked 3x3 convs of 32 channels
# on 7 x 7 RoI features, 28 x 28 heatmaps, and a 32-wide box head.
KPS_KEYS = keypoint_rcnn_r50_fpn_keys() + TINY_KEYS + [
    "FAST_RCNN.MLP_HEAD_DIM", "32",
    "KRCNN.NUM_STACKED_CONVS", "2",
    "KRCNN.CONV_HEAD_DIM", "32",
    "KRCNN.ROI_XFORM_RESOLUTION", "7",
    "KRCNN.HEATMAP_SIZE", "28",
]

# The tiny keypoint training step: KPS_KEYS, then TRAIN_KEYS less its
# MODEL.NUM_CLASSES (the person class stays the only one).
assert TRAIN_KEYS[0] == "MODEL.NUM_CLASSES"
KPS_TRAIN_KEYS = KPS_KEYS + TRAIN_KEYS[2:]


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k not in ("ROOT_DIR", "DATA_DIR"):
                _same(a[k], b[k], path + "." + k)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def set_cfgs(mask_on=True, batch=2, extra=()):
    """Reset both cfgs and apply, to each, the mask_rcnn_r50_fpn preset,
    _tiny_cfg's keys (MODEL.MASK_ON and TRAIN.IMS_PER_BATCH from the
    arguments), then `extra`, in the same order; assert the two agree."""
    _tiny_cfg(mask_on=mask_on, batch=batch)
    jax_config.merge_cfg_from_list(list(extra))
    jax_config.assert_and_infer_cfg(make_immutable=False)

    port_config.reset_cfg()
    mask_rcnn_r50_fpn()
    port_config.merge_cfg_from_list(
        ["MODEL.MASK_ON", str(mask_on), "TRAIN.IMS_PER_BATCH", str(batch)]
        + TINY_KEYS)
    port_config.assert_and_infer_cfg(make_immutable=False)
    port_config.merge_cfg_from_list(list(extra))
    port_config.assert_and_infer_cfg(make_immutable=False)
    _same(dict(port_config.cfg), dict(jax_config.cfg))


@pytest.mark.parametrize("extra", [(), ["TPU.COMPUTE_DTYPE", "bfloat16"],
                                   TRAIN_KEYS, KPS_KEYS, KPS_TRAIN_KEYS])
def test_set_cfgs_gives_both_packages_one_cfg(extra):
    set_cfgs(extra=extra)
    assert port_config.cfg.TRAIN.RPN_POST_NMS_TOP_N == \
        jax_config.cfg.TRAIN.RPN_POST_NMS_TOP_N


def test_port_cfg_is_its_own():
    """Merging a key into the port's cfg leaves the JAX package's as it
    is, and the other way round."""
    set_cfgs()
    port_config.merge_cfg_from_list(["TPU.COMPUTE_DTYPE", "bfloat16",
                                     "MODEL.NUM_CLASSES", "7"])
    assert jax_config.cfg.TPU.COMPUTE_DTYPE == "float32"
    assert jax_config.cfg.MODEL.NUM_CLASSES == 81
    jax_config.merge_cfg_from_list(["TEST.DETECTIONS_PER_IM", "5"])
    assert port_config.cfg.TEST.DETECTIONS_PER_IM == 20
    assert port_config.cfg is not jax_config.cfg


_IMPORT = re.compile(r"^\s*(import\s+detectron_tpu(\s|\.|,|$)"
                     r"|from\s+detectron_tpu(\s|\.)|import\s+jax\b"
                     r"|from\s+jax\b)", re.M)


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "detectron_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = ["{}:{}".format(f.relative_to(ROOT), m.group(0).strip())
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits
