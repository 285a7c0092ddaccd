"""Test-time augmentation in the PyTorch port (core/test_aug.py, dispatched
by core/test.py::im_detect_all) against the JAX package's, on
tests/test_torch_test_engine.py's 96 x 128 PPM images and tiny inference
cfg, and tests/test_torch_keypoint_data.py's person images, with the
port's calibrated numpy init given to both packages.

- flip_boxes and aspect_ratio equal the JAX package's; the aspect-ratio
  warp (image_io.resize of the uint8 image, rounded) is within one level
  of cv2.resize's fixed-point uint8 result.
- im_detect_all with TEST.BBOX_AUG (H_FLIP, one extra scale of 64 at
  MAX_SIZE 96 and its flip, the aspect ratio 1.25 and its flip; UNION and
  AVG) and TEST.MASK_AUG (the same flips and scale; SOFT_AVG, SOFT_MAX,
  LOGIT_AVG) on two canvases (96 x 128 and 64 x 96): per class the same
  number of boxes, each JAX box matched by a port box with IoU > 0.99 and
  |score diff| < 1e-4, matched masks equal on >= 99.9% of the pixels. The
  JAX side's aspect-ratio pass is given the port's warped image (its
  cv2.resize differs by up to a level, tested above).
- Keypoint R-CNN with TEST.KPS_AUG (H_FLIP, the extra scale; HM_AVG and
  HM_MAX): the same boxes, keypoints within 1e-3 px and logits within
  1e-4 relative (tests/test_torch_keypoint_data.py's tolerances).
- The engine's path: run_inference with BBOX_AUG and MASK_AUG routes
  through test_net_im_detect_all, gives the landscape images the JAX
  im_detect_all's results, and ends in COCO box and segm AP.
- TTA enabled with no scale and no flip gives the plain im_detect_all's
  results bit for bit (boxes, RLEs, keypoints).
"""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.core import test_aug as jax_test_aug
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.utils import boxes as jax_boxes
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core import test_aug
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init
from detectron_tpu_torch.utils import boxes as port_boxes
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_keypoint_data import ENGINE_KEYS as KPS_ENGINE_KEYS
from test_torch_keypoint_data import _write_dataset as _write_kps_dataset
from test_torch_test_engine import TINY_INFER_KEYS, _iou
from test_torch_test_engine import _write_dataset
from test_torch_util import KPS_KEYS, jax_plain_paths, set_cfgs

torch.set_num_threads(2)
CPU = torch.device("cpu")

SCALE = ["SCALES", "(64,)", "MAX_SIZE", "96", "H_FLIP", "True",
         "SCALE_H_FLIP", "True"]
BBOX_AUG = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.ASPECT_RATIOS",
            "(1.25,)", "TEST.BBOX_AUG.ASPECT_RATIO_H_FLIP", "True"] + [
    "TEST.BBOX_AUG." + k if i % 2 == 0 else k for i, k in enumerate(SCALE)]
MASK_AUG = ["TEST.MASK_AUG.ENABLED", "True"] + [
    "TEST.MASK_AUG." + k if i % 2 == 0 else k for i, k in enumerate(SCALE)]
KPS_AUG = ["TEST.KPS_AUG.ENABLED", "True"] + [
    "TEST.KPS_AUG." + k if i % 2 == 0 else k for i, k in enumerate(SCALE)]


def test_box_helpers_and_the_warp_match_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (6, 2))
    boxes = np.tile(np.concatenate([xy, xy + 20], 1), (1, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(port_boxes.flip_boxes(boxes, 128),
                                  jax_boxes.flip_boxes(boxes, 128))
    np.testing.assert_array_equal(port_boxes.aspect_ratio(boxes, 0.8),
                                  jax_boxes.aspect_ratio(boxes, 0.8))
    im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    for ar in (1.25, 0.7):
        got = test_aug.aspect_ratio_rel(im, ar)
        ref = cv2.resize(im, (int(np.round(128 * ar)), 96))
        assert got.shape == ref.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref).max() <= 1


def _jax_fns():
    return {"detect_raw": jax.jit(jax_test.detect_raw),
            "mask_on_boxes": jax.jit(jax_test.mask_on_boxes_graph),
            "kps_on_boxes": jax.jit(jax_test.kps_on_boxes_graph)}


@pytest.fixture(scope="module")
def env(tmp_path_factory, monkeypatch_module):
    """The dataset, the calibrated tree, and JAX's graphs (compiled once
    per canvas; the TTA keys are host-side and reach no trace)."""
    root = tmp_path_factory.mktemp("tta")
    _write_dataset(root)
    set_cfgs(extra=TINY_INFER_KEYS + ["DATA_DIR", str(root)])
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    monkeypatch_module.setattr(jax_test_aug, "_aspect_ratio_rel",
                               test_aug.aspect_ratio_rel)
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)
    return types.SimpleNamespace(
        root=root, tree=tree, fns=_jax_fns(),
        ims=[image_io.imread(e["image"]) for e in roidb[::2]],
        ckpt=net.save_ckpt(str(root / "weights"), 0, tree))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _set(env, extra=()):
    set_cfgs(extra=TINY_INFER_KEYS + ["DATA_DIR", str(env.root)]
             + list(extra))
    jax_plain_paths()


def _match(got, ref, got_segms=None, ref_segms=None):
    """Per class: equal counts, every reference box matched; matched
    masks equal on >= 99.9% of the pixels. Returns the count."""
    n = 0
    for j in range(1, len(ref)):
        g, r = np.asarray(got[j]).reshape(-1, 5), \
            np.asarray(ref[j]).reshape(-1, 5)
        assert len(g) == len(r), j
        if not len(r):
            continue
        ok = ((_iou(r[:, :4], g[:, :4]) > 0.99)
              & (np.abs(r[:, None, 4] - g[None, :, 4]) < 1e-4))
        assert ok.any(1).all(), (j, g, r)
        n += len(r)
        if ref_segms is not None:
            for k, m in enumerate(ok.argmax(1)):
                gm = jax_rle.decode(got_segms[j][m])
                rm = jax_rle.decode(ref_segms[j][k])
                assert (gm == rm).mean() >= 0.999, (j, k)
    return n


@pytest.mark.parametrize("heur", [
    ("UNION", "SOFT_AVG"), ("AVG", "SOFT_MAX"), ("UNION", "LOGIT_AVG")],
    ids=lambda h: "-".join(h).lower())
def test_im_detect_all_with_bbox_and_mask_aug_matches_jax(env, heur):
    _set(env, BBOX_AUG + MASK_AUG + [
        "TEST.BBOX_AUG.SCORE_HEUR", heur[0], "TEST.BBOX_AUG.COORD_HEUR",
        heur[0], "TEST.MASK_AUG.HEUR", heur[1]])
    params = bridge.to_torch(env.tree, "cpu")
    jp = jax.tree.map(jnp.asarray, env.tree)
    im = env.ims[0]
    ref_boxes, ref_segms, _ = jax_test.im_detect_all(jp, im, env.fns)
    got_boxes, got_segms, _ = port_test.im_detect_all(params, im, CPU)
    assert _match(got_boxes, ref_boxes, got_segms, ref_segms) > 0


@pytest.fixture(scope="module")
def kps_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("tta_kps")
    _write_kps_dataset(root)
    set_cfgs(mask_on=False, extra=KPS_KEYS + KPS_ENGINE_KEYS)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    ims = [image_io.imread(str(p)) for p in sorted(
        (root / "coco" / "val2017").glob("*.ppm"))]
    return types.SimpleNamespace(tree=tree, ims=ims, fns=_jax_fns())


@pytest.mark.parametrize("heur", ["HM_AVG", "HM_MAX"])
def test_im_detect_all_with_kps_aug_matches_jax(kps_env, heur):
    set_cfgs(mask_on=False, extra=KPS_KEYS + KPS_ENGINE_KEYS + KPS_AUG + [
        "TEST.KPS_AUG.HEUR", heur])
    jax_plain_paths()
    params = bridge.to_torch(kps_env.tree, "cpu")
    jp = jax.tree.map(jnp.asarray, kps_env.tree)
    im = kps_env.ims[0]
    ref_boxes, _, ref_keyps = jax_test.im_detect_all(jp, im, kps_env.fns)
    got_boxes, _, got_keyps = port_test.im_detect_all(params, im, CPU)
    n = _match(got_boxes, ref_boxes)
    assert n > 0
    g, r = np.asarray(got_boxes[1]), np.asarray(ref_boxes[1])
    for k in range(len(r)):
        m = int(np.abs(g[:, :4] - r[k, :4]).max(1).argmin())
        gk, rk = got_keyps[1][m], ref_keyps[1][k]
        np.testing.assert_allclose(gk[:2], rk[:2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gk[2], rk[2], rtol=1e-4, atol=1e-5)


def test_run_inference_reaches_tta_and_evaluates(env, tmp_path):
    """test_net routes TTA through test_net_im_detect_all; the landscape
    images' results are JAX im_detect_all's, and COCO evaluation runs."""
    _set(env, BBOX_AUG + MASK_AUG)
    jp = jax.tree.map(jnp.asarray, env.tree)
    refs = [jax_test.im_detect_all(jp, im, env.fns) for im in env.ims]
    args = types.SimpleNamespace(load_ckpt=env.ckpt, load_detectron=None)
    results = test_engine.run_inference(
        args, dataset_name="coco_2017_val", output_dir=str(tmp_path),
        batch_size=2, device="cpu")
    assert {"box", "mask"} <= set(results["coco_2017_val"])
    with open(tmp_path / "detections.pkl", "rb") as f:
        import pickle
        dets = pickle.load(f)
    for i, (ref_boxes, ref_segms, _) in enumerate(refs):
        got_boxes = [cls[2 * i] for cls in dets["all_boxes"]]
        got_segms = [cls[2 * i] for cls in dets["all_segms"]]
        assert _match(got_boxes, ref_boxes, got_segms, ref_segms) > 0


@pytest.mark.parametrize("model", ["mask", "keypoint"])
def test_tta_without_passes_is_the_plain_path_bit_for_bit(env, kps_env,
                                                           model):
    if model == "mask":
        base, aug, tree, im = (TINY_INFER_KEYS, ["TEST.BBOX_AUG.ENABLED",
                               "True", "TEST.MASK_AUG.ENABLED", "True"],
                               env.tree, env.ims[0])
        mask_on = True
    else:
        base, aug, tree, im = (KPS_KEYS + KPS_ENGINE_KEYS,
                               ["TEST.KPS_AUG.ENABLED", "True"],
                               kps_env.tree, kps_env.ims[0])
        mask_on = False
    set_cfgs(mask_on=mask_on, extra=base)
    params = bridge.to_torch(tree, "cpu")
    plain = port_test.im_detect_all(params, im, CPU)
    set_cfgs(mask_on=mask_on, extra=base + aug)
    got = port_test.im_detect_all(params, im, CPU)
    n = 0
    for j in range(1, len(plain[0])):
        np.testing.assert_array_equal(got[0][j], plain[0][j])
        n += len(plain[0][j])
        if mask_on:
            assert got[1][j] == plain[1][j]
        else:
            for a, b in zip(got[2][j], plain[2][j]):
                np.testing.assert_array_equal(a, b)
    assert n > 0
