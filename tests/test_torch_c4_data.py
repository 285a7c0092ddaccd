"""R-50-C4 through the port's dataset engine, trainer and weight loaders,
against the JAX package on the CPU:

- run_inference (batched test_net, COCO evaluation) of Mask R-CNN C4
  (v0upshare) on tests/test_torch_test_engine.py's 4-image PPM set, with
  the port's numpy init (calibrated, cls_score's weights x 0.1 so that the
  scores do not saturate) written as one checkpoint that both packages
  load: the same detections.pkl boxes and masks
  (test_torch_test_engine.py's matching) and the same COCO box and mask
  AP; and the port's im_detect_all (the mask head on the host path's
  boxes, res5 shared) against its batched path;
- two CPU steps of `train_net_step --cfg
  configs/baselines/e2e_mask_rcnn_R-50-C4_1x.yaml` at the tiny sizes:
  finite losses with loss_mask, and a checkpoint that the JAX package
  reads as the C4 tree;
- the ImageNet loaders' fill of a C4 model's res5 heads (ROADMAP Queue C):
  from an ImageNet .pkl (res5_* blobs) and .pth (layer4.*), the port puts
  ImageNet's res5 into box_head.res5 (and mask_head.res5 under v0up),
  while the JAX package's loader leaves it at its init; the body loads as
  in JAX;
- the Detectron .pkl round trip of the C4 tree as in JAX (MASK_ON on and
  off), and under v0up the mask head's own res5 from Detectron's
  "_[mask]_res5" blobs;
- masks pasted at the original image size when the engine scales an
  image down (ROADMAP Queue C: the JAX engine's size rule is off by a
  pixel there).
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from detectron_tpu.core import config as jax_config
from detectron_tpu.utils import detectron_weight_helper as jax_dwh
from detectron_tpu.utils import net as jax_net
from detectron_tpu.utils import resnet_weights_helper as jax_rwh
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_c4_keys
from detectron_tpu_torch.data.json_dataset import JsonDataset
from detectron_tpu_torch.models import init
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.tools import train_net_step
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils import resnet_weights_helper as rwh
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_test_engine import (_assert_results_match, _jax_run, _load,
                                    _scores, _write_dataset)
from test_torch_train_data import write_train_set
from test_torch_util import C4_KEYS, FASTER_C4_KEYS, set_cfgs
from test_torch_weight_import import (_assert_trees_equal, _random_blobs,
                                      _state_dict, _write_pkl)

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C4_YAML = os.path.join(ROOT, "configs", "baselines",
                       "e2e_mask_rcnn_R-50-C4_1x.yaml")

# test_torch_test_engine.py's tiny inference sizes on the C4 preset.
C4_INFER_KEYS = mask_rcnn_r50_c4_keys() + [
    "MODEL.NUM_CLASSES", "4",
    "MRCNN.DIM_REDUCED", "32",
    "TEST.SCALE", "96",
    "TEST.MAX_SIZE", "128",
    "TEST.RPN_PRE_NMS_TOP_N", "64",
    "TEST.RPN_POST_NMS_TOP_N", "16",
    "TEST.DETECTIONS_PER_IM", "8",
    "TEST.SCORE_THRESH", "0.0",
    "TPU.NMS_TILE_SIZE", "32",
    "TEST.DATASETS", "('coco_2017_val',)",
]


def _set(config, root):
    config.reset_cfg()
    config.merge_cfg_from_list(C4_INFER_KEYS + ["DATA_DIR", str(root)])
    config.assert_and_infer_cfg(make_immutable=False)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The dataset, one checkpoint of calibrated C4 weights, and the JAX
    engine's run on it."""
    root = tmp_path_factory.mktemp("c4_engine")
    _write_dataset(root)
    _set(port_config, root)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    # The res5 head's features reach ~200 on these images under random
    # weights, which saturates every score at 1.0 (ties then decide which
    # boxes survive): cls_score's weights x 0.1 spread them.
    tree["box_outs"]["cls_score"]["w"] *= 0.1
    ckpt = net.save_ckpt(str(root / "train"), 0, tree)
    _set(jax_config, root)
    results, dets = _jax_run(jax_net.load_ckpt_params(ckpt),
                             str(root / "jax_out"))
    return types.SimpleNamespace(
        root=root, results=results, dets=dets,
        args=types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None))


def test_c4_run_inference_matches_jax(env, tmp_path):
    _set(port_config, env.root)
    out = str(tmp_path / "out")
    results = test_engine.run_inference(
        env.args, dataset_name="coco_2017_val", output_dir=out,
        batch_size=2, device="cpu")
    got = _load(out)
    n = _assert_results_match(got["all_boxes"], env.dets["all_boxes"],
                              got["all_segms"], env.dets["all_segms"])
    assert n >= 4 * 8 * 0.75
    scores = _scores(got["all_boxes"])
    assert len(np.unique(scores)) > 0.9 * len(scores)
    for task in ("box", "mask"):
        g = results["coco_2017_val"][task]
        r = env.results["coco_2017_val"][task]
        assert list(g) == list(r)
        np.testing.assert_allclose(list(g.values()), list(r.values()),
                                   rtol=0, atol=1e-12)


def test_c4_im_detect_all_matches_batched_path(env):
    """The host path (detect_raw, numpy NMS, mask_on_boxes_graph with the
    shared res5) against the batched path, at scale 1, with
    test_torch_test_engine.py's tolerances."""
    _set(port_config, env.root)
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)
    params = test_engine.initialize_model_from_cfg(env.args, device="cpu")
    batched, segms = test_engine.test_net(params, roidb, None, batch_size=2,
                                          device="cpu")[:2]
    for i, entry in enumerate(roidb):
        cls_boxes, cls_segms, _ = port_test.im_detect_all(
            params, image_io.imread(entry["image"]), torch.device("cpu"))
        _assert_results_match([[b] for b in cls_boxes],
                              [[batched[j][i]] for j in range(4)],
                              [[s] for s in cls_segms],
                              [[segms[j][i]] for j in range(4)])


def test_engine_pastes_masks_at_the_original_image_size(env, tmp_path):
    """Scaled down (TEST.SCALE 29 on 96 x 128 images: scale 0.302), the
    scaled size over the scale, rounded, is 96 x 129, not the image's 96 x
    128: the JAX engine (test_engine.py:130-131) pastes masks into that
    size, and COCO's segm evaluation then fails on RLEs of two sizes. The
    port pastes them into the roidb entry's size, and evaluates."""
    from detectron_tpu_torch.utils import blob as blob_utils

    _set(port_config, env.root)
    port_config.merge_cfg_from_list(["TEST.SCALE", "29", "TEST.MAX_SIZE",
                                     "40"])
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)
    sizes = []
    for e in roidb:
        im = image_io.imread(e["image"])
        prepped, scale = blob_utils.prep_im_for_blob(
            im, port_config.cfg.PIXEL_MEANS, 29, 40)
        sizes.append(tuple(int(round(n / scale))
                           for n in prepped.shape[:2]))
    assert sizes[0] == (96, 129) != (roidb[0]["height"], roidb[0]["width"])
    out = str(tmp_path / "out")
    results = test_engine.run_inference(
        env.args, dataset_name="coco_2017_val", output_dir=out,
        batch_size=2, device="cpu")
    segms = _load(out)["all_segms"]
    n = 0
    for i, e in enumerate(roidb):
        for j in range(1, 4):
            for r in segms[j][i]:
                assert r["size"] == [e["height"], e["width"]]
                n += 1
    assert n > 0 and np.isfinite(results["coco_2017_val"]["mask"]["AP"])


def test_c4_train_net_step_from_the_yaml(tmp_path):
    """`train_net_step --cfg e2e_mask_rcnn_R-50-C4_1x.yaml`, 2 steps on the
    CPU at the tiny sizes."""
    root = tmp_path / "data"
    write_train_set(root, contrast=4.0)
    port_config.reset_cfg()
    run = train_net_step.main([
        "--cfg", C4_YAML, "--bs", "2", "--nw", "2", "--device", "cpu",
        "--disp_interval", "1", "--set",
        "DATA_DIR", str(root), "OUTPUT_DIR", str(tmp_path / "out"),
        "TRAIN.DATASETS", "('coco_2017_train',)", "MODEL.NUM_CLASSES", "4",
        "NUM_GPUS", "1", "TRAIN.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
        "SOLVER.BASE_LR", "0.002", "SOLVER.CLIP_GRADIENTS", "10",
        "TRAIN.SCALES", "(64, 80)", "TRAIN.MAX_SIZE", "128",
        "TPU.MAX_GT_BOXES", "8", "TPU.GT_MASK_SIZE", "28",
        "TRAIN.BATCH_SIZE_PER_IM", "16", "TRAIN.RPN_PRE_NMS_TOP_N", "64",
        "TRAIN.RPN_POST_NMS_TOP_N", "8", "TRAIN.RPN_BATCH_SIZE_PER_IM", "32",
        "MRCNN.DIM_REDUCED", "32"])
    assert port_config.cfg.MODEL.CONV_BODY == "ResNet.ResNet50_conv4_body"
    assert len(run["stats"]) == 2
    for s in run["stats"]:
        assert "loss_mask" in s and all(np.isfinite(v) for v in s.values())
    assert run["ckpt"].endswith(os.path.join(
        "e2e_mask_rcnn_R-50-C4_1x", "ckpt", "model_step2"))
    got = dict(port_opt.flatten(jax_net.load_ckpt_params(run["ckpt"])))
    tree = dict(port_opt.flatten(init.init_model(port_config.cfg.RNG_SEED)))
    assert set(got) == set(tree)
    assert ("box_head", "res5", 0, "branch2a", "w") in got
    assert not np.array_equal(got[("box_head", "res5", 2, "branch2c", "w")],
                              tree[("box_head", "res5", 2, "branch2c", "w")])


def _c4_set(v0up=False):
    set_cfgs(extra=C4_KEYS + ([
        "MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v0up"]
        if v0up else []))


@pytest.mark.parametrize("fmt,v0up", [("pkl", False), ("pth", False),
                                      ("pkl", True)])
def test_imagenet_weights_fill_the_c4_res5_heads(tmp_path, fmt, v0up):
    _c4_set(v0up)
    rng = np.random.RandomState(4)
    if fmt == "pth":
        sd = _state_dict(rng)
        path = str(tmp_path / "resnet50_caffe.pth")
        torch.save(sd, path)
        w = sd["layer4.2.conv3.weight"].numpy()
        res5_w = np.transpose(w, (2, 3, 1, 0))
    else:
        blobs = {k: v for k, v in _random_blobs(rng).items()
                 if k.startswith(("conv1_", "res"))}
        assert "res5_2_branch2c_w" in blobs and "res4_5_branch2c_w" in blobs
        path = _write_pkl(tmp_path / "R-50.pkl", blobs)
        res5_w = np.transpose(blobs["res5_2_branch2c_w"], (2, 3, 1, 0))
    base = init.init_model(0)
    got = rwh.load_pretrained_imagenet_weights(init.init_model(0), path)
    ref = jax.tree.map(np.asarray, jax_rwh.load_pretrained_imagenet_weights(
        init.init_model(0), path))
    heads = ["box_head"] + (["mask_head"] if v0up else [])
    for h in heads:
        np.testing.assert_array_equal(got[h]["res5"][2]["branch2c"]["w"],
                                      res5_w)
        # The JAX package's loader leaves the head at its init.
        _assert_trees_equal(ref[h]["res5"], base[h]["res5"])
        ref[h]["res5"] = got[h]["res5"]
    # Everything else loads as in the JAX package.
    _assert_trees_equal(got, ref)
    assert not np.array_equal(got["body"]["res4"][5]["branch2b"]["w"],
                              base["body"]["res4"][5]["branch2b"]["w"])


@pytest.mark.parametrize("keys", [C4_KEYS, FASTER_C4_KEYS],
                         ids=["mask", "faster"])
def test_c4_pkl_round_trips_as_in_jax(tmp_path, keys):
    set_cfgs(extra=keys)
    tree = init.init_model(0)
    mapping = dwh.full_weight_mapping()
    assert {tuple(p) for p, _ in mapping.values()} == \
        {p for p, _ in port_opt.flatten(tree)}
    assert set(mapping) == set(jax_dwh.full_weight_mapping())
    assert mapping["res5_0_branch1_w"][0] == ("box_head", "res5", 0,
                                              "branch1", "w")
    assert ("conv5_mask_w" in mapping) == port_config.cfg.MODEL.MASK_ON
    blobs = _random_blobs(np.random.RandomState(5))
    pkl = _write_pkl(tmp_path / "c4.pkl", blobs)
    got = dwh.load_detectron_weight(init.init_model(1), pkl)
    ref = jax_dwh.load_detectron_weight(init.init_model(1), pkl)
    _assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    back = dwh.to_detectron_blobs(got)
    assert set(back) == set(blobs)
    for name, b in back.items():
        np.testing.assert_array_equal(b, blobs[name], err_msg=name)


def test_v0up_mask_res5_has_its_own_blobs(tmp_path):
    """Under v0up the mask head's res5 reads Detectron's "_[mask]_res5"
    blobs and the box head's res5 the "res5" ones; the JAX table maps the
    "res5" names to the mask head, so its box head's res5 stays at init."""
    _c4_set(v0up=True)
    tree = init.init_model(0)
    mapping = dwh.full_weight_mapping()
    assert {tuple(p) for p, _ in mapping.values()} == \
        {p for p, _ in port_opt.flatten(tree)}
    assert mapping["_[mask]_res5_2_branch2c_w"][0][0] == "mask_head"
    assert mapping["res5_2_branch2c_w"][0][0] == "box_head"
    assert jax_dwh.full_weight_mapping()["res5_2_branch2c_w"][0][0] == \
        "mask_head"
    rng = np.random.RandomState(6)
    blobs = {name: rng.randn(*b.shape).astype(np.float32)
             for name, b in dwh.to_detectron_blobs(tree).items()}
    pkl = _write_pkl(tmp_path / "v0up.pkl", blobs)
    got = dwh.load_detectron_weight(init.init_model(1), pkl)
    for h, name in (("box_head", "res5_2_branch2c_w"),
                    ("mask_head", "_[mask]_res5_2_branch2c_w")):
        np.testing.assert_array_equal(
            got[h]["res5"][2]["branch2c"]["w"],
            np.transpose(blobs[name], (2, 3, 1, 0)))
    back = dwh.to_detectron_blobs(got)
    for name, b in back.items():
        np.testing.assert_array_equal(b, blobs[name], err_msg=name)
