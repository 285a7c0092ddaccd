"""The port's weight import (utils/detectron_weight_helper.py,
utils/resnet_weights_helper.py, tools/convert_detectron_pkl.py and
core/test_engine.initialize_model_from_cfg) against the JAX package's, on
files the tests write themselves:

- a Detectron .pkl of N(0, 1) blobs in Caffe2 layouts (as
  tests/test_weight_import.py synthesizes one), loaded by both packages
  into the port's numpy init tree: equal trees, exactly, mask head on and
  off;
- a calibrated init written as a .pkl by the port's to_detectron_blobs: the JAX package loads it back to that tree exactly,
  and detect_graph from it in JAX and in the port (through
  initialize_model_from_cfg) matches within tests/test_torch_detect.py's
  float32 tolerances;
- an ImageNet ResNet-50 state dict (.pth, BN with running statistics) and
  a body-only .pkl: equal body trees, exactly;
- the mapping covers every leaf of the port's init_model (mask head on
  and off; with the RPN off, no RPN blob, where the JAX table still maps
  them); strict mode raises on a missing blob;
- the converter's checkpoint, and initialize_model_from_cfg's order
  (init, --load_ckpt, --load_detectron over it), against the JAX package.

The template trees are the port's numpy init (the JAX init takes ~20 s at
full width); the JAX loaders write into it as into their own tree.
"""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.core import test_engine as jax_engine
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.utils import detectron_weight_helper as jax_dwh
from detectron_tpu.utils import net as jax_net
from detectron_tpu.utils import resnet_weights_helper as jax_rwh
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.models import bridge, init
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.tools import convert_detectron_pkl
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils import resnet_weights_helper as rwh
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_detect import IM_INFO, _assert_detections_match, _images
from test_torch_train_data import FAST_RCNN_KEYS
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(2)


def _leaves(tree):
    return {p: np.asarray(x) for p, x in port_opt.flatten(tree)}


def _assert_trees_equal(got, ref):
    """Same paths (jax.tree.map sorts dict keys, so not the same order),
    float32 leaves, equal values."""
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref)
    for path, g in got.items():
        assert g.dtype == ref[path].dtype == np.float32, path
        np.testing.assert_array_equal(g, ref[path], err_msg=str(path))


def _random_blobs(rng):
    """N(0, 1) blobs in Caffe2 layouts for every blob of the JAX package's
    mapping (the inverse of each of its transforms' shapes)."""
    tree = init.init_model(0)
    blobs = {}
    for name, (path, transform) in jax_dwh.full_weight_mapping().items():
        node = tree
        for p in path:
            node = node[p]
        shape = node.shape
        if transform is jax_dwh._conv:
            blob = rng.randn(shape[3], shape[2], shape[0], shape[1])
        elif transform is jax_dwh._deconv:
            blob = rng.randn(shape[2], shape[3], shape[0], shape[1])
        elif transform is jax_dwh._fc:
            blob = rng.randn(shape[1], shape[0])
        else:
            blob = rng.randn(*shape)
        blobs[name] = blob.astype(np.float32)
    return blobs


def _write_pkl(path, blobs, wrap=True):
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs} if wrap else blobs, f)
    return str(path)


@pytest.mark.parametrize("mask_on", [False, True], ids=["box", "mask"])
def test_mapping_covers_every_leaf(mask_on):
    set_cfgs(mask_on=mask_on, extra=TRAIN_KEYS)
    tree = init.init_model(0)
    mapped = {tuple(p) for p, _ in dwh.full_weight_mapping().values()}
    leaves = {p for p, _ in port_opt.flatten(tree)}
    assert mapped == leaves
    assert set(dwh.full_weight_mapping()) == \
        set(jax_dwh.full_weight_mapping())


def test_fast_rcnn_mapping_has_no_rpn_blobs():
    """With the RPN off init_model has no "rpn" subtree; the port's table
    leaves the RPN's blobs out (the JAX table keeps them, and its loader
    fails on the missing subtree), so a Detectron .pkl loads into a Fast
    R-CNN model."""
    set_cfgs(mask_on=False, extra=TRAIN_KEYS + FAST_RCNN_KEYS)
    tree = init.init_model(0)
    mapping = dwh.full_weight_mapping()
    assert {tuple(p) for p, _ in mapping.values()} == \
        {p for p, _ in port_opt.flatten(tree)}
    assert set(jax_dwh.full_weight_mapping()) - set(mapping) == {
        "conv_rpn_fpn2_w", "conv_rpn_fpn2_b", "rpn_cls_logits_fpn2_w",
        "rpn_cls_logits_fpn2_b", "rpn_bbox_pred_fpn2_w",
        "rpn_bbox_pred_fpn2_b"}


@pytest.mark.parametrize("mask_on", [False, True], ids=["box", "mask"])
def test_detectron_pkl_loads_as_in_jax(tmp_path, mask_on):
    set_cfgs(mask_on=mask_on, extra=TRAIN_KEYS)
    blobs = _random_blobs(np.random.RandomState(1))
    # Momentum blobs and blobs of other heads are ignored.
    blobs["conv1_w_momentum"] = np.zeros(3, np.float32)
    blobs["kps_score_w"] = np.zeros(3, np.float32)
    pkl = _write_pkl(tmp_path / "model_final.pkl", blobs)
    bare = _write_pkl(tmp_path / "bare.pkl", blobs, wrap=False)
    ref = jax_dwh.load_detectron_weight(init.init_model(0), pkl)
    got = dwh.load_detectron_weight(init.init_model(0), pkl)
    _assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    _assert_trees_equal(dwh.load_detectron_weight(init.init_model(0), bare),
                        got)
    # Nothing is left at init, and the inverse gives the blobs back.
    back = dwh.to_detectron_blobs(got)
    assert set(back) == set(blobs) - {"conv1_w_momentum", "kps_score_w"}
    for name, b in back.items():
        np.testing.assert_array_equal(b, blobs[name], err_msg=name)


def test_strict_raises_on_a_missing_blob(tmp_path):
    set_cfgs(mask_on=True, extra=TRAIN_KEYS)
    blobs = _random_blobs(np.random.RandomState(2))
    del blobs["fpn_res3_3_sum_w"]
    pkl = _write_pkl(tmp_path / "partial.pkl", blobs)
    with pytest.raises(KeyError, match="fpn_res3_3_sum_w"):
        dwh.load_detectron_weight(init.init_model(0), pkl)
    tree = init.init_model(0)
    kept = tree["fpn"]["fpn_res3"]["w"].copy()
    got = dwh.load_detectron_weight(tree, pkl, strict=False)
    np.testing.assert_array_equal(got["fpn"]["fpn_res3"]["w"], kept)
    ref = jax_dwh.load_detectron_weight(init.init_model(0), pkl,
                                        strict=False)
    _assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    blobs["conv1_w"] = blobs["conv1_w"][:, :, :5]
    bad = _write_pkl(tmp_path / "bad.pkl", blobs)
    with pytest.raises(AssertionError, match="shape mismatch"):
        dwh.load_detectron_weight(init.init_model(0), bad, strict=False)


def _state_dict(rng):
    """A torchvision-style ResNet-50 state dict with BN running stats."""
    sd = {"conv1.weight": rng.randn(64, 3, 7, 7)}
    for n in ("weight", "bias", "running_mean", "running_var"):
        sd["bn1." + n] = rng.rand(64) + 0.5
    dims = {1: (64, 256), 2: (128, 512), 3: (256, 1024), 4: (512, 2048)}
    for li, n_blocks in {1: 3, 2: 4, 3: 6, 4: 3}.items():
        inner, outer = dims[li]
        in_c = 64 if li == 1 else dims[li - 1][1]
        for b in range(n_blocks):
            pre = "layer{}.{}.".format(li, b)
            cin = in_c if b == 0 else outer
            shapes = {"conv1": (inner, cin, 1, 1),
                      "conv2": (inner, inner, 3, 3),
                      "conv3": (outer, inner, 1, 1)}
            if b == 0:
                shapes["downsample.0"] = (outer, cin, 1, 1)
            for conv, shape in shapes.items():
                sd[pre + conv + ".weight"] = rng.randn(*shape)
            bns = {"bn1": inner, "bn2": inner, "bn3": outer}
            if b == 0:
                bns["downsample.1"] = outer
            for bn, c in bns.items():
                for n in ("weight", "bias", "running_mean", "running_var"):
                    sd[pre + bn + "." + n] = rng.rand(c) + 0.5
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("fmt", ["pth", "pkl"])
def test_imagenet_weights_load_as_in_jax(tmp_path, fmt):
    set_cfgs(mask_on=True, extra=TRAIN_KEYS)
    rng = np.random.RandomState(3)
    if fmt == "pth":
        path = str(tmp_path / "resnet50_caffe.pth")
        torch.save({"state_dict": _state_dict(rng)}, path)
    else:
        body = {k: v for k, v in _random_blobs(rng).items()
                if k.startswith(("conv1_", "res"))}
        path = _write_pkl(tmp_path / "R-50.pkl", body)
    ref = jax_rwh.load_pretrained_imagenet_weights(init.init_model(0), path)
    got = rwh.load_pretrained_imagenet_weights(init.init_model(0), path)
    _assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    # The body changed; the heads stayed at init.
    base = init.init_model(0)
    assert not np.array_equal(got["body"]["res4"][5]["branch2b"]["w"],
                              base["body"]["res4"][5]["branch2b"]["w"])
    _assert_trees_equal(got["fpn"], base["fpn"])
    # The cfg keys select the file, as in the JAX package.
    set_cfgs(mask_on=True, extra=TRAIN_KEYS + [
        "MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS", "True",
        "RESNETS.IMAGENET_PRETRAINED_WEIGHTS", path])
    _assert_trees_equal(rwh.load_pretrained_imagenet_weights(
        init.init_model(0)), got)


def test_converter_and_initialize_match_jax(tmp_path, monkeypatch):
    set_cfgs(mask_on=True, extra=TRAIN_KEYS)
    pkl = _write_pkl(tmp_path / "model.pkl",
                     _random_blobs(np.random.RandomState(4)))
    ref = jax.tree.map(np.asarray, jax_dwh.load_detectron_weight(
        init.init_model(0), pkl))

    # The converter: a yaml cfg, a .pkl in, a checkpoint out that the JAX
    # package reads back to the tree it loads itself.
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text("MODEL:\n  MASK_ON: True\n")
    ckpt = convert_detectron_pkl.main(
        ["--cfg", str(yaml), "--pkl", pkl, "--out", str(tmp_path / "conv"),
         "--set"] + TRAIN_KEYS)
    _assert_trees_equal(jax_net.load_ckpt_params(ckpt), ref)

    # initialize_model_from_cfg: init, then --load_ckpt, then
    # --load_detectron over it, as core/test_engine.py:35-52 does. The JAX
    # package's run starts from the port's init tree (its own JAX init
    # takes ~20 s here; both loads replace every leaf of it).
    set_cfgs(mask_on=True, extra=TRAIN_KEYS)
    other_tree = init.init_model(7)
    other = net.save_ckpt(str(tmp_path / "other"), 0, other_tree)
    for load_ckpt, load_detectron, want in ((other, None, other_tree),
                                            (None, pkl, ref),
                                            (other, pkl, ref)):
        args = types.SimpleNamespace(load_ckpt=load_ckpt,
                                     load_detectron=load_detectron)
        got = test_engine.initialize_model_from_cfg(args, device="cpu")
        _assert_trees_equal(bridge.to_jax_layout(got), want)
    monkeypatch.setattr(jax_mb, "init_model", lambda rng: init.init_model(0))
    _assert_trees_equal(bridge.to_jax_layout(got), jax.tree.map(
        np.asarray, jax_engine.initialize_model_from_cfg(args)))


def test_detect_graph_from_pkl_matches_jax(tmp_path):
    """A calibrated init written as a Detectron .pkl (Caffe2 layouts) by
    the port; each package loads it and runs detect_graph on the tiny
    256 x 320 configuration, images x0.3."""
    set_cfgs()
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    pkl = _write_pkl(tmp_path / "calibrated.pkl",
                     dwh.to_detectron_blobs(tree))
    jax_tree = jax.tree.map(np.asarray, jax_dwh.load_detectron_weight(
        init.init_model(0), pkl))
    _assert_trees_equal(jax_tree, tree)

    x = _images(0.3)
    ref = {k: np.asarray(v) for k, v in jax.jit(jax_test.detect_graph)(
        jax_tree, x, IM_INFO).items()}
    params = test_engine.initialize_model_from_cfg(
        types.SimpleNamespace(load_ckpt=None, load_detectron=pkl),
        device="cpu")
    got = {k: v.numpy() for k, v in port_test.detect_graph(
        params, torch.from_numpy(x), torch.from_numpy(IM_INFO)).items()}
    assert set(got) == set(ref) and ref["valid"].sum() > 0
    _assert_detections_match(got, ref)



def test_io_helpers_match_jax(tmp_path):
    """utils/io.py: save_object writes what the JAX package's writes,
    cache_url returns a local path as it is, md5 agrees."""
    from detectron_tpu.utils import io as jax_io
    from detectron_tpu_torch.utils import io

    obj = {"blobs": np.random.RandomState(8).randn(4, 3).astype(np.float32),
           "meta": [1, "a"]}
    io.save_object(obj, str(tmp_path / "port.pkl"))
    jax_io.save_object(obj, str(tmp_path / "jax.pkl"))
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    path = str(tmp_path / "port.pkl")
    assert io.cache_url(path) == jax_io.cache_url(path) == path
    assert io.md5(path) == jax_io.md5(path)
