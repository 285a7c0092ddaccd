"""The dotted-name head registry of the PyTorch port (models/registry.py)
against the JAX package's (detectron_tpu/models/registry.py), with
tests/test_registry.py's checks on the port's side.

- Every shipped head name resolves in both packages to an init and an
  apply, with the same out_dim under the same cfg.
- An unknown name raises ValueError('Failed to find function: ...') in
  both, and an empty one gives None.
- init_model's keys and shapes equal JAX's (jax.eval_shape) with each
  shipped head selected by its name: the 2-MLP, Xconv1fc(_gn) and res5
  box heads on an FPN, the res5 head on C4, the five mask heads, the pose
  head.
- A new head works by the convention fallback alone: a module of
  detectron_tpu_torch.models with init_<name> / apply_<name> /
  out_dim_<name>, selected by its cfg name, builds through init_model and
  runs through detect_graph, for a box, a mask and a keypoint head, with no
  edit of the model builder.
- A box head other than the res5 head on a C4 body: the JAX package's
  init_model raises TypeError (it calls the head's init without roi_res),
  and the port raises, saying the reference cannot run it (ROADMAP Queue
  C).
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch

from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import registry as jax_registry
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import registry
from detectron_tpu_torch.parallel import optimizer as port_opt
from test_torch_util import C4_KEYS, KPS_KEYS, TRAIN_KEYS, set_cfgs

torch.set_num_threads(4)

SHIPPED = [
    "fast_rcnn_heads.roi_2mlp_head",
    "fast_rcnn_heads.roi_Xconv1fc_head",
    "fast_rcnn_heads.roi_Xconv1fc_gn_head",
    "ResNet.ResNet_roi_conv5_head",
    "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs",
    "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs_gn",
    "mask_rcnn_heads.mask_rcnn_fcn_head_v1up",
    "mask_rcnn_heads.mask_rcnn_fcn_head_v0up",
    "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare",
    "keypoint_rcnn_heads.roi_pose_head_v1convX",
]


@pytest.mark.parametrize("name", SHIPPED)
def test_every_shipped_name_resolves_as_in_jax(name):
    set_cfgs(extra=["FAST_RCNN.MLP_HEAD_DIM", "48", "MRCNN.DIM_REDUCED",
                    "40", "KRCNN.CONV_HEAD_DIM", "24"])
    h, ref = registry.get_func(name), jax_registry.get_func(name)
    assert callable(h.init) and callable(h.apply)
    assert isinstance(h.out_dim(), int)
    assert h.out_dim() == ref.out_dim()


@pytest.mark.parametrize("name", ["fast_rcnn_heads.no_such_head",
                                  "no_such_module.some_head", "nodot"])
def test_unknown_names_raise_the_reference_error(name):
    for reg in (registry, jax_registry):
        with pytest.raises(ValueError, match="Failed to find function: "
                           + name):
            reg.get_func(name)
    assert registry.get_func("") is None


def _shapes(tree):
    return {p: tuple(np.shape(a)) for p, a in port_opt.flatten(tree)}


NARROW = ["FAST_RCNN.NUM_STACKED_CONVS", "2", "FAST_RCNN.CONV_HEAD_DIM",
          "32", "FAST_RCNN.MLP_HEAD_DIM", "32", "MRCNN.DIM_REDUCED", "32"]


@pytest.mark.parametrize("keys", [
    NARROW,
    NARROW + ["FAST_RCNN.ROI_BOX_HEAD", SHIPPED[1],
              "MRCNN.ROI_MASK_HEAD", SHIPPED[6]],
    NARROW + ["FAST_RCNN.ROI_BOX_HEAD", SHIPPED[2],
              "MRCNN.ROI_MASK_HEAD", SHIPPED[5]],
    NARROW + ["FAST_RCNN.ROI_BOX_HEAD", SHIPPED[3]],
    C4_KEYS,
    C4_KEYS + ["MRCNN.ROI_MASK_HEAD", SHIPPED[7]],
    KPS_KEYS,
], ids=["2mlp-v1up4convs", "xconv-v1up", "xconv_gn-v1up4convs_gn",
        "conv5_on_fpn", "c4-v0upshare", "c4-v0up", "pose"])
def test_init_model_by_name_matches_jax(keys):
    set_cfgs(extra=keys)
    ref = jax.eval_shape(lambda k: jax_mb.init_model(k),
                         jax.random.PRNGKey(0))
    assert _shapes(port_init.init_model(0)) == _shapes(ref)


# A plugin module of the convention fallback: a box head (a mean over the
# RoI cells, then an FC), a mask head (a 1x1 conv, nearest x2) and a
# keypoint head (a 1x1 conv), numpy init and torch apply.
PLUGIN = "detectron_tpu_torch.models.my_plugin_heads"


def init_tiny_avg_head(rng, dim_in, roi_res):
    return {"w": (rng.randn(dim_in, 24) * 0.01).astype(np.float32)}


def apply_tiny_avg_head(p, roi_feat):
    return torch.relu(roi_feat.mean((1, 2)) @ p["w"].to(roi_feat.dtype))


def init_tiny_up_head(rng, dim_in):
    return {"w": (rng.randn(dim_in, 12) * 0.01).astype(np.float32)}


def apply_tiny_up_head(p, roi_feat):
    x = torch.relu(roi_feat @ p["w"].to(roi_feat.dtype))
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def init_tiny_pose_head(rng, dim_in):
    return {"w": (rng.randn(dim_in, 20) * 0.01).astype(np.float32)}


def apply_tiny_pose_head(p, roi_feat):
    return torch.relu(roi_feat @ p["w"].to(roi_feat.dtype))


@pytest.fixture
def plugin():
    mod = types.ModuleType(PLUGIN)
    for name, value in globals().items():
        if name.startswith(("init_tiny", "apply_tiny")):
            setattr(mod, name, value)
    mod.out_dim_tiny_avg_head = 24
    mod.out_dim_tiny_up_head = lambda: 12
    mod.out_dim_tiny_pose_head = 20
    sys.modules[PLUGIN] = mod
    yield mod
    del sys.modules[PLUGIN]


@pytest.mark.parametrize("kind", ["box", "mask", "keypoint"])
def test_new_head_by_convention_runs_without_a_builder_edit(plugin, kind):
    key, name, base = {
        "box": ("FAST_RCNN.ROI_BOX_HEAD", "tiny_avg_head", TRAIN_KEYS),
        "mask": ("MRCNN.ROI_MASK_HEAD", "tiny_up_head", TRAIN_KEYS),
        "keypoint": ("KRCNN.ROI_KEYPOINTS_HEAD", "tiny_pose_head",
                     KPS_KEYS)}[kind]
    set_cfgs(extra=base + [key, "my_plugin_heads." + name])
    h = registry.get_func("my_plugin_heads." + name)
    tree = port_init.init_model(0)
    if kind == "box":
        assert tree["box_head"]["w"].shape == (256, 24)
        assert tree["box_outs"]["cls_score"]["w"].shape[0] == h.out_dim()
    elif kind == "mask":
        assert tree["mask_head"]["w"].shape == (256, 12)
        assert tree["mask_outs"]["mask_fcn_logits"]["w"].shape[2] == 12
    else:
        assert tree["kps_head"]["w"].shape == (256, 20)
    images = torch.from_numpy(np.random.RandomState(0).randn(
        2, 64, 96, 3).astype(np.float32))
    im_info = torch.tensor([[64.0, 90.0, 1.0], [60.0, 96.0, 1.0]])
    out = port_test.detect_graph(bridge.to_torch(tree, "cpu"), images,
                                 im_info)
    D = out["boxes"].shape[1]
    if kind == "mask":
        assert out["mask_probs"].shape == (2, D, 14, 14)
    if kind == "keypoint":
        assert out["kps_heatmaps"].shape[:2] == (2, D)
    for v in out.values():
        assert torch.isfinite(v.float()).all()


@pytest.mark.parametrize("head", SHIPPED[:2], ids=["2mlp", "xconv"])
def test_fpn_box_heads_on_a_c4_body_raise_as_in_jax(head):
    set_cfgs(extra=C4_KEYS + ["FAST_RCNN.ROI_BOX_HEAD", head])
    with pytest.raises(TypeError, match="roi_res"):
        jax.eval_shape(lambda k: jax_mb.init_model(k),
                       jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError,
                       match="not a feature of the reference.*C4 body"):
        port_init.init_model(0)
