"""The rest of the model cfg surface in the PyTorch port against the JAX
package: RoIPoolF, RoICrop, the v1up mask head, MRCNN.USE_FC_OUTPUT,
FPN.EXTRA_CONV_LEVELS / ZERO_INIT_LATERAL, an FPN on a conv4 body and
RPN_MAX_LEVEL 7 without extra levels, RESNETS.RES5_DILATION, and the s2d
stems (TPU.S2D_STEM, TPU.S2D_INPUT).

- RoIPoolF (ops/roi_pool.py) against JAX roi_pool: RoIs past the map's
  edge, empty bins and one-cell RoIs, in one chunk and in many; equal
  values (a max picks one input: float32 and bfloat16 exact), the
  gradient within 1e-6 of max|ref| (the same cells, summed in another
  order).
- RoICrop (ops/roi_crop.py) against JAX roi_crop, with and without the
  2 x 2 max pool: float32 within 1e-5 of max|ref| (float32 products in
  other orders), its gradient likewise.
- The s2d stems against the plain stem conv (float32 within 1e-5 of
  max|ref|: the same sums in another order) and blob.space_to_depth
  against JAX's, exactly.
- init_model's keys and shapes against JAX's for each variant cfg, and
  detect_graph of three variant models against JAX (test_torch_detect.py's
  matching, masks within 1e-4):
  fpn: RoICrop for boxes and masks, fpn_6 / fpn_7, zero laterals, the
  v1up head with an FC output, S2D_STEM; c4: RES5_DILATION 2 in the res5
  box head and the v0up mask head, RoIPoolF for the masks; conv4: an FPN
  on a conv4 body (P5 subsampled from P4, as in JAX), S2D_INPUT. The mask
  logits' weights are scaled by 1e-2 so that the compared probabilities
  are not saturated at 0 or 1.
- apply_fpn against JAX's for EXTRA_CONV_LEVELS on and off and
  RPN_MAX_LEVEL 5-7 (7 without extra levels gives P2-P5, as in JAX):
  the same levels and scales, float32 within 1e-5 of max|ref|.
- One training step each with RoICrop (FPN, boxes and masks) and RoIPoolF
  (C4 masks), float32, calibrated params: losses to rtol 1e-4, gradients
  within 1e-3 of each leaf's max|g| (test_torch_train_step.py's
  tolerances). The RoIPoolF step's init seed is one whose ReLU inputs
  clear the sign trap of ROADMAP Queue C (at seeds 0-2 a res5 ReLU input
  within float32 rounding of 0 flips between the packages' float32
  steps, moving a res5 gradient by 2e-3 to 6e-3 of its max|g|).
- The weight round trip of the new blobs (fpn_6_w, fpn_7_b,
  _[mask]_fcn2_w, the FC mask_fcn_logits_w), and the JAX table, which
  names no fpn_6 / fpn_7 blob (ROADMAP Queue C).
- The repaired fault of the reference: the JAX C4 box head pools with
  RoIAlign whatever FAST_RCNN.ROI_XFORM_METHOD says; the port's follows it
  (equal to JAX's roi_pool -> res5 head -> outputs).
- The combinations the JAX package cannot run raise in the port, naming
  that, and fail in JAX: a conv5 body without an FPN, RoIPoolF on an FPN,
  an FPN with a single-level RPN (JAX decodes every level with RPN.STRIDE),
  TPU.S2D_INPUT on the per-image path.
The params are the port's numpy init_model, given to both packages; the
JAX models run their plain RoIAlign and NMS paths
(test_torch_util.jax_plain_paths) and are jitted afresh per cfg.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.models import fast_rcnn_heads as jax_fh
from detectron_tpu.models import fpn as jax_fpn
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import resnet as jax_resnet
from detectron_tpu.models import rpn as jax_rpn
from detectron_tpu.ops import roi_crop as jax_rc
from detectron_tpu.ops import roi_pool as jax_rp
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.utils import blob as jax_blob
from detectron_tpu.utils import detectron_weight_helper as jax_dwh
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core.config import cfg as port_cfg
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import fpn as port_fpn
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.models import resnet as port_resnet
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.ops import roi_crop as port_rc
from detectron_tpu_torch.ops import roi_pool as port_rp
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils import blob as port_blob
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_c4 import _train_batch as _c4_batch
from test_torch_detect import _assert_detections_match
from test_torch_train_step import (_batch, _close_tree, _jax_step,
                                   _replay_draws)
from test_torch_util import (C4_KEYS, TRAIN_KEYS, jax_plain_paths,
                             set_cfgs)

torch.set_num_threads(4)

CROP = ["FAST_RCNN.ROI_XFORM_METHOD", "RoICrop",
        "MRCNN.ROI_XFORM_METHOD", "RoICrop"]
V1UP_FC = ["MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v1up",
           "MRCNN.USE_FC_OUTPUT", "True", "MRCNN.DIM_REDUCED", "16",
           "MRCNN.RESOLUTION", "14", "MRCNN.ROI_XFORM_RESOLUTION", "7",
           "MODEL.NUM_CLASSES", "4", "FAST_RCNN.MLP_HEAD_DIM", "32"]
EXTRA_LEVELS = ["FPN.EXTRA_CONV_LEVELS", "True", "FPN.ZERO_INIT_LATERAL",
                "True", "FPN.RPN_MAX_LEVEL", "7"]
VARIANTS = {
    "fpn": CROP + V1UP_FC + EXTRA_LEVELS + ["TPU.S2D_STEM", "True"],
    "c4": C4_KEYS + ["RESNETS.RES5_DILATION", "2",
                     "MRCNN.ROI_MASK_HEAD",
                     "mask_rcnn_heads.mask_rcnn_fcn_head_v0up",
                     "MRCNN.RESOLUTION", "28",
                     "MRCNN.ROI_XFORM_METHOD", "RoIPoolF"],
    "conv4": ["MODEL.CONV_BODY", "FPN.fpn_ResNet50_conv4_body",
              "TPU.S2D_INPUT", "True", "MODEL.NUM_CLASSES", "4",
              "FAST_RCNN.MLP_HEAD_DIM", "32"],
}


def _sorted(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------- op level

def _map_and_rois(C=8):
    """A (2, 13, 17, C) map at scale 1/4 and 10 RoIs an image: inside,
    past the map's edges, one cell, and one wholly outside (empty bins)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 13, 17, C).astype(np.float32)
    xy = rng.uniform(-8, 60, (2, 10, 2))
    wh = rng.uniform(1, 40, (2, 10, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [1.0, 1.0, 2.0, 2.0]
    rois[:, 1] = [80.0, 60.0, 120.0, 90.0]
    rois[1, 2] = [-20.0, -10.0, 100.0, 70.0]
    return feats, rois


def _jax_pool(f, r):
    return jax.vmap(lambda a, b: jax_rp.roi_pool(a, b, 0.25, 5, 5))(f, r)


@pytest.mark.parametrize("chunk_bytes", [None, 4096], ids=["one", "many"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pool_matches_jax(dtype, chunk_bytes, monkeypatch):
    if chunk_bytes:
        monkeypatch.setattr(port_rp, "CHUNK_BYTES", chunk_bytes)
    feats, rois = _map_and_rois()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(_jax_pool(jnp.asarray(feats, jd), jnp.asarray(rois))
                     .astype(jnp.float32))
    got = port_rp.roi_pool_batched(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(rois), 0.25, 5)
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    assert (ref[:, 1] == 0).all() and (ref[:, 0] != 0).any()
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_roi_pool_gradient_matches_jax(monkeypatch):
    monkeypatch.setattr(port_rp, "CHUNK_BYTES", 4096)
    feats, rois = _map_and_rois()
    g = np.random.RandomState(1).randn(2, 10, 5, 5, 8).astype(np.float32)
    ref = jax.grad(lambda f: jnp.sum(_jax_pool(f, jnp.asarray(rois)) * g))(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    (port_rp.roi_pool_batched(f, torch.from_numpy(rois), 0.25, 5)
     * torch.from_numpy(g)).sum().backward()
    assert np.abs(np.asarray(ref)).max() > 0
    _close(f.grad.numpy(), ref, 1e-6)


@pytest.mark.parametrize("max_pool", [True, False], ids=["pool", "nopool"])
def test_roi_crop_and_gradient_match_jax(max_pool, monkeypatch):
    monkeypatch.setattr(port_rc, "CHUNK_BYTES", 8192)
    feats, rois = _map_and_rois()

    def jax_crop(f):
        return jax.vmap(lambda a, b: jax_rc.roi_crop(
            a, b, 0.25, 4, 4, max_pool=max_pool))(f, jnp.asarray(rois))

    g = np.random.RandomState(2).randn(2, 10, 4, 4, 8).astype(np.float32)
    ref = jax_crop(jnp.asarray(feats))
    ref_g = jax.grad(lambda f: jnp.sum(jax_crop(f) * g))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    got = port_rc.roi_crop_batched(f, torch.from_numpy(rois), 0.25, 4,
                                   max_pool)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach().numpy(), ref, 1e-5)
    _close(f.grad.numpy(), ref_g, 1e-5)


@pytest.mark.parametrize("key", ["TPU.S2D_STEM", "TPU.S2D_INPUT"])
def test_s2d_stems_match_the_plain_stem(key):
    set_cfgs()
    rng = np.random.RandomState(0)
    conv1 = {"w": torch.from_numpy(
        rng.randn(64, 3, 7, 7).astype(np.float32) * 0.1)}
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    ref = port_resnet.stem_conv(conv1, torch.from_numpy(x))
    blocked = port_blob.space_to_depth(x)
    np.testing.assert_array_equal(blocked, jax_blob.space_to_depth(x))
    np.testing.assert_array_equal(
        port_resnet.space_to_depth(torch.from_numpy(x)).numpy(), blocked)
    setattr(port_cfg.TPU, key.split(".")[1], True)
    got = port_resnet.stem_conv(
        conv1, torch.from_numpy(blocked if key == "TPU.S2D_INPUT" else x))
    assert got.shape == ref.shape == (2, 16, 24, 64)
    _close(got.numpy(), ref.numpy(), 1e-5)


# ------------------------------------------------------------ model level

def _shapes(tree):
    return {p: tuple(np.shape(a)) for p, a in port_opt.flatten(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_model_keys_and_shapes_match_jax(variant):
    set_cfgs(extra=VARIANTS[variant])
    ref = jax.eval_shape(lambda k: jax_mb.init_model(k),
                         jax.random.PRNGKey(0))
    tree = port_init.init_model(0)
    assert _shapes(tree) == _shapes(ref)
    if variant == "fpn":
        fpn = tree["fpn"]
        assert set(fpn) >= {"fpn_6", "fpn_7"}
        assert fpn["fpn_6"]["w"].shape == (3, 3, 2048, 256)
        for lvl in (2, 3, 4):
            assert not fpn["fpn_inner_res{}".format(lvl)]["w"].any()
        assert fpn["fpn_inner_res5"]["w"].any()
        assert len(tree["mask_head"]["convs"]) == 2
        assert tree["mask_outs"]["mask_fcn_logits"]["w"].shape == (
            16 * 14 * 14, 4 * 14 * 14)


@pytest.mark.parametrize("extra,max_lvl", [(True, 7), (True, 6),
                                           (False, 7), (False, 5)])
def test_fpn_levels_match_jax(extra, max_lvl):
    set_cfgs(extra=["FPN.EXTRA_CONV_LEVELS", str(extra),
                    "FPN.RPN_MAX_LEVEL", str(max_lvl), "FPN.DIM", "16"])
    tree = port_init.init_fpn(np.random.RandomState(0))
    rng = np.random.RandomState(1)
    body = [rng.randn(1, 16 >> i, 24 >> i, 256 << i).astype(np.float32)
            for i in range(4)]
    ref, ref_scales = jax_fpn.apply_fpn(jax.tree.map(jnp.asarray, tree),
                                        [jnp.asarray(b) for b in body])
    got, scales = port_fpn.apply_fpn(
        bridge.to_torch({"fpn": tree}, "cpu")["fpn"],
        [torch.from_numpy(b) for b in body])
    assert scales == list(ref_scales)
    assert len(got) == (max_lvl if extra or max_lvl == 6 else 5) - 1
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        _close(g.numpy(), r, 1e-5)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def detect_case(request):
    set_cfgs(extra=VARIANTS[request.param])
    jax_plain_paths()
    tree = calibrate_detector_params(_sorted(port_init.init_model(0)),
                                     np.random.RandomState(0))
    tree["box_outs"]["cls_score"]["b"][1:] += 5.0
    tree["mask_outs"]["mask_fcn_logits"]["w"] *= 1e-2
    images = np.random.RandomState(0).randn(2, 64, 96, 3).astype(
        np.float32) * 0.3
    im_info = np.array([[64.0, 90.0, 1.0], [60.0, 96.0, 1.0]], np.float32)
    if port_cfg.TPU.S2D_INPUT:
        images = port_blob.space_to_depth(images)
    ref = jax.jit(lambda p, x, i: jax_test.detect_graph(p, x, i))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(im_info))
    return dict(variant=request.param, tree=tree, images=images,
                im_info=im_info,
                ref={k: np.asarray(v) for k, v in ref.items()})


def test_variant_detect_graph_matches_jax(detect_case):
    c = detect_case
    set_cfgs(extra=VARIANTS[c["variant"]])
    got = port_test.detect_graph(bridge.to_torch(c["tree"], "cpu"),
                                 torch.from_numpy(c["images"]),
                                 torch.from_numpy(c["im_info"]))
    ref = c["ref"]
    assert set(got) == set(ref) and "mask_probs" in got
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape, k
    assert ref["valid"].sum() > 4
    _assert_detections_match(got, ref, mask_atol=1e-4)


def _train_case(keys, batch, init_seed):
    set_cfgs(extra=keys)
    jax_plain_paths()
    tree = calibrate_detector_params(
        _sorted(port_init.init_model(init_seed)), np.random.RandomState(0))
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jax.jit(_jax_step)(jp, jax_opt.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, batch), key)
    H, W = batch["images"].shape[1:3]
    n_anchors, n_rois = port_tg.draw_sizes((H, W),
                                           batch["gt_boxes"].shape[1])
    draws = _replay_draws(key, n_anchors, n_rois)
    params = bridge.to_torch(tree, "cpu")
    total, parts, grads = port_ts.loss_and_grads(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    return ref, total, parts, grads


@pytest.mark.parametrize("method", ["RoICrop", "RoIPoolF"])
def test_train_step_matches_jax(method):
    """RoICrop: the FPN model with both branches cropped, at 2 x 64 x 64.
    RoIPoolF: the C4 model's mask branch (the JAX C4 box head pools with
    RoIAlign whatever the cfg says), at 2 x 96 x 96 (test_torch_c4.py's
    reasons), 8 RoIs an image (XLA:CPU runs the full-width res5 head of
    16 in ~20 s)."""
    if method == "RoICrop":
        ref, total, parts, grads = _train_case(TRAIN_KEYS + CROP,
                                               _batch(True), 0)
    else:
        ref, total, parts, grads = _train_case(
            C4_KEYS + ["MRCNN.ROI_XFORM_METHOD", "RoIPoolF",
                       "TRAIN.BATCH_SIZE_PER_IM", "8"], _c4_batch(), 3)
    ref_total, ref_parts, ref_grads = ref[:3]
    assert set(parts) == set(ref_parts) and "loss_mask" in parts
    for k, v in ref_parts.items():
        np.testing.assert_allclose(float(parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-4)
    _close_tree(bridge.to_jax_layout(grads), ref_grads, 1e-3, "grad")
    g = bridge.to_jax_layout(grads)
    mask_in = g["mask_head"]["convs"][0]["w"] if method == "RoICrop" else \
        g["box_head"]["res5"][0]["branch2a"]["w"]
    assert np.abs(mask_in).max() > 0


# ---------------------------------------------------------------- weights

def test_new_blobs_round_trip_and_the_jax_table(tmp_path):
    """fpn_6 / fpn_7 under Detectron's names, v1up's two convs and the FC
    mask output (Caffe2 (out, in)) load back exactly. The JAX table names
    the same blobs but fpn_6 / fpn_7: its loader leaves those levels at
    their init (ROADMAP Queue C)."""
    set_cfgs(extra=VARIANTS["fpn"])
    tree = port_init.init_model(0)
    blobs = dwh.to_detectron_blobs(tree)
    for name in ("fpn_6_w", "fpn_6_b", "fpn_7_w", "fpn_7_b",
                 "_[mask]_fcn1_w", "_[mask]_fcn2_b", "mask_fcn_logits_w"):
        assert name in blobs, name
    assert "_[mask]_fcn3_w" not in blobs
    assert blobs["fpn_6_w"].shape == (256, 2048, 3, 3)
    assert blobs["mask_fcn_logits_w"].shape == (4 * 14 * 14, 16 * 14 * 14)
    pkl = str(tmp_path / "variant.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f, pickle.HIGHEST_PROTOCOL)
    back = dict(port_opt.flatten(dwh.load_detectron_weight(
        port_init.init_model(1), pkl)))
    for p, a in port_opt.flatten(tree):
        np.testing.assert_array_equal(back[p], a, err_msg=str(p))
    jax_names = set(jax_dwh.full_weight_mapping())
    assert jax_names == set(blobs) - {"fpn_6_w", "fpn_6_b", "fpn_7_w",
                                      "fpn_7_b"}
    other = _sorted(port_init.init_model(1))
    got = jax_dwh.load_detectron_weight(other, pkl)
    np.testing.assert_array_equal(got["fpn"]["fpn_6"]["w"],
                                  port_init.init_model(1)["fpn"]["fpn_6"]["w"])
    assert not np.array_equal(got["fpn"]["fpn_6"]["w"], tree["fpn"]["fpn_6"]["w"])


# ------------------------------------------------- the reference's limits

def test_c4_box_head_takes_its_roi_xform_method():
    """FAST_RCNN.ROI_XFORM_METHOD RoIPoolF on C4: the port's box outputs
    are JAX's roi_pool -> res5 head -> outputs; JAX's own
    forward_box_outputs gives its RoIAlign result (ROADMAP Queue C)."""
    set_cfgs(extra=C4_KEYS + ["FAST_RCNN.ROI_XFORM_METHOD", "RoIPoolF"])
    tree = _sorted(port_init.init_model(0))
    rng = np.random.RandomState(3)
    feat = np.abs(rng.randn(1, 6, 8, 1024)).astype(np.float32)
    rois = np.array([[[0, 0, 60, 50], [10, 20, 100, 90], [40, 8, 120, 40],
                      [5, 5, 30, 30]]], np.float32)
    jp = jax.tree.map(jnp.asarray, tree)

    def pieces(p, f, r):
        pooled = jax.vmap(lambda a, b: jax_rp.roi_pool(a, b, 1 / 16, 14,
                                                        14))(f, r)
        h = jax_resnet.apply_roi_conv5_head(p["box_head"], pooled[0])
        return jax_fh.apply_fast_rcnn_outputs(p["box_outs"], h)

    ref_cls, ref_box = jax.jit(pieces)(jp, jnp.asarray(feat),
                                       jnp.asarray(rois))
    jax_cls = jax.jit(lambda p, f, r: jax_mb.forward_box_outputs(
        p, [f], [1 / 16], r)[0])(jp, jnp.asarray(feat), jnp.asarray(rois))
    cls, box, _ = port_mb.forward_box_outputs(
        bridge.to_torch(tree, "cpu"), [torch.from_numpy(feat)], [1 / 16],
        torch.from_numpy(rois))
    _close(cls[0].detach().numpy(), ref_cls, 1e-5)
    _close(box[0].detach().numpy(), ref_box, 1e-5)
    assert np.abs(np.asarray(jax_cls)[0] - np.asarray(ref_cls)).max() > \
        1e-3 * np.abs(np.asarray(ref_cls)).max()


def _jax_detect_shapes():
    shapes = jax.eval_shape(lambda k: jax_mb.init_model(k),
                            jax.random.PRNGKey(0))
    return jax.eval_shape(
        lambda p, x, i: jax_test.detect_graph(p, x, i), shapes,
        jax.ShapeDtypeStruct((1, 64, 96, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 3), jnp.float32))


@pytest.mark.parametrize("keys,jax_error", [
    (C4_KEYS + ["MODEL.CONV_BODY", "ResNet.ResNet50_conv5_body"],
     ValueError),
    (["FAST_RCNN.ROI_XFORM_METHOD", "RoIPoolF"], AssertionError),
], ids=["conv5_without_fpn", "roipoolf_on_fpn"])
def test_combinations_the_reference_cannot_run_raise(keys, jax_error):
    set_cfgs(extra=keys)
    jax_plain_paths()
    with pytest.raises(jax_error):
        _jax_detect_shapes()
    with pytest.raises(NotImplementedError, match="not a feature of the "
                       "reference"):
        port_init.init_model(0)


def test_fpn_single_level_rpn_raises_and_jax_decodes_at_rpn_stride(
        monkeypatch):
    """FPN.MULTILEVEL_RPN False: the JAX package runs the RPN on every
    level but makes every level's anchors at RPN.STRIDE (16), P2's (stride
    4) included, so its proposals are not Detectron's; the port raises."""
    set_cfgs(extra=["FPN.MULTILEVEL_RPN", "False"])
    jax_plain_paths()
    made = []
    level_anchors = jax_rpn.level_anchors

    def spy(stride, sizes, ratios, h, w):
        made.append((stride, h, w))
        return level_anchors(stride, sizes, ratios, h, w)

    monkeypatch.setattr(jax_rpn, "level_anchors", spy)
    _jax_detect_shapes()
    assert [s for s, _, _ in made] == [16] * 4
    assert [h for _, h, _ in made] == [16, 8, 4, 2]
    with pytest.raises(NotImplementedError, match="MULTILEVEL_RPN"):
        port_init.init_model(0)


def test_s2d_input_on_the_per_image_path_raises_as_in_jax():
    """TPU.S2D_INPUT with im_detect_all: the JAX package feeds its stem an
    unblocked image there and fails; the port raises, naming that."""
    set_cfgs(extra=VARIANTS["conv4"])
    jax_plain_paths()
    tree = _sorted(port_init.init_model(0))
    im = np.full((64, 96, 3), 120, np.uint8)
    with pytest.raises((TypeError, ValueError)):
        jax_test.im_detect_all(jax.tree.map(jnp.asarray, tree), im,
                               {"detect_raw": jax.jit(jax_test.detect_raw)})
    with pytest.raises(NotImplementedError, match="S2D_INPUT"):
        port_test.im_detect_all(bridge.to_torch(tree, "cpu"), im, "cpu")
