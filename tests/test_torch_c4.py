"""Faster and Mask R-CNN R-50-C4 in the PyTorch port against the JAX
package, on the tiny C4 configuration (test_torch_util.C4_KEYS: the
mask_rcnn_r50_c4 preset at 4 classes, RPN 64 -> 8, D = 8).

- Single-level RoIAlign (ops/roi_align.py, kernel K2's plain version with
  one window spanning the map) against JAX roi_align_batched: sampling
  ratio 2 and the adaptive ratio 0, RoIs past the map's edge, RoIs wide
  enough to reach the adaptive grid's cap; float32 within 1e-5 of max|ref|,
  bfloat16 within 2 bf16 ulps plus 1e-3 of max|ref| (both sum in float32
  in other orders). Its gradient (K4's plain version) against jax.grad,
  float32 within 1e-5 of max|ref|. A map side over MAX_WINDOW cells takes
  per-RoI windows, and a RoI reaching further raises.
- The res5 RoI head and the v0upshare / v0up mask heads, float32 within
  1e-5 and bfloat16 within 2e-2 of max|ref|.
- The bridge's round trip of the C4 tree (MASK_ON on and off), and a JAX
  tree carried to the port.
- generate_proposals on one level, at the test and training settings,
  with the tolerances of test_torch_proposals.py.
- detect_graph for Faster and Mask R-CNN C4 (float32): the same
  detections (test_torch_detect.py's matching), masks within 1e-4 of
  max|ref|.
- One training step with MASK_ON (float32, 2 x 96 x 96, the smallest
  canvas on which some anchors lie inside the image, so that the RPN
  losses are not zero; JAX's sampling uniforms replayed; the RPN deltas
  calibrated, without which the decode of rail-clipped deltas moves
  proposals by 4e-3 px between two float32 runs): losses to rtol 1e-4 and
  gradients within 1e-3 of each leaf's max|g|, as test_torch_train_step.py;
  the shared res5 gets the mask branch's gradient. The init key is one
  whose ReLU inputs clear the sign trap of ROADMAP Queue C (a ReLU input
  within float32 rounding of 0 takes either sign in two float32 runs, and
  a flip moves a gradient by a whole term, ~1e-3 of max|g| here: at keys
  0 and 1 either package's float32 step flips against its float64 one).
- The Xconv1fc box head on a C4 body, which the JAX package cannot run
  either, raises (the other settings this test once held raising are
  ported: tests/test_torch_variants.py and test_torch_registry.py).
The JAX side is jitted afresh per cfg (a trace reads the global cfg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.models import mask_rcnn_heads as jax_mh
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import resnet as jax_resnet
from detectron_tpu.ops import roi_align as jax_ra
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core.config import cfg as port_cfg
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import mask_rcnn_heads as port_mh
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.models import resnet as port_resnet
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.ops import roi_align as port_ra
from detectron_tpu_torch.ops.cuda import roi_align_kernel as port_rk
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_detect import _assert_detections_match
from test_torch_train_step import _close_tree, _jax_step, _replay_draws
from test_torch_util import C4_KEYS, FASTER_C4_KEYS, set_cfgs

torch.set_num_threads(4)

IMAGES = np.random.RandomState(0).randn(2, 64, 96, 3).astype(
    np.float32) * 0.3
IM_INFO = np.array([[64.0, 90.0, 1.0], [60.0, 96.0, 1.0]], np.float32)


def _tree(seed=0):
    """The JAX init of the cfg's model as numpy, with the foreground
    classes' biases up by 5: on these low-contrast inputs the random
    weights otherwise score every class under TEST.SCORE_THRESH."""
    tree = jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(seed)))
    tree["box_outs"]["cls_score"]["b"][1:] += 5.0
    return tree


def _rois(rng, B, R, H, W, scale, wide=False):
    """RoIs of 2-40 cells of a (H, W) map at `scale`, some past its right
    and bottom edges; with `wide`, RoIs of 40-60 cells a side too (past
    grid_cap x pooled at the adaptive ratio)."""
    lo, hi = (40, 60) if wide else (2, 40)
    x1 = rng.uniform(-2, W * 0.9, (B, R)) / scale
    y1 = rng.uniform(-2, H * 0.9, (B, R)) / scale
    w = rng.uniform(lo, hi, (B, R)) / scale
    h = rng.uniform(lo, hi, (B, R)) / scale
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _roi_close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    top = np.abs(ref).max()
    assert top > 0
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * top
    else:
        assert (np.abs(got - ref) <= np.abs(ref) / 64 + 1e-3 * top).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampling_ratio,wide", [(2, False), (0, False),
                                                 (0, True)])
def test_roi_align_matches_jax(sampling_ratio, wide, dtype):
    rng = np.random.RandomState(sampling_ratio + 10 * wide)
    B, H, W, C, R, P, scale = 2, 12, 20, 8, 24, 14, 0.25
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, R, H, W, scale, wide)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_ra.roi_align_batched(jnp.asarray(feat, jd), jnp.asarray(rois),
                                   scale, P, P, sampling_ratio)
    got = port_ra.roi_align_batched(
        torch.from_numpy(feat).to(getattr(torch, dtype)),
        torch.from_numpy(rois), scale, P, sampling_ratio)
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    _roi_close(got, ref, dtype)
    # One image at a time (roi_align) gives the batched rows.
    one = port_ra.roi_align(torch.from_numpy(feat[1]).to(got.dtype),
                            torch.from_numpy(rois[1]), scale, P,
                            sampling_ratio)
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)


def test_roi_align_weights_cap_the_adaptive_grid_as_jax():
    """At ratio 0 a RoI wider than grid_cap x pooled cells takes 4 samples
    a bin (Detectron would take more): the weights equal JAX's."""
    rng = np.random.RandomState(3)
    rois = _rois(rng, 1, 16, 12, 80, 1.0, wide=True)[0]
    rois[0] = [0.0, 0.0, 78.0, 70.0]        # 78 / 14 > 4 cells a bin
    vy, vx = port_ra.roi_weights(torch.from_numpy(rois), 1.0, 14, 0, 12, 80)
    r = jnp.asarray(rois)
    w = jnp.maximum(r[:, 2] - r[:, 0], 1.0)
    gw = jnp.clip(jnp.ceil(w / 14), 1, 4).astype(jnp.int32)
    assert int(jnp.ceil(w[0] / 14)) > 4 and int(gw[0]) == 4
    ref_x = jax_ra._axis_weights(r[:, 0], w / 14, gw, 14, 4, 80)
    np.testing.assert_allclose(vx.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-6)
    assert vy.shape == (16, 14, 12)


def test_roi_align_gradient_matches_jax():
    rng = np.random.RandomState(7)
    B, H, W, C, R, P, scale = 2, 10, 14, 6, 20, 7, 0.5
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, R, H, W, scale)
    ct = rng.randn(B, R, P, P, C).astype(np.float32)

    def f(x):
        return jnp.sum(jax_ra.roi_align_batched(x, jnp.asarray(rois), scale,
                                                P, P, 0) * ct)

    ref = np.asarray(jax.grad(f)(jnp.asarray(feat)))
    x = torch.from_numpy(feat).requires_grad_(True)
    out = port_ra.roi_align_batched(x, torch.from_numpy(rois), scale, P, 0)
    got, = torch.autograd.grad(out, x, torch.from_numpy(ct))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # float64: the backward is the forward's exact transpose.
    x64 = torch.from_numpy(feat).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: port_ra.roi_align_batched(t, torch.from_numpy(rois)[:, :4],
                                            scale, P, 0),
        (x64,), eps=1e-6, atol=1e-6)


def test_roi_align_long_map_side_takes_per_roi_windows():
    """A map side over MAX_WINDOW cells: each RoI pools from the window of
    its own reach, with the values of the whole-map formulation (JAX) and
    its gradient; a RoI reaching further than MAX_WINDOW raises."""
    rng = np.random.RandomState(5)
    B, H, W, C, R, P = 2, 9, 300, 4, 12, 7
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, R, H, W, 1.0)
    ref = jax_ra.roi_align_batched(jnp.asarray(feat), jnp.asarray(rois), 1.0,
                                   P, P, 2)
    got = port_ra.roi_align_batched(torch.from_numpy(feat),
                                    torch.from_numpy(rois), 1.0, P, 2)
    _roi_close(got, ref, "float32")
    vy, vx = port_ra.roi_weights(torch.from_numpy(rois[0]), 1.0, P, 2, H, W)
    x0, win = port_ra._window(vx, W)
    assert win.shape[2] < port_rk.MAX_WINDOW and int(x0.max()) > 0
    rois[1, 3] = [5.0, 1.0, 5.0 + 140.0, 6.0]
    with pytest.raises(ValueError, match="reaches 13[0-9] cells of a "
                       "300-cell map side"):
        port_ra.roi_align_batched(torch.from_numpy(feat),
                                  torch.from_numpy(rois), 1.0, P, 2)


def _heads_tree():
    set_cfgs(extra=C4_KEYS)
    return jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(2)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("head", ["conv5", "v0upshare", "v0up"])
def test_c4_heads_match_jax(head, dtype, tol):
    extra = list(C4_KEYS)
    if head == "v0up":
        extra += ["MRCNN.ROI_MASK_HEAD",
                  "mask_rcnn_heads.mask_rcnn_fcn_head_v0up"]
    set_cfgs(extra=extra)
    tree = jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(2)))
    assert ("res5" in tree["mask_head"]) == (head == "v0up")
    x = np.abs(np.random.RandomState(1).randn(6, 14, 14, 1024)).astype(
        np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    params = bridge.to_torch(tree, "cpu", getattr(torch, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if head == "conv5":
        ref = jax.jit(jax_resnet.apply_roi_conv5_head)(
            jp["box_head"], jnp.asarray(x, jd))
        got = port_resnet.apply_roi_conv5_head(params["box_head"], xt)
        assert got.shape == (6, 2048)
    else:
        ref = jax.jit(lambda p, a: jax_mh.apply_mask_outputs(
            p["mask_outs"], jax_mh.apply_mask_head(
                p["mask_head"], a, p["box_head"]["res5"])))(
                    jp, jnp.asarray(x, jd))
        got = port_mh.apply_mask_outputs(
            params["mask_outs"], port_mh.apply_mask_head(
                params["mask_head"], xt, port_mh.shared_res5(params)))
        assert got.shape == (6, 14, 14, 4)
    assert got.dtype == getattr(torch, dtype)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), err


@pytest.mark.parametrize("keys", [C4_KEYS, FASTER_C4_KEYS],
                         ids=["mask", "faster"])
def test_c4_tree_round_trips_through_the_bridge(keys):
    """The port's numpy init has JAX's C4 keys and shapes, and
    to_jax_layout(to_torch(tree)) is the tree exactly, for the port's and
    for a JAX init."""
    set_cfgs(extra=keys)
    ref = dict(port_opt.flatten(jax.tree.map(
        np.asarray, jax_mb.init_model(jax.random.PRNGKey(0)))))
    mine = port_init.init_model(0)
    got = dict(port_opt.flatten(mine))
    assert set(got) == set(ref)
    assert all(got[p].shape == ref[p].shape for p in ref)
    assert ("mask_head", "deconv", "w") in got or "mask" not in str(keys)
    for tree in (mine, jax.tree.map(np.asarray,
                                    jax_mb.init_model(jax.random.PRNGKey(0)))):
        back = dict(port_opt.flatten(bridge.to_jax_layout(
            bridge.to_torch(tree, "cpu"))))
        for p, a in port_opt.flatten(tree):
            np.testing.assert_array_equal(back[p], np.asarray(a),
                                          err_msg=str(p))


@pytest.mark.parametrize("training", [False, True])
def test_single_level_proposals_match_jax(training):
    """generate_proposals on the res4 map's 12 anchors a cell: top-k, decode,
    clip, min-size filter, NMS (K1's plain version) and the compacted
    form (post 8 < pre 64); boxes within 1e-3 px, scores within 1e-6,
    validity exact (test_torch_proposals.py's tolerances)."""
    set_cfgs(extra=C4_KEYS + ["TEST.RPN_MIN_SIZE", "2"])
    rng = np.random.RandomState(int(training))
    cl = rng.randn(2, 8, 12, 12).astype(np.float32)
    bp = (rng.randn(2, 8, 12, 48) * 0.3).astype(np.float32)
    cl[1, 6:] = -0.25           # equal logits: the tie order must agree
    bp[1, 6:] = 0.1
    im_info = np.array([[120.0, 180.0, 1.0], [100.0, 150.0, 1.5]],
                       np.float32)
    ref = jax.jit(lambda c, b, i: jax_mb.generate_proposals(
        [(c, b)], None, i, training))(jnp.asarray(cl), jnp.asarray(bp),
                                      jnp.asarray(im_info))
    got = port_mb.generate_proposals(
        [(torch.from_numpy(cl), torch.from_numpy(bp))], None,
        torch.from_numpy(im_info), training)
    rois, scores, valid = (np.asarray(a) for a in ref)
    assert got[0].shape == (2, 8, 4)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert valid.sum() > 8
    np.testing.assert_allclose(got[0].numpy()[valid], rois[valid], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy()[valid], scores[valid],
                               rtol=0, atol=1e-6)


def _jax_detect(params, images, im_info):
    return jax_test.detect_graph(params, images, im_info)


@pytest.mark.parametrize("keys", [C4_KEYS, FASTER_C4_KEYS],
                         ids=["mask", "faster"])
def test_c4_detect_graph_matches_jax(keys):
    set_cfgs(extra=keys)
    tree = _tree()
    ref = jax.jit(lambda *a: _jax_detect(*a))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(IMAGES),
        jnp.asarray(IM_INFO))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                 torch.from_numpy(IMAGES),
                                 torch.from_numpy(IM_INFO))
    assert set(got) == set(ref)
    assert ("mask_probs" in got) == port_cfg.MODEL.MASK_ON
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape, k
    assert ref["valid"].sum() > 4
    # Masks within 1e-4 of max|ref| (the probabilities are at most 1).
    _assert_detections_match(got, ref, mask_atol=1e-4)


B, H, W, G = 2, 96, 96, 4


def _train_batch():
    rng = np.random.RandomState(0)
    gt = np.zeros((B, G, 4), np.float32)
    gt[:, 0] = [6, 8, 50, 44]
    gt[:, 1] = [30, 24, 60, 60]
    gt[1, 2] = [40, 4, 62, 30]
    gv = np.zeros((B, G), bool)
    gv[:, :2] = True
    gv[1, 2] = True
    gc = np.zeros((B, G), np.int32)
    gc[:, :3] = [[1, 3, 2], [2, 1, 3]]
    # Edges on even cells (test_torch_train_step.py's reason).
    masks = np.zeros((B, G, 28, 28), np.float32)
    masks[:, :, 4:22, 2:20] = 1.0
    masks[1, :, 10:, :8] = 1.0
    return {"images": rng.randn(B, H, W, 3).astype(np.float32),
            "im_info": np.array([[H, W, 1.0], [H - 8, W - 12, 1.0]],
                                np.float32),
            "gt_boxes": gt, "gt_classes": gc, "gt_valid": gv,
            "crowd_boxes": np.zeros((B, 2, 4), np.float32),
            "crowd_valid": np.zeros((B, 2), bool), "gt_masks": masks}


def test_c4_train_step_matches_jax():
    """Mask R-CNN C4 (v0upshare): losses, gradients, and res5's gradient
    from both branches."""
    set_cfgs(extra=C4_KEYS)
    tree = calibrate_detector_params(jax.tree.map(
        np.array, jax_mb.init_model(jax.random.PRNGKey(2))),
        np.random.RandomState(0))
    batch = _train_batch()
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    from detectron_tpu.parallel import optimizer as jax_opt
    total, parts, grads, _, _ = jax.jit(_jax_step)(
        jp, jax_opt.init_opt_state(jp), jax.tree.map(jnp.asarray, batch),
        key)
    n_anchors, n_rois = port_tg.draw_sizes((H, W), G)
    assert n_anchors == 6 * 6 * 12 and n_rois == 8 + G
    draws = _replay_draws(key, n_anchors, n_rois)
    params = bridge.to_torch(tree, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_total, got_parts, got_grads = port_ts.loss_and_grads(params, tb,
                                                             draws)
    assert set(got_parts) == set(parts) and "loss_mask" in parts
    assert float(parts["loss_rpn_cls"]) > 0
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    _close_tree(bridge.to_jax_layout(got_grads), grads, 1e-3, "grad")
    # Without the mask loss, res5's gradient is another: the mask branch
    # reaches the shared res5.
    p2, leaves = port_ts.grad_leaves(params)
    _, out = port_tg.training_losses(p2, tb, draws)
    box_only = out["loss_cls"] + out["loss_bbox"]
    w = p2["box_head"]["res5"][2]["branch2c"]["w"]
    g_box, = torch.autograd.grad(box_only, w, retain_graph=True)
    g_all = got_grads["box_head"]["res5"][2]["branch2c"]["w"]
    assert not torch.allclose(g_box, g_all)


@pytest.mark.parametrize("setting,what", [
    pytest.param(["FAST_RCNN.ROI_BOX_HEAD",
                  "fast_rcnn_heads.roi_Xconv1fc_head"], "Xconv1fc",
                 id="setting1-Xconv1fc"),
])
def test_c4_heads_left_out_raise_naming_a7(setting, what):
    """The Xconv1fc box head on a C4 body: the JAX package's init_model
    calls the head's init without roi_res and raises TypeError; the port
    raises, saying the reference cannot run it (the test's name is from
    when this raise named ROADMAP A7, as the port's slices then did)."""
    set_cfgs(extra=C4_KEYS + setting)
    with pytest.raises(TypeError, match="roi_res"):
        jax.eval_shape(lambda k: jax_mb.init_model(k),
                       jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError,
                       match="not a feature of the reference.*" + what):
        port_init.init_model(0)
