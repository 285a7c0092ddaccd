"""The port's Keypoint R-CNN model against the JAX package's, on the tiny
keypoint configuration (test_torch_util.KPS_KEYS: the keypoint_rcnn_r50_fpn
preset's keys at TINY_KEYS' sizes, 2 stacked 3x3 convs of 32 channels on
7 x 7 RoI features, 28 x 28 heatmaps), MASK_ON off, with the same params:
JAX init, carried over by the bridge.

- The pose head and outputs, borders of the bilinear upsampling included,
  for a deconv output, a learned deconv before it, a 1x1 output and an odd
  upsampling factor: float32 within 1e-5 of max|ref|, bfloat16 within
  test_torch_layers.py's 2e-2 of max|ref|.
- The bridge lays out kps_score (under USE_DECONV_OUTPUT) and kps_deconv
  as transposed convs, and to_jax_layout inverts it exactly.
- detect_graph end to end: the same detections (as sets, as
  tests/test_torch_detect.py matches them) and, for matched detections,
  heatmaps within 1e-4 of max|ref| in float32.
- keypoint_targets exactly, keypoint_losses within 1e-5 relative.
- One training_losses / train_step with keypoints (test_torch_util.
  KPS_TRAIN_KEYS, test_torch_train_step.py's 64 x 64 batch with gt
  keypoints and its replayed sampling draws): every loss within 1e-4
  relative, the keypoint head's gradients within 1e-4 of each leaf's
  largest (the rest of the tree within test_torch_train_step.py's 1e-3).
- A head whose output side differs from KRCNN.HEATMAP_SIZE raises
  ValueError in the train graph.
- utils/synthetic.synthetic_train_batch with keypoints is the JAX batch.
JAX functions are jitted once per configuration (a trace reads the global
cfg), the Pallas RoIAlign in interpret mode, as the JAX suite runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.models import keypoint_rcnn_heads as jax_kh
from detectron_tpu.models import losses as jax_losses
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import targets as jax_targets
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.utils import synthetic as jax_synthetic
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import keypoint_rcnn_heads as port_kh
from detectron_tpu_torch.models import losses as port_losses
from detectron_tpu_torch.models import targets as port_targets
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils import synthetic as port_synthetic
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_detect import IM_INFO, _assert_detections_match, _images
from test_torch_train_step import (B, G, H, W, _batch, _close_tree,
                                   _jax_step, _replay_draws)
from test_torch_util import KPS_KEYS, KPS_TRAIN_KEYS, set_cfgs

torch.set_num_threads(4)

HEADS = {
    "deconv_output": [],
    "deconv_then_output": ["KRCNN.USE_DECONV", "True",
                           "KRCNN.DECONV_DIM", "24"],
    "conv_output": ["KRCNN.USE_DECONV_OUTPUT", "False"],
    "upscale_3": ["KRCNN.UP_SCALE", "3", "KRCNN.HEATMAP_SIZE", "42"],
}


def _set(extra=(), dtype="float32"):
    set_cfgs(mask_on=False, extra=KPS_KEYS + list(extra) + [
        "TPU.COMPUTE_DTYPE", dtype])


def _head_params(seed):
    """JAX params of the pose head on 256-channel RoI features and of the
    outputs on its KRCNN.CONV_HEAD_DIM (32) channels."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"kps_head": jax_kh.init_pose_head(k1, 256),
            "kps_outs": jax_kh.init_keypoint_outputs(k2, 32)}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("head", list(HEADS))
def test_pose_head_and_outputs_match_jax(head, dtype, tol):
    _set(HEADS[head], dtype)
    tree = jax.tree.map(np.array, _head_params(3))
    # Outputs of std ~1 everywhere, borders included: kps_score's std-0.001
    # init would leave the upsampled maps at rounding level.
    tree["kps_outs"]["kps_score"]["w"] *= 300.0
    tree["kps_outs"]["kps_score"]["b"] = np.linspace(
        -1, 1, 17).astype(np.float32)
    x = np.random.RandomState(1).randn(3, 7, 7, 256).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def ref_fn(p, x):
        h = jax_kh.apply_pose_head(p["kps_head"], x)
        return jax_kh.apply_keypoint_outputs(p["kps_outs"], h)

    ref = np.asarray(jax.jit(ref_fn)(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(x, jdt)).astype(
                                         jnp.float32))
    p = bridge.to_torch(tree, "cpu", getattr(torch, dtype))
    got = port_kh.apply_keypoint_outputs(
        p["kps_outs"], port_kh.apply_pose_head(
            p["kps_head"], torch.from_numpy(x).to(getattr(torch, dtype))))
    side = port_kh.output_side(7)
    assert tuple(got.shape) == ref.shape == (3, side, side, 17)
    assert got.dtype == getattr(torch, dtype)
    err = np.abs(got.float().numpy() - ref)
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert err.max() <= tol * scale, (err.max(), scale)
    # The upsampling's borders (its first and last row and column).
    border = np.concatenate([err[:, [0, -1]].ravel(),
                             err[:, :, [0, -1]].ravel()])
    assert border.max() <= tol * scale


@pytest.mark.parametrize("head", ["deconv_output", "deconv_then_output"])
def test_bridge_lays_out_keypoint_deconvs(head):
    _set(HEADS[head])
    tree = jax.tree.map(np.asarray, _head_params(4))
    p = bridge.to_torch(tree, "cpu")
    w = tree["kps_outs"]["kps_score"]["w"]          # (4, 4, in, 17) HWIO
    np.testing.assert_array_equal(
        p["kps_outs"]["kps_score"]["w"].numpy(),
        w[::-1, ::-1].transpose(2, 3, 0, 1))        # (in, 17, 4, 4)
    if head == "deconv_then_output":
        w = tree["kps_outs"]["kps_deconv"]["w"]
        np.testing.assert_array_equal(
            p["kps_outs"]["kps_deconv"]["w"].numpy(),
            w[::-1, ::-1].transpose(2, 3, 0, 1))
    w = tree["kps_head"]["convs"][0]["w"]
    np.testing.assert_array_equal(p["kps_head"]["convs"][0]["w"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    back = bridge.to_jax_layout(p)
    for (path, a), (_, b) in zip(port_opt.flatten(back),
                                 port_opt.flatten(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.fixture(scope="module")
def tree():
    _set()
    t = jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(0)))
    assert "kps_head" in t and "mask_head" not in t
    t = calibrate_detector_params(t, np.random.RandomState(0))
    # Scores that spread: the person class's logit bias up by 3.
    t["box_outs"]["cls_score"]["b"][1] += 3.0
    return t


def test_detect_graph_with_keypoints_matches_jax(tree):
    _set()
    images = _images(0.3)
    ref = jax.jit(jax_test.detect_graph)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(IM_INFO))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                 torch.from_numpy(images),
                                 torch.from_numpy(IM_INFO))
    assert set(got) == set(ref) == {"boxes", "scores", "classes", "valid",
                                    "kps_heatmaps"}
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape, k
    assert ref["kps_heatmaps"].shape[2:] == (28, 28, 17)
    assert got["kps_heatmaps"].dtype == torch.float32
    assert ref["valid"].sum() >= 10
    _assert_detections_match(got, ref)
    # Heatmaps of matched detections (same box, score and class).
    hm = got["kps_heatmaps"].numpy()
    n = 0
    for b in range(2):
        rv, gv = ref["valid"][b], got["valid"].numpy()[b]
        rb, gb = ref["boxes"][b][rv], got["boxes"].numpy()[b][gv]
        for i in range(len(rb)):
            d = np.abs(gb - rb[i]).max(1)
            j = int(d.argmin())
            if d[j] > 1e-3:
                continue
            r = ref["kps_heatmaps"][b][rv][i]
            err = np.abs(hm[b][gv][j] - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (b, i, err)
            n += 1
    assert n >= 0.95 * ref["valid"].sum()


def _kps_case(seed):
    """RoIs (B, F, 4), fg (B, F), gt_idx (B, F) and gt keypoints
    (B, G, K, 3) with invisible keypoints, keypoints outside their RoI and
    keypoints on a RoI's right and bottom edges."""
    rng = np.random.RandomState(seed)
    Bn, F, Gn, K = 2, 16, 5, 17
    xy = rng.uniform(0, 200, (Bn, F, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 120, (Bn, F, 2))],
                          -1).astype(np.float32)
    fg = rng.rand(Bn, F) < 0.7
    gt_idx = rng.randint(0, Gn, (Bn, F)).astype(np.int32)
    kps = np.zeros((Bn, Gn, K, 3), np.float32)
    kps[..., :2] = rng.uniform(0, 330, (Bn, Gn, K, 2))
    kps[..., 2] = rng.randint(0, 3, (Bn, Gn, K))
    # Edge cases: a keypoint exactly on its RoI's x2 and one on its y2.
    kps[0, gt_idx[0, 0], 3, 0] = rois[0, 0, 2]
    kps[0, gt_idx[0, 0], 3, 1] = rois[0, 0, 1] + 1.0
    kps[0, gt_idx[0, 0], 3, 2] = 2
    kps[1, gt_idx[1, 2], 5, 0] = rois[1, 2, 0] + 1.0
    kps[1, gt_idx[1, 2], 5, 1] = rois[1, 2, 3]
    kps[1, gt_idx[1, 2], 5, 2] = 1
    fg[0, 0] = fg[1, 2] = True
    return rois, fg, gt_idx, kps


def test_keypoint_targets_match_jax_exactly():
    _set()
    rois, fg, gt_idx, kps = _kps_case(0)
    ref_bins, ref_w = jax.vmap(jax_targets.keypoint_targets_one_image)(
        *map(jnp.asarray, (rois, fg, gt_idx, kps)))
    bins, w = port_targets.keypoint_targets(
        *map(torch.from_numpy, (rois, fg, gt_idx, kps)))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(ref_bins))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))
    assert 0 < float(w.mean()) < 1
    # The two edge keypoints land in the last column and the last row.
    S = 28
    assert w[0, 0, 3] == 1 and int(bins[0, 0, 3]) % S == S - 1
    assert w[1, 2, 5] == 1 and int(bins[1, 2, 5]) // S == S - 1


@pytest.mark.parametrize("normalize", [True, False])
def test_keypoint_losses_match_jax(normalize):
    _set(["KRCNN.NORMALIZE_BY_VISIBLE_KEYPOINTS", str(normalize),
          "KRCNN.LOSS_WEIGHT", "1.5"])
    rng = np.random.RandomState(2)
    logits = rng.randn(12, 28, 28, 17).astype(np.float32) * 3
    bins = rng.randint(0, 28 * 28, (12, 17)).astype(np.int32)
    weights = (rng.rand(12, 17) < 0.6).astype(np.float32)
    ref = float(jax_losses.keypoint_losses(
        jnp.asarray(logits), jnp.asarray(bins), jnp.asarray(weights)))
    got = float(port_losses.keypoint_losses(
        torch.from_numpy(logits), torch.from_numpy(bins),
        torch.from_numpy(weights)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert ref > 0


def _kps_batch():
    """test_torch_train_step._batch(False), every gt a person, with gt
    keypoints inside the gt boxes (scaled coords), some invisible."""
    batch = _batch(False)
    batch["gt_classes"] = batch["gt_valid"].astype(np.int32)
    rng = np.random.RandomState(5)
    kps = np.zeros((B, G, 17, 3), np.float32)
    gb = batch["gt_boxes"]
    u = rng.uniform(0.05, 0.95, (B, G, 17, 2))
    kps[..., 0] = gb[:, :, None, 0] + u[..., 0] * (gb[:, :, None, 2]
                                                   - gb[:, :, None, 0])
    kps[..., 1] = gb[:, :, None, 1] + u[..., 1] * (gb[:, :, None, 3]
                                                   - gb[:, :, None, 1])
    kps[..., 2] = rng.choice([0, 1, 2], (B, G, 17), p=[0.2, 0.3, 0.5])
    kps *= batch["gt_valid"][:, :, None, None]
    batch["gt_keypoints"] = kps
    return batch


@pytest.fixture(scope="module")
def train_case():
    set_cfgs(mask_on=False, extra=KPS_TRAIN_KEYS)
    tree = jax.tree.map(np.asarray, jax_mb.init_model(jax.random.PRNGKey(0)))
    batch = _kps_batch()
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jax.jit(_jax_step)(jp, jax_opt.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, batch), key)
    n_anchors, n_rois = port_tg.draw_sizes((H, W), G)
    return dict(tree=tree, ref=ref,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                draws=_replay_draws(key, n_anchors, n_rois))


def test_keypoint_train_step_matches_jax(train_case):
    set_cfgs(mask_on=False, extra=KPS_TRAIN_KEYS)
    total, parts, grads, new_params, lr = train_case["ref"]
    params = bridge.to_torch(train_case["tree"], "cpu")
    got_total, got_parts, got_grads = port_ts.loss_and_grads(
        params, train_case["batch"], train_case["draws"])
    assert set(got_parts) == set(parts) and "loss_kps" in parts
    assert float(parts["loss_kps"]) > 0
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    got_grads = bridge.to_jax_layout(got_grads)
    _close_tree({k: got_grads[k] for k in ("kps_head", "kps_outs")},
                {k: grads[k] for k in ("kps_head", "kps_outs")}, 1e-4,
                "keypoint grad")
    _close_tree(got_grads, grads, 1e-3, "grad")
    assert float(np.abs(got_grads["kps_head"]["convs"][0]["w"]).max()) > 0

    new_p, _, stats = port_ts.train_step(
        params, port_opt.init_opt_state(params), train_case["batch"],
        train_case["draws"])
    np.testing.assert_allclose(float(stats["lr"]), float(lr), rtol=1e-7)
    _close_tree(bridge.to_jax_layout(new_p), new_params, 1e-5, "params")


def test_heatmap_size_mismatch_raises():
    """The repository's e2e_keypoint_rcnn_R-50-FPN_1x.yaml pairs
    ROI_XFORM_RESOLUTION 7 with HEATMAP_SIZE 56: 28 x 28 heatmaps against
    targets binned on 56 x 56."""
    set_cfgs(mask_on=False, extra=KPS_TRAIN_KEYS + [
        "KRCNN.ROI_XFORM_RESOLUTION", "7", "KRCNN.HEATMAP_SIZE", "56"])
    with pytest.raises(ValueError,
                       match=r"28 x 28 heatmaps .*HEATMAP_SIZE is 56"):
        port_tg.training_losses({}, {}, {})


def test_synthetic_train_batch_with_keypoints_matches_jax():
    set_cfgs(mask_on=False, extra=KPS_TRAIN_KEYS)
    ref = jax_synthetic.synthetic_train_batch(3, 256, 320,
                                              np.random.RandomState(4))
    got = port_synthetic.synthetic_train_batch(3, 256, 320, "cpu",
                                               np.random.RandomState(4))
    assert set(got) == set(ref) and "gt_keypoints" in got
    assert tuple(got["gt_keypoints"].shape) == (3, 8, 17, 3)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
