"""The PyTorch port's detection path against the JAX package on the tiny
configuration (256 x 320 canvas, 64 post-NMS RoIs, D = 20), with the same
params: JAX init, calibrated by the port's numpy calibrate_detector_params,
carried to torch by the bridge.

- nms_and_limit_graph on synthetic per-class scores: both the truncated
  (K < R) tail and the untruncated re-run on overflow, exactly.
- Teacher-forced: JAX's own features, proposals and validity go through the
  port's box head, _detect_tail and mask_graph, including a case whose
  class overflows the per-class pre-top-K.
- detect_graph end to end.

Detections are compared as sets: near-equal scores may order differently
when the two frameworks round them differently, so every JAX detection must
find a port detection of the same class with IoU > 0.99 and |score diff| <
1e-4 (at least 95% must, and in practice all do), valid counts must be
equal, and matched mask probabilities agree to 1e-3. Images are scaled by
0.3 where scores should spread out: with random weights and no trained BN
statistics, activations grow through the body and larger inputs saturate
the softmax at 1.0 (the x20 bench-like case is kept too). With zero biases
the body is linear in the input scale, so at x20 the mask logits are ~70x
larger and their f32 rounding differences pass through the sigmoid near
0.5 as up to ~70x larger probability differences: 1e-2 there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_util import set_cfgs

torch.set_num_threads(2)

IM_INFO = np.array([[250.0, 310.0, 1.0], [200.0, 300.0, 1.0]], np.float32)


def _images(scale):
    return np.random.RandomState(0).randn(2, 256, 320, 3).astype(
        np.float32) * scale


@pytest.fixture(scope="module")
def tree():
    set_cfgs()
    t = jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(0)))
    return calibrate_detector_params(t, np.random.RandomState(0))


def _jax_stages(p, x, i):
    """JAX's detect_graph plus the intermediates it feeds _detect_tail."""
    feats, _ = jax_mb.forward_features(p, x)
    rois, _, valid = jax_mb.generate_proposals(
        jax_mb.forward_rpn(p, feats), feats, i, training=False)
    return feats, rois, valid, jax_test.detect_graph(p, x, i)


@pytest.fixture(scope="module")
def jax_stages():
    """Compiled once for the tiny cfg (a jit trace reads the global cfg)."""
    return jax.jit(_jax_stages)


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt + 1, 0, None).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2] + 1).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _assert_detections_match(got, ref, mask_atol=1e-3):
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"].sum(1), ref["valid"].sum(1))
    n_ref = n_matched = 0
    for b in range(ref["valid"].shape[0]):
        rv, gv = ref["valid"][b], got["valid"][b]
        n_ref += int(rv.sum())
        if not rv.any():
            continue
        ok = ((_iou(ref["boxes"][b][rv], got["boxes"][b][gv]) > 0.99)
              & (np.abs(ref["scores"][b][rv][:, None]
                        - got["scores"][b][gv][None, :]) < 1e-4)
              & (ref["classes"][b][rv][:, None]
                 == got["classes"][b][gv][None, :]))
        n_matched += int(ok.any(1).sum())
        if "mask_probs" in ref:
            j = ok.argmax(1)[ok.any(1)]
            np.testing.assert_allclose(
                got["mask_probs"][b][gv][j],
                ref["mask_probs"][b][rv][ok.any(1)], atol=mask_atol, rtol=0)
    assert n_matched >= 0.95 * n_ref, (n_matched, n_ref)


@pytest.mark.parametrize("R,D,n_above", [
    (64, 20, 40),      # K == R: no truncation
    (300, 20, 100),    # K = 128 < R, no class above K
    (300, 20, 200),    # a class above K: the untruncated re-run
])
def test_nms_and_limit_matches_jax(R, D, n_above):
    rng = np.random.RandomState(R + n_above)
    B, Cm1 = 2, 6
    xy = rng.uniform(0, 200, (B, Cm1, R, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (B, Cm1, R, 2))],
                           -1).astype(np.float32)
    scores = np.full((B, Cm1, R), -np.inf, np.float32)
    for b in range(B):
        for c in range(Cm1):
            n = n_above if c == 1 else rng.randint(0, min(n_above, 120))
            idx = rng.choice(R, n, replace=False)
            scores[b, c, idx] = rng.uniform(0.05, 1.0, n)
    scores[0, 2, :10] = 0.5   # equal scores: the tie order must agree
    set_cfgs()
    ref = jax.jit(jax_test.nms_and_limit_graph, static_argnums=2)(
        jnp.asarray(boxes), jnp.asarray(scores), D)
    got = port_test.nms_and_limit_graph(torch.from_numpy(boxes),
                                        torch.from_numpy(scores), D)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("overflow", [False, True])
def test_detect_tail_teacher_forced(tree, jax_stages, overflow,
                                    monkeypatch):
    """JAX intermediates into the port's box head, _detect_tail and
    mask_graph. With overflow, R = 256 proposals and a boosted class-1
    bias put > K = 128 boxes of one class over SCORE_THRESH."""
    set_cfgs(extra=["TEST.RPN_POST_NMS_TOP_N", "256"] if overflow else ())
    params = jax.tree.map(np.array, tree)
    if overflow:
        params["box_outs"]["cls_score"]["b"][1] += 6.0
        jax_stages = jax.jit(lambda *a: _jax_stages(*a))

    feats, rois, valid, ref = jax_stages(
        jax.tree.map(jnp.asarray, params), jnp.asarray(_images(0.3)),
        jnp.asarray(IM_INFO))

    lanes = []
    real_mask = port_test.nms_ops.nms_batched_sorted_mask

    def spy(boxes, scores, thr):
        lanes.append(tuple(scores.shape))
        return real_mask(boxes, scores, thr)

    monkeypatch.setattr(port_test.nms_ops, "nms_batched_sorted_mask", spy)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = port_test._detect_tail(
        bridge.to_torch(params, "cpu"), [t(f) for f in feats],
        [1.0 / 2 ** lvl for lvl in range(2, 7)], t(rois), t(valid),
        t(IM_INFO))
    R = rois.shape[1]
    assert lanes == [(2 * 80, R if overflow else min(R, 128))]
    _assert_detections_match(got, _np(ref))


@pytest.mark.parametrize("scale,mask_atol", [(0.3, 1e-3), (20.0, 1e-2)])
def test_detect_graph_end_to_end(tree, jax_stages, scale, mask_atol):
    set_cfgs()
    images = _images(scale)
    ref = _np(jax_stages(jax.tree.map(jnp.asarray, tree),
                         jnp.asarray(images), jnp.asarray(IM_INFO))[3])
    got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                 torch.from_numpy(images),
                                 torch.from_numpy(IM_INFO))
    assert set(got) == set(ref)
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape, k
    assert ref["valid"].sum() > 0
    _assert_detections_match(got, ref, mask_atol)
