"""Training targets of the PyTorch port (models/targets.py) against the JAX
package's (detectron_tpu/models/targets.py), per image of a batch of two.

The JAX functions draw their sampling uniforms from a key; the test draws
the same uniforms from the same key splits (targets.py:97-105, :157-163)
and hands them to the port, which takes its randomness as tensors. Labels,
fg/valid masks, sampled RoIs and matched gt indices must be equal exactly
(the rankings are stable sorts in both, so ties resolve alike); box
targets agree to 1e-5 (log and divide round alike in f32 but may differ by
an ulp); mask targets are {0, 1} and must be equal. The JAX mask targets
are evaluated op by op here: under jit, XLA rewrites the coordinate
arithmetic (x / gh * Mh) and moves samples by an ulp, which flips the few
samples that sit on the 0.5 threshold against JAX's own eager result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import targets as jax_T
from detectron_tpu_torch.models import targets as port_T
from detectron_tpu_torch.ops import anchors as port_anchors
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(2)

B, G, H, W = 2, 8, 128, 160


def _uniforms(key, n):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (n,))),
            np.asarray(jax.random.uniform(k2, (n,))))


def _gt(rng):
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    classes = np.zeros((B, G), np.int32)
    for b in range(B):
        n = 3 + 2 * b
        xy = rng.uniform(0, 100, (n, 2))
        boxes[b, :n] = np.concatenate([xy, xy + rng.uniform(12, 60, (n, 2))],
                                      1)
        valid[b, :n] = True
        classes[b, :n] = rng.randint(1, 4, n)
    boxes[1, 1] = boxes[1, 0]   # a duplicate gt: ties in the per-gt best
    return boxes, valid, classes


def _anchors():
    return np.concatenate([port_anchors.anchor_field(
        s, (32 * s // 4,), (0.5, 1, 2), H // s, W // s) for s in (4, 8, 16)])


@pytest.mark.parametrize("straddle", [0, -1])
def test_rpn_targets_match_jax(straddle):
    set_cfgs(extra=TRAIN_KEYS + ["TRAIN.RPN_STRADDLE_THRESH", str(straddle)])
    rng = np.random.RandomState(1 + straddle)
    anchors = _anchors()
    A = anchors.shape[0]
    gt, gv, _ = _gt(rng)
    im_hw = np.array([[120.0, 150.0], [H, W]], np.float32)
    fn = jax.jit(lambda *a: jax_T.rpn_targets_one_image(*a))
    keys = [jax.random.PRNGKey(10 + b) for b in range(B)]
    ref = [fn(jnp.asarray(anchors), jnp.asarray(gt[b]), jnp.asarray(gv[b]),
              jnp.asarray(im_hw[b]), keys[b]) for b in range(B)]
    u = [_uniforms(k, A) for k in keys]
    got = port_T.rpn_targets(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.from_numpy(gv), torch.from_numpy(im_hw),
        torch.from_numpy(np.stack([x[0] for x in u])),
        torch.from_numpy(np.stack([x[1] for x in u])))
    for b in range(B):
        np.testing.assert_array_equal(got["labels"][b].numpy(),
                                      np.asarray(ref[b]["labels"]))
        np.testing.assert_array_equal(got["fg"][b].numpy(),
                                      np.asarray(ref[b]["fg"]))
        np.testing.assert_allclose(got["bbox_targets"][b].numpy(),
                                   np.asarray(ref[b]["bbox_targets"]),
                                   rtol=1e-5, atol=1e-5)
        assert (np.asarray(ref[b]["labels"]) == 1).sum() > 0
        assert (np.asarray(ref[b]["labels"]) == 0).sum() > 0


def _proposals(rng, gt, gv, P=48):
    props = rng.uniform(0, 100, (B, P, 2))
    props = np.concatenate([props, props + rng.uniform(8, 60, (B, P, 2))],
                           -1).astype(np.float32)
    for b in range(B):
        for i in range(int(gv[b].sum()) * 3):
            props[b, i] = gt[b, i % gv[b].sum()] + rng.uniform(-4, 4, 4)
    valid = rng.rand(B, P) < 0.9
    return props, valid


@pytest.mark.parametrize("with_crowd", [False, True])
def test_sample_rois_and_mask_targets_match_jax(with_crowd):
    set_cfgs(extra=TRAIN_KEYS)
    rng = np.random.RandomState(3 + with_crowd)
    gt, gv, gc = _gt(rng)
    props, pv = _proposals(rng, gt, gv)
    crowd = np.zeros((B, 2, 4), np.float32)
    cv = np.zeros((B, 2), bool)
    if with_crowd:
        crowd[:, 0] = [60.0, 60.0, 150.0, 120.0]
        cv[:, 0] = True
    fn = jax.jit(lambda *a: jax_T.sample_rois_one_image(*a))
    keys = [jax.random.PRNGKey(20 + b) for b in range(B)]
    ref = [fn(*(jnp.asarray(x[b]) for x in (props, pv, gt, gc, gv, crowd,
                                            cv)), keys[b])
           for b in range(B)]
    u = [_uniforms(k, props.shape[1] + G) for k in keys]
    got = port_T.sample_rois(
        *(torch.from_numpy(x) for x in (props, pv, gt, gc, gv, crowd, cv)),
        torch.from_numpy(np.stack([x[0] for x in u])),
        torch.from_numpy(np.stack([x[1] for x in u])))
    for b in range(B):
        r = {k: np.asarray(v) for k, v in ref[b].items()}
        assert r["fg"].sum() > 0 and (r["valid"] & ~r["fg"]).sum() > 0
        for k in ("rois", "labels", "valid", "fg", "gt_idx"):
            np.testing.assert_array_equal(got[k][b].numpy(), r[k],
                                          err_msg=k)
        np.testing.assert_allclose(got["bbox_targets"][b].numpy(),
                                   r["bbox_targets"], rtol=1e-5, atol=1e-5)

    # Mask targets of the fg-first slice, from 28 x 28 gt masks.
    F, res = 8, 14
    masks = np.zeros((B, G, 28, 28), np.float32)
    for b in range(B):
        for g in range(G):
            y0, x0 = rng.randint(0, 10, 2)
            masks[b, g, y0:y0 + 14 + g, x0:x0 + 12 + b] = 1.0
    for b in range(B):
        r = ref[b]
        mt, mw = jax_T.mask_targets_one_image(
            r["rois"][:F], r["fg"][:F], r["gt_idx"][:F], jnp.asarray(gt[b]),
            jnp.asarray(masks[b]), res)
        pt, pw = port_T.mask_targets(
            got["rois"][b:b + 1, :F], got["fg"][b:b + 1, :F],
            got["gt_idx"][b:b + 1, :F], torch.from_numpy(gt[b:b + 1]),
            torch.from_numpy(masks[b:b + 1]), res)
        assert 0 < float(np.asarray(mt).mean()) < 1
        np.testing.assert_array_equal(pt[0].numpy(), np.asarray(mt))
        np.testing.assert_array_equal(pw[0].numpy(), np.asarray(mw))
