"""Proposal generation of the PyTorch port against the JAX package:
topk_chunked's index set under heavy ties, and generate_proposals (top-k,
decode, clip, min-size filter, per-level NMS through kernel K1's plain
version, cross-level collect) in its compacted form (the tiny config, post
64 < pre 256) and its keep-mask form (post == pre). Boxes agree to 1e-3
pixels and scores to 1e-6 (decode and sigmoid round in other places);
validity and the tie order are exact. The five RPN levels' NMS runs as
one stacked K1 call, which gives each level what one call per level
gives (keep masks, compacted form and generate_proposals' output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.ops import topk as jax_topk
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.ops import nms as port_nms
from detectron_tpu_torch.ops import topk as port_topk
from detectron_tpu_torch.ops.cuda import nms_kernel as port_nms_kernel
from test_torch_util import set_cfgs

torch.set_num_threads(2)


@pytest.mark.parametrize("n,k,levels", [
    (15360, 256, 3),    # P2 of the tiny canvas: two-stage chunking
    (209664, 1000, 4),  # P2 of an 832 x 1344 canvas
    (960, 256, 2),      # n < 4k: one stable sort
])
def test_topk_chunked_index_set_under_ties(n, k, levels):
    """Thousands of equal scores (a zero-padded canvas gives equal RPN
    logits): values AND indices equal JAX's lowest-index-first choice."""
    rng = np.random.RandomState(n)
    x = rng.randint(0, levels, (2, n)).astype(np.float32)
    x[:, rng.rand(n) < 0.01] += rng.rand(int((rng.rand(n) < 0.01).sum()) or
                                         1)[0]
    rv, ri = jax.jit(jax_topk.topk_chunked, static_argnums=1)(
        jnp.asarray(x), k)
    gv, gi = port_topk.topk_chunked(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def _rpn_outs(seed, H, W, A=3, B=2):
    """Per-level RPN outputs of a 256 x 320 canvas whose lower-right part
    is zero padding: there logits and deltas are constant (equal scores)."""
    rng = np.random.RandomState(seed)
    outs = []
    for s in (4, 8, 16, 32, 64):
        h, w = H // s, W // s
        cl = rng.randn(B, h, w, A).astype(np.float32)
        bp = (rng.randn(B, h, w, 4 * A) * 0.3).astype(np.float32)
        cl[1, h * 3 // 4:] = -0.25
        bp[1, h * 3 // 4:] = 0.1
        cl[:, :, w * 7 // 8:] = -0.5
        bp[:, :, w * 7 // 8:] = 0.0
        outs.append((cl, bp))
    return outs


@pytest.mark.parametrize("post_n", [64, 256])
def test_generate_proposals_matches_jax(post_n):
    set_cfgs(extra=["TEST.RPN_POST_NMS_TOP_N", str(post_n),
                    "TEST.RPN_MIN_SIZE", "2"])
    outs = _rpn_outs(post_n, 256, 320)
    im_info = np.array([[250.0, 310.0, 1.0], [190.0, 280.0, 1.5]],
                       np.float32)
    # A fresh function per cfg: jit traces read the global cfg.
    ref = jax.jit(lambda r, i: jax_mb.generate_proposals(r, None, i, False))(
        [(jnp.asarray(c), jnp.asarray(b)) for c, b in outs],
        jnp.asarray(im_info))
    got = port_mb.generate_proposals(
        [(torch.from_numpy(c), torch.from_numpy(b)) for c, b in outs], None,
        torch.from_numpy(im_info), False)
    rois, scores, valid = (np.asarray(a) for a in ref)
    assert got[0].shape == (2, post_n, 4)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert valid.sum() > post_n
    np.testing.assert_allclose(got[0].numpy()[valid], rois[valid], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy()[valid], scores[valid],
                               atol=1e-6, rtol=0)


def _stacked_lanes(seed, sizes, B=2):
    """Per level, B score-descending lanes of N boxes: -inf holes mid-lane,
    a tail of invalid slots, and exact repeats (IoU 1)."""
    rng = np.random.RandomState(seed)
    boxes, scores = [], []
    for N in sizes:
        xy = rng.uniform(0, 120, (B, N, 2))
        b = np.concatenate([xy, xy + rng.uniform(4, 40, (B, N, 2))], -1)
        b[:, 1::9] = b[:, 0::9][:, :b[:, 1::9].shape[1]]
        s = -np.sort(-rng.rand(B, N), axis=1)
        s[rng.rand(B, N) < 0.1] = -np.inf
        s[:, rng.randint(N // 2, N + 1):] = -np.inf
        boxes.append(torch.tensor(b, dtype=torch.float32))
        scores.append(torch.tensor(s, dtype=torch.float32))
    return boxes, scores


def _counting(monkeypatch):
    """Count the port's K1 calls made through ops/nms.py."""
    calls = []

    def keep_mask(boxes, valid, thr):
        calls.append(tuple(valid.shape))
        return port_nms_kernel.nms_keep_mask(boxes, valid, thr)
    monkeypatch.setattr(port_nms, "nms_keep_mask", keep_mask)
    return calls


@pytest.mark.parametrize("thr", [0.7, 0.5])
def test_stacked_keep_masks_equal_one_call_per_level(monkeypatch, thr):
    """Five levels of different N, B = 2 lanes each: one stacked K1 call
    gives each level's keep mask exactly, and nothing past a level's N."""
    sizes = (1000, 960, 240, 60, 12)
    boxes, scores = _stacked_lanes(int(thr * 10), sizes)
    calls = _counting(monkeypatch)
    got = port_nms.nms_stacked_mask(boxes, scores, thr)
    assert calls == [(2 * len(sizes), max(sizes))]
    for b, s, k in zip(boxes, scores, got):
        ref = port_nms.nms_batched_sorted_mask(b, s, thr)
        assert k.shape == ref.shape
        assert torch.equal(k, ref)
        assert k.any() and not k[~torch.isfinite(s)].any()
    idx, valid = port_nms.compact_keep(got[0], 100)
    ref_idx, ref_valid = port_nms.nms_batched_sorted(boxes[0], scores[0],
                                                     thr, 100)
    assert torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)


@pytest.mark.parametrize("post_n", [8, 240, 1000])
def test_generate_proposals_stacked_equals_one_call_per_level(monkeypatch,
                                                              post_n):
    """generate_proposals makes one K1 call for its five RPN levels (N =
    1000, 960, 240, 60, 12 on a 128 x 160 canvas with pre_n 1000, B = 2)
    and gives what one call per level gives: every level compacted
    (post_n 8), mixed forms (240) and every level in the mask form
    (1000)."""
    set_cfgs(extra=["TEST.RPN_PRE_NMS_TOP_N", "1000",
                    "TEST.RPN_POST_NMS_TOP_N", str(post_n),
                    "TEST.RPN_MIN_SIZE", "2"])
    outs = [(torch.from_numpy(c), torch.from_numpy(b))
            for c, b in _rpn_outs(post_n + 1, 128, 160)]
    im_info = torch.tensor([[120.0, 150.0, 1.0], [100.0, 140.0, 1.5]])
    calls = _counting(monkeypatch)
    got = port_mb.generate_proposals(outs, None, im_info, False)
    assert calls == [(10, 1000)]

    def per_level(group_boxes, group_scores, thr):
        return [port_nms.nms_batched_sorted_mask(b, s, thr)
                for b, s in zip(group_boxes, group_scores)]
    monkeypatch.setattr(port_nms, "nms_stacked_mask", per_level)
    del calls[:]
    ref = port_mb.generate_proposals(outs, None, im_info, False)
    assert [n for _, n in calls] == [1000, 960, 240, 60, 12]
    assert got[0].shape == (2, post_n, 4)
    assert int(got[2].sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
