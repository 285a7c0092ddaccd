"""Proposal generation of the PyTorch port against the JAX package:
topk_chunked's index set under heavy ties, and generate_proposals (top-k,
decode, clip, min-size filter, per-level NMS through kernel K1's plain
version, cross-level collect) in its compacted form (the tiny config, post
64 < pre 256) and its keep-mask form (post == pre). Boxes agree to 1e-3
pixels and scores to 1e-6 (decode and sigmoid round in other places);
validity and the tie order are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from detectron_tpu.core import config as jax_config
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.ops import topk as jax_topk
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.ops import topk as port_topk

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
    _tiny_cfg(batch=2)
    jax_config.merge_cfg_from_list(
        ["TEST.RPN_POST_NMS_TOP_N", str(post_n), "TEST.RPN_MIN_SIZE", "2"])
    outs = _rpn_outs(post_n, 256, 320)
    im_info = np.array([[250.0, 310.0, 1.0], [190.0, 280.0, 1.5]],
                       np.float32)
    # A fresh function per cfg: jit traces read the global cfg.
    ref = jax.jit(lambda r, i: jax_mb.generate_proposals(r, None, i, False))(
        [(jnp.asarray(c), jnp.asarray(b)) for c, b in outs],
        jnp.asarray(im_info))
    got = port_mb.generate_proposals(
        [(torch.from_numpy(c), torch.from_numpy(b)) for c, b in outs], None,
        torch.from_numpy(im_info))
    rois, scores, valid = (np.asarray(a) for a in ref)
    assert got[0].shape == (2, post_n, 4)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert valid.sum() > post_n
    np.testing.assert_allclose(got[0].numpy()[valid], rois[valid], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy()[valid], scores[valid],
                               atol=1e-6, rtol=0)
