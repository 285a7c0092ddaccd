"""The port's host utilities against the JAX package's, on the same seeded
numpy inputs: utils/boxes (nms, soft_nms, box_voting, expand_boxes,
unique_boxes, bbox_overlaps), data/rle (the mask codec, encode_crop, the
compressed-string codec, frPyObjects, iou) and utils/net (a checkpoint the
JAX package's save_ckpt wrote loads into the same tree, and one the port
wrote loads into the JAX package). Host numpy on both sides, with the JAX
package's C++ host ops where it has built them: results must be equal
(exactly, or to 1e-6 relative where the score arithmetic is float32),
and RLE strings byte-identical."""

import numpy as np
import pytest

from detectron_tpu.data import rle as jax_rle
from detectron_tpu.utils import boxes as jax_boxes
from detectron_tpu.utils import net as jax_net
from detectron_tpu_torch.data import rle
from detectron_tpu_torch.utils import boxes
from detectron_tpu_torch.utils import net


def _dets(seed, n=60):
    """n boxes in 4 clusters (so NMS and voting have overlaps to act on)
    with distinct scores."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(40, 200, (4, 2))
    c = centers[rng.randint(0, 4, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    d = np.concatenate([c - wh / 2, c + wh / 2,
                        rng.permutation(n)[:, None] / n * 0.9 + 0.05], 1)
    return d.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("thresh", [0.3, 0.5])
def test_nms_matches_jax(seed, thresh):
    d = _dets(seed)
    assert boxes.nms(d, thresh) == list(jax_boxes.nms(d, thresh))
    assert boxes.nms(d[:0], thresh) == []


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(method):
    d = _dets(2)
    kw = dict(sigma=0.5, overlap_thresh=0.3, score_thresh=0.001,
              method=method)
    got, got_i = boxes.soft_nms(d, **kw)
    ref, ref_i = jax_boxes.soft_nms(d, **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_i, ref_i)
    assert len(got) < len(d) or method == "gaussian"


@pytest.mark.parametrize("scoring", ["ID", "TEMP_AVG", "AVG", "IOU_AVG",
                                     "GENERALIZED_AVG", "QUASI_SUM"])
def test_box_voting_matches_jax(scoring):
    d = _dets(3)
    top = d[boxes.nms(d, 0.5)]
    got = boxes.box_voting(top, d, 0.6, scoring_method=scoring, beta=2.0)
    ref = jax_boxes.box_voting(top, d, 0.6, scoring_method=scoring,
                               beta=2.0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_box_geometry_matches_jax():
    rng = np.random.RandomState(4)
    b = _dets(4)[:, :4].astype(np.float64)
    q = _dets(5)[:20, :4]
    for scale in (1.0, 16 / 14, 30 / 28):
        np.testing.assert_array_equal(boxes.expand_boxes(b, scale),
                                      jax_boxes.expand_boxes(b, scale))
    dup = np.concatenate([b, b[::3] + rng.uniform(-0.4, 0.4, b[::3].shape)])
    for scale in (1.0, 1 / 16):
        np.testing.assert_array_equal(boxes.unique_boxes(dup, scale),
                                      jax_boxes.unique_boxes(dup, scale))
    np.testing.assert_array_equal(boxes.bbox_overlaps(b, q),
                                  jax_boxes.bbox_overlaps(b, q))
    np.testing.assert_array_equal(boxes.xyxy_to_xywh(b),
                                  jax_boxes.xyxy_to_xywh(b))
    np.testing.assert_array_equal(boxes.xywh_to_xyxy(b),
                                  jax_boxes.xywh_to_xyxy(b))
    assert boxes.xywh_to_xyxy([3.0, 4.0, 10.5, 0.5]) == \
        jax_boxes.xywh_to_xyxy([3.0, 4.0, 10.5, 0.5])
    np.testing.assert_array_equal(
        boxes.clip_boxes_to_image(b.copy(), 120, 150),
        jax_boxes.clip_boxes_to_image(b.copy(), 120, 150))
    np.testing.assert_array_equal(boxes.filter_small_boxes(b, 30),
                                  jax_boxes.filter_small_boxes(b, 30))


def _masks(seed):
    """Random blobby masks, including empty, full and edge-touching ones."""
    rng = np.random.RandomState(seed)
    out = [np.zeros((7, 9), np.uint8), np.ones((7, 9), np.uint8)]
    for h, w in [(17, 23), (40, 31), (1, 12), (12, 1)]:
        m = (rng.rand(h, w) > 0.5).astype(np.uint8)
        out.append(m)
        out.append((np.cumsum(m, 0) % 3 == 0).astype(np.uint8))
    return out


def test_rle_codec_matches_jax():
    for m in _masks(0):
        counts = rle.encode_counts(m)
        assert counts == list(jax_rle.encode_counts(m))
        s = rle.counts_to_string(counts)
        assert s == jax_rle.counts_to_string(counts)
        assert rle.string_to_counts(s) == jax_rle.string_to_counts(s)
        r = rle.encode(m)
        assert r == jax_rle.encode(m)
        np.testing.assert_array_equal(rle.decode(r), m)
        np.testing.assert_array_equal(rle.decode(r), jax_rle.decode(r))
        assert rle.area(r) == jax_rle.area(r) == int(m.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_crop_matches_jax_and_full_paste(seed):
    rng = np.random.RandomState(seed)
    h, w = 37, 53
    for _ in range(20):
        ch, cw = rng.randint(0, h + 1), rng.randint(0, w + 1)
        y0, x0 = rng.randint(0, h - ch + 1), rng.randint(0, w - cw + 1)
        if rng.rand() < 0.2:  # full-height crops: runs cross columns
            y0, ch = 0, h
        crop = (rng.rand(ch, cw) > rng.uniform(0.2, 0.8)).astype(np.uint8)
        canvas = np.zeros((h, w), np.uint8)
        canvas[y0:y0 + ch, x0:x0 + cw] = crop
        got = rle.encode_crop(crop, x0, y0, h, w)
        assert got == jax_rle.encode_crop(crop, x0, y0, h, w)
        assert got == rle.encode(canvas)


def test_polygons_and_iou_match_jax():
    h, w = 60, 80
    polys = [[[5.2, 4.1, 40.7, 6.3, 35.5, 30.2, 8.9, 25.0]],
             [[20.0, 20.0, 70.5, 22.0, 60.0, 55.5], [1.0, 50.0, 10.0, 58.0,
                                                     3.0, 59.0]],
             [[0.0, 0.0, 79.0, 0.0, 79.0, 59.0, 0.0, 59.0]]]
    rles = []
    for p in polys:
        got = rle.frPyObjects(p, h, w)
        assert got == jax_rle.frPyObjects(p, h, w)
        assert rle.frPyObjects(p[0], h, w) == jax_rle.frPyObjects(p[0], h, w)
        merged = rle.merge(got)
        assert merged == jax_rle.merge(got)
        np.testing.assert_array_equal(rle.decode(merged),
                                      jax_rle.polys_to_mask(p, h, w))
        rles.append(merged)
    raw = {"size": [h, w], "counts": rle.encode_counts(
        rle.decode(rles[1]))}
    assert rle.frPyObjects(raw, h, w) == jax_rle.frPyObjects(raw, h, w)
    for crowd in ([0, 0, 0], [0, 1, 1]):
        np.testing.assert_array_equal(rle.iou(rles, rles[::-1], crowd),
                                      jax_rle.iou(rles, rles[::-1], crowd))


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by the JAX package loads into the port as the
    same tree (lists of blocks included), and the other way round."""
    rng = np.random.RandomState(0)
    params = {"body": {"res2": [{"w": rng.randn(3, 3, 4, 8).astype(
        np.float32)}, {"w": rng.randn(1, 1, 8, 8).astype(np.float32)}]},
        "box_outs": {"cls_score": {"b": rng.randn(5).astype(np.float32)}}}
    opt = {"momentum": {"box_outs": {"cls_score": {"b": np.ones(5)}}}}

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype

    d = jax_net.save_ckpt(str(tmp_path / "jax"), 7, params, opt,
                          meta={"cfg": "x"})
    same(net.load_ckpt_params(d), params)
    step, payload = net.load_ckpt(d)
    assert step == 7
    same(payload["opt_state"], opt)

    d = net.save_ckpt(str(tmp_path / "port"), 3, params, name="model_final")
    assert d.endswith("model_final")
    same(jax_net.load_ckpt_params(d), params)
