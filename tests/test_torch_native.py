"""The port's native host ops (detectron_tpu_torch/native, C++ built with g++
at the first call) against their numpy twins (`*_plain` in data/rle.py and
utils/boxes.py, which hold cython_nms's and the COCO API's bits) and the
JAX package's detectron_tpu.native, on seeded inputs, exactly:

- nms (float32 and float64 dets, Python-float and numpy thresholds),
  bbox_overlaps, rle_encode / rle_decode, poly_to_counts on 400 random
  polygons with vertices on and near pixel edges and half-pixels,
  rle_intersection and the mask IoU built on it;
- rle.encode_counts and boxes.nms reach the library (its call counts);
- a build with a compiler that does not exist raises, naming it;
- where the JAX package's copy departs from the numpy twin (its NMS
  stable-sorts tied scores and computes a float32 IoU in double; its
  encoder casts a mask to uint8, so 0.5 and 256 encode as 0), a test
  shows the JAX copy differing and the port's equal to the twin.
"""

import numpy as np
import pytest

from detectron_tpu import native as jax_native
from detectron_tpu.data import rle as jax_rle
from detectron_tpu_torch import native
from detectron_tpu_torch.data import rle
from detectron_tpu_torch.utils import boxes


def _dets(rng, n, integer=False):
    if integer:
        xy = rng.randint(0, 40, (n, 2))
        wh = rng.randint(1, 12, (n, 2))
        s = rng.permutation(n) / n
    else:
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(5, 40, (n, 2))
        s = rng.rand(n)
    return np.hstack([xy, xy + wh, s[:, None]]).astype(np.float32)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.6, 0.7, np.float64(0.3),
                                    np.float32(0.6)])
def test_nms_equals_the_numpy_twin(integer, thresh):
    """Both dtypes; integer boxes give IoUs of exact ratios such as 3 / 10,
    which float32 rounds above 0.3 (the twin then compares in float32
    against a Python float and in float64 against a numpy float64)."""
    rng = np.random.RandomState(0)
    for n in (1, 2, 17, 200, 513):
        dets = _dets(rng, n, integer)
        for d in (dets, dets.astype(np.float64)):
            assert native.nms(d, thresh) == boxes.nms_plain(d, thresh)
    assert native.nms(np.zeros((0, 5), np.float32), 0.5) == []


def test_nms_equals_jax_native_on_untied_scores():
    rng = np.random.RandomState(3)
    for n in (1, 17, 200, 513):
        dets = _dets(rng, n)
        for t in (0.3, 0.5, 0.7):
            assert native.nms(dets, t) == jax_native.nms(dets, t) == \
                boxes.nms_plain(dets, t)


def test_jax_native_nms_departs_from_the_numpy_twin():
    """A fault of the reference: with tied scores the JAX copy keeps the
    other box (std::stable_sort against argsort()[::-1]); and it computes
    a float32 IoU in double: an IoU of 7 / 10 is 0.69999999999999996 in
    double, above float32(0.7), and the JAX copy suppresses, where float32
    gives float32(0.7) itself, not above the threshold, and the twin keeps
    both boxes."""
    tied = np.array([[0, 0, 10, 10, 0.5], [1, 1, 11, 11, 0.5]], np.float32)
    assert boxes.nms_plain(tied, 0.3) == native.nms(tied, 0.3) == [1]
    assert jax_native.nms(tied, 0.3) == [0]
    ratio = np.array([[0, 0, 9, 0, 0.9], [0, 0, 6, 0, 0.8]], np.float32)
    assert boxes.nms_plain(ratio, 0.7) == native.nms(ratio, 0.7) == [0, 1]
    assert jax_native.nms(ratio, 0.7) == [0]


def test_bbox_overlaps_equals_numpy_and_jax():
    rng = np.random.RandomState(1)
    a = _dets(rng, 31)[:, :4]
    b = _dets(rng, 13, integer=True)[:, :4]
    got = native.bbox_overlaps(a, b)
    np.testing.assert_array_equal(got, boxes.bbox_overlaps(a, b))
    np.testing.assert_array_equal(got, jax_native.bbox_overlaps(a, b))
    assert native.bbox_overlaps(a[:0], b).shape == (0, 13)


@pytest.mark.parametrize("shape", [(37, 23), (1, 1), (0, 5), (96, 128)])
def test_rle_encode_decode_equal_numpy_and_jax(shape):
    rng = np.random.RandomState(2)
    for p in (0.0, 0.3, 0.6, 1.0):
        m = (rng.rand(*shape) < p).astype(np.uint8)
        counts = native.rle_encode(m)
        assert counts == rle.encode_counts_plain(m)
        assert counts == jax_native.rle_encode(m)
        got = native.rle_decode(counts, *shape)
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(
            got, rle.decode_counts_plain(counts, *shape))
        assert got.dtype == np.uint8
    with pytest.raises(ValueError, match="does not match"):
        native.rle_decode([3, 4], 3, 3)


def test_jax_native_encode_departs_on_non_binary_masks():
    """A fault of the reference: its bridge casts the mask to uint8, so a
    0.5 or a 256 encodes as 0; the twin (and the port) take any nonzero
    value as 1."""
    rng = np.random.RandomState(4)
    for m in ((rng.rand(20, 30) < 0.5) * 0.5,
              (rng.rand(20, 30) < 0.5).astype(np.int64) * 256):
        assert native.rle_encode(m) == rle.encode_counts_plain(m)
        assert jax_native.rle_encode(m) != rle.encode_counts_plain(m)


def _edge_polygon(rng, h, w):
    """Vertices on pixel edges, at half pixels and within 1e-9 of both,
    some outside the image."""
    k = rng.randint(3, 9)
    frac = rng.choice([0.0, 0.5, -0.5, 0.1, 0.2, 0.3, 0.4, 0.6, 1e-9,
                       -1e-9, 0.5 + 1e-9, 0.5 - 1e-9], (k, 2))
    xs = rng.randint(-3, w + 3, k) + frac[:, 0]
    ys = rng.randint(-3, h + 3, k) + frac[:, 1]
    return np.stack([xs, ys], 1).reshape(-1).tolist()


def test_poly_to_counts_equals_numpy_and_jax():
    rng = np.random.RandomState(5)
    for _ in range(400):
        h, w = rng.randint(5, 60, 2)
        p = _edge_polygon(rng, h, w)
        counts = native.poly_to_counts(p, h, w)
        assert counts == rle.poly_to_counts_plain(p, h, w), (p, h, w)
        assert counts == jax_native.poly_to_counts(p, h, w), (p, h, w)


def test_rle_intersection_and_iou_equal_numpy_and_jax():
    rng = np.random.RandomState(6)
    h, w = 40, 30
    masks = [(rng.rand(h, w) < rng.rand()).astype(np.uint8)
             for _ in range(9)]
    cs = [native.rle_encode(m) for m in masks]
    for i in range(9):
        for j in range(9):
            inter = int(np.logical_and(masks[i], masks[j]).sum())
            assert native.rle_intersection(cs[i], cs[j]) == inter
            assert jax_native.rle_intersection(cs[i], cs[j]) == inter
    dts, gts = [rle.encode(m) for m in masks[:5]], [
        rle.encode(m) for m in masks[5:]]
    crowd = [0, 1, 0, 1]
    got = rle.iou(dts, gts, crowd)
    np.testing.assert_array_equal(got, rle.iou_plain(dts, gts, crowd))
    np.testing.assert_array_equal(got, jax_rle.iou(dts, gts, crowd))


def test_engine_functions_reach_the_library():
    rng = np.random.RandomState(7)
    before = {f: getattr(native, f).calls for f in (
        "nms", "rle_encode", "rle_decode", "poly_to_counts",
        "rle_intersection")}
    m = (rng.rand(12, 9) < 0.5).astype(np.uint8)
    rle.decode(rle.encode(m))
    boxes.nms(_dets(rng, 8), 0.5)
    r = rle.frPyObjects([[1, 1, 8, 1, 8, 8]], 12, 9)[0]
    rle.iou([r], [r], [0])
    assert {f: getattr(native, f).calls - n for f, n in before.items()} == {
        "nms": 1, "rle_encode": 1, "rle_decode": 1, "poly_to_counts": 1,
        "rle_intersection": 1}


def test_a_missing_compiler_raises_naming_it(tmp_path):
    cxx = str(tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.build(cxx=cxx, build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_a_failing_build_raises_with_its_output(tmp_path):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'error: this compiler refuses' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="this compiler refuses"):
        native.build(cxx=str(fake), build_dir=tmp_path / "build")
