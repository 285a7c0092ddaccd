"""The port's image input and mask paste without OpenCV, against cv2 and
the JAX package (which calls cv2):

- utils/image_io.imread on binary PPM equals cv2.imread (BGR uint8), and
  other formats go through cv2;
- utils/image_io.resize within 1e-3 of cv2.resize(INTER_LINEAR) on 0-255
  images, at the scales prep_im_for_blob picks (up and down) and at
  mask-paste sizes;
- utils/blob's prep_im_for_blob and get_image_blob against the JAX
  package's, within the same 1e-3;
- core/test_engine.segm_results: RLE strings identical to the JAX
  package's on the same probabilities, except for a mask with a pixel
  whose interpolated value lies within 1e-6 of the 0.5 threshold, where
  the two decoded masks agree everywhere else."""

import cv2
import numpy as np
import pytest

from detectron_tpu.core import config as jax_config
from detectron_tpu.core import test_engine as jax_engine
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.utils import blob as jax_blob
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.utils import blob
from detectron_tpu_torch.utils import boxes as box_utils
from detectron_tpu_torch.utils import image_io
from test_torch_util import set_cfgs

# COCO-typical sizes, both orientations, and the tiny test images.
SHAPES = [(480, 640), (640, 480), (612, 612), (427, 640), (96, 128),
          (128, 96), (375, 500)]


def _image(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,),
                                               np.uint8)


def test_imread_ppm_matches_cv2(tmp_path):
    for i, shape in enumerate(SHAPES[:3] + [(1, 5)]):
        im = _image(shape, i)
        path = str(tmp_path / "{}.ppm".format(i))
        image_io.write_ppm(path, im)
        got = image_io.imread(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, im)
        np.testing.assert_array_equal(got, cv2.imread(path))
    # A header with comments and odd whitespace, as other writers make it.
    im = _image((3, 4), 9)
    path = str(tmp_path / "c.ppm")
    with open(path, "wb") as f:
        f.write(b"P6 # made elsewhere\n4\t3\n# maxval next\n255\n")
        f.write(im[:, :, ::-1].tobytes())
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    # Other formats are cv2's.
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, im)
    np.testing.assert_array_equal(image_io.imread(path), im)


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_matches_cv2_at_blob_scales(shape):
    """Float32 and float64 0-255 images (prep_im_for_blob resizes float64:
    the image minus the float64 PIXEL_MEANS) at the TEST.SCALE 800 / 1333
    scale, the tiny tests' 96 / 128 one, and fixed up and down scales."""
    im = _image(shape).astype(np.float32)
    scales = {800 / min(shape), 1333 / max(shape), 96 / min(shape), 0.37,
              0.5, 1.0, 2.0, 2.7}
    for dtype in (np.float32, np.float64):
        x = im.astype(dtype) - np.array([[[102.9801, 115.9465, 122.7717]]],
                                        dtype)
        for s in scales:
            ref = cv2.resize(x, None, None, fx=s, fy=s,
                             interpolation=cv2.INTER_LINEAR)
            got = image_io.resize(x, fx=s, fy=s)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_resize_matches_cv2_at_mask_paste_sizes():
    rng = np.random.RandomState(0)
    for M in (14, 28):
        p = np.zeros((M + 2, M + 2), np.float32)
        p[1:-1, 1:-1] = rng.rand(M, M)
        for w, h in [(1, 1), (2, 9), (16, 16), (17, 31), (M + 2, 5),
                     (93, 41), (300, 212), (640, 3)]:
            got = image_io.resize(p, (w, h))
            ref = cv2.resize(p, (w, h))
            assert got.shape == ref.shape == (h, w)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    with pytest.raises(TypeError):
        image_io.resize(np.zeros((4, 4), np.uint8), (2, 2))


def test_prep_and_image_blob_match_jax():
    set_cfgs()
    for i, shape in enumerate(SHAPES):
        im = _image(shape, i)
        for target, max_size in ((800, 1333), (96, 128), (600, 1000)):
            got, g_scale = blob.prep_im_for_blob(
                im, port_cfg().PIXEL_MEANS, target, max_size)
            ref, r_scale = jax_blob.prep_im_for_blob(
                im, jax_config.cfg.PIXEL_MEANS, target, max_size)
            assert g_scale == r_scale
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        got = blob.get_image_blob(im)
        ref = jax_blob.get_image_blob(im)
        assert got[0].shape == ref[0].shape and got[0].dtype == ref[0].dtype
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[2], ref[2])
        assert blob.static_canvas(800, 1333, i % 2 == 0) == \
            jax_blob.static_canvas(800, 1333, i % 2 == 0)


def port_cfg():
    from detectron_tpu_torch.core.config import cfg

    return cfg


def _near_threshold(box, probs, im_h, im_w, thresh=0.5, eps=1e-6):
    """The image pixels where the pasted mask of one detection (resized as
    segm_results resizes it) lies within eps of the threshold."""
    M = probs.shape[0]
    ref_box = box_utils.expand_boxes(box[None], (M + 2.0) / M)[0].astype(
        np.int32)
    padded = np.zeros((M + 2, M + 2), np.float32)
    padded[1:-1, 1:-1] = probs
    w = max(ref_box[2] - ref_box[0] + 1, 1)
    h = max(ref_box[3] - ref_box[1] + 1, 1)
    near = np.abs(image_io.resize(padded, (w, h)) - thresh) <= eps
    x0, y0 = max(ref_box[0], 0), max(ref_box[1], 0)
    x1, y1 = min(ref_box[2] + 1, im_w), min(ref_box[3] + 1, im_h)
    out = np.zeros((im_h, im_w), bool)
    if x1 > x0 and y1 > y0:
        out[y0:y1, x0:x1] = near[y0 - ref_box[1]:y1 - ref_box[1],
                                 x0 - ref_box[0]:x1 - ref_box[0]]
    return out


@pytest.mark.parametrize("M", [14, 28])
def test_segm_results_rles_match_jax(M):
    """Detections of every size inside the image, as detect_graph clips
    them (slivers, boxes at the edges, whose expanded paste box crosses
    them, and the whole image), probabilities spread over (0, 1) and a run
    of them at 0.5 +- 1e-3."""
    set_cfgs()
    rng = np.random.RandomState(M)
    im_h, im_w = 211, 317
    n = 120
    xy = rng.uniform(0, [im_w - 1, im_h - 1], (n, 2))
    wh = np.exp(rng.uniform(-1, 6, (n, 2)))
    boxes = np.concatenate(
        [xy, np.minimum(xy + wh, [im_w - 1, im_h - 1])], 1).astype(
            np.float32)
    boxes[0] = [0, 0, im_w - 1, im_h - 1]
    probs = rng.rand(n, M, M).astype(np.float32)
    probs[: n // 4] = (0.5 + rng.uniform(-1e-3, 1e-3, (n // 4, M, M))
                       ).astype(np.float32)
    classes = rng.randint(1, 5, n)
    got = test_engine.segm_results(boxes, classes, probs, im_h, im_w)
    ref = jax_engine.segm_results(boxes, classes, probs, im_h, im_w)
    assert len(got) == len(ref) == n
    n_near = 0
    for i in range(n):
        near = _near_threshold(boxes[i], probs[i], im_h, im_w)
        if near.any():
            n_near += 1
            g, r = jax_rle.decode(got[i]), jax_rle.decode(ref[i])
            assert not ((g != r) & ~near).any(), i
        else:
            assert got[i] == ref[i], i
    assert n_near < n // 4
