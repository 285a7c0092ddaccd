"""Image blob preparation on the host (the port's copy of
detectron_tpu/utils/blob.py :20-70; reference: lib/utils/blob.py).

prep_im_for_blob: BGR float, mean subtraction, isotropic resize with the
MAX_SIZE cap, through utils/image_io.resize (cv2.resize's INTER_LINEAR
arithmetic, without OpenCV). Images pad to a static canvas derived from
(SCALE, MAX_SIZE) and bucketed by orientation (landscape/portrait), as in
the JAX package, so each batch of a bucket has one shape.
space_to_depth (JAX blob.py:86-97) blocks a batch for the TPU.S2D_INPUT
stem.
"""

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.utils import image_io


def prep_im_for_blob(im, pixel_means, target_size, max_size):
    """im: HxWx3 BGR uint8. Returns (float image, scale)."""
    im = im.astype(np.float32, copy=False)
    im = im - pixel_means
    im_shape = im.shape
    im_size_min = np.min(im_shape[0:2])
    im_size_max = np.max(im_shape[0:2])
    im_scale = float(target_size) / float(im_size_min)
    if np.round(im_scale * im_size_max) > max_size:
        im_scale = float(max_size) / float(im_size_max)
    im = image_io.resize(im, fx=im_scale, fy=im_scale)
    return im, im_scale


def _align(v, stride):
    return int(np.ceil(v / float(stride)) * stride)


def static_canvas(target_size, max_size, landscape=True, stride=None):
    """Static (H, W) canvas for one orientation bucket."""
    stride = stride or (cfg.FPN.COARSEST_STRIDE if cfg.FPN.FPN_ON else 32)
    short = _align(target_size, stride)
    lng = _align(max_size, stride)
    return (short, lng) if landscape else (lng, short)


def im_to_canvas(im, canvas_hw):
    """Zero-pad a prepped image into the top-left of the static canvas."""
    H, W = canvas_hw
    h, w = im.shape[:2]
    assert h <= H and w <= W, \
        "image {}x{} exceeds canvas {}x{}".format(h, w, H, W)
    out = np.zeros((H, W, 3), np.float32)
    out[:h, :w] = im
    return out


def get_image_blob(im, target_size=None, max_size=None):
    """One image -> (blob (1, H, W, 3), im_scale, im_info (1, 3)).
    Uses TEST.SCALE/MAX_SIZE by default (reference _get_blobs path)."""
    target_size = target_size or cfg.TEST.SCALE
    max_size = max_size or cfg.TEST.MAX_SIZE
    prepped, scale = prep_im_for_blob(
        im, cfg.PIXEL_MEANS, target_size, max_size)
    landscape = prepped.shape[1] >= prepped.shape[0]
    canvas = static_canvas(target_size, max_size, landscape)
    blob = im_to_canvas(prepped, canvas)[None]
    im_info = np.array(
        [[prepped.shape[0], prepped.shape[1], scale]], np.float32)
    return blob, scale, im_info



def space_to_depth(images):
    """(B, H, W, C) -> (B, (H+8)//2, (W+8)//2, 4C), the blocked input of
    the cfg.TPU.S2D_INPUT stem: pad 4 on each spatial side (the 7x7/s2
    stem's halo, so the device conv is VALID), then 2x2 blocks with
    channels in (dy, dx, c) order, as models/resnet._s2d_blocked_stem_conv
    takes them."""
    B, H, W, C = images.shape
    if H % 2 or W % 2:
        raise ValueError("space_to_depth needs an even canvas, got "
                         "{} x {}".format(H, W))
    xp = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)))
    P, Q = (H + 8) // 2, (W + 8) // 2
    x2 = xp.reshape(B, P, 2, Q, 2, C).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x2.reshape(B, P, Q, 4 * C))
