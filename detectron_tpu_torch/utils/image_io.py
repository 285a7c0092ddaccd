"""The two OpenCV calls the inference engine needs, without OpenCV: a
reader for binary PPM images and cv2.resize's bilinear interpolation.

- imread(path) returns an (H, W, 3) uint8 BGR array, as cv2.imread does.
  It reads binary PPM (P6, 8-bit) itself and reverses its RGB channels;
  any other format goes to cv2, which must then be installed.
- resize(src, dsize=None, fx=None, fy=None) reproduces
  cv2.resize(src, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR) on
  a floating-point image: with fx/fy the output size is round(src * f) and
  the source coordinate of output pixel x is (x + 0.5) * (1 / fx) - 0.5;
  with dsize = (w, h) the scale is 1 / (w / src_w). The coordinate and the
  weights stay in float64, as OpenCV's IPP build computes them (OpenCV's
  own code rounds the coordinate to float32 first, which moves a 0-255
  image by up to ~1e-2). A coordinate past an edge takes the edge pixel.
  Rows are interpolated first along x, then along y, in the image's
  dtype.
"""

import numpy as np


def _read_token(f):
    """The next whitespace-separated header token of a PPM, skipping
    comments; consumes the single whitespace byte after it."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            raise ValueError("truncated PPM header")
        if c == b"#" and not tok:
            f.readline()
        elif c.isspace():
            if tok:
                return tok
        else:
            tok += c


def _read_ppm(f, path):
    width, height, maxval = (int(_read_token(f)) for _ in range(3))
    if maxval > 255:
        raise ValueError("{}: 16-bit PPM is not supported".format(path))
    data = f.read(width * height * 3)
    if len(data) != width * height * 3:
        raise ValueError("{}: truncated PPM data".format(path))
    rgb = np.frombuffer(data, np.uint8).reshape(height, width, 3)
    return np.ascontiguousarray(rgb[:, :, ::-1])


def imread(path):
    """(H, W, 3) uint8 BGR image. Binary PPM is read here; other formats
    need cv2."""
    with open(path, "rb") as f:
        if f.read(2) == b"P6":
            return _read_ppm(f, path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "{}: only binary PPM (P6) images are read without OpenCV, and "
            "cv2 is not installed".format(path)) from e
    im = cv2.imread(path)
    if im is None:
        raise ValueError("cv2 could not read " + path)
    return im


def write_ppm(path, bgr):
    """Write an (H, W, 3) uint8 BGR image as binary PPM."""
    h, w, _ = bgr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(bgr[:, :, ::-1], np.uint8).tobytes())


def _taps(src_n, dst_n, scale):
    """Source indices i0, i1 and weights w0, w1 (float64) of each output
    position along one axis; past an edge, both taps are the edge pixel."""
    f = (np.arange(dst_n) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    w1 = f - i0
    w1[(i0 < 0) | (i0 >= src_n - 1)] = 0
    i0 = np.clip(i0, 0, src_n - 1)
    return i0, np.minimum(i0 + 1, src_n - 1), 1 - w1, w1


def resize(src, dsize=None, fx=None, fy=None):
    """cv2.resize(src, dsize, fx=fx, fy=fy, interpolation=INTER_LINEAR) of
    a floating-point (H, W) or (H, W, C) image; dsize is (width, height)."""
    if not np.issubdtype(src.dtype, np.floating):
        raise TypeError("resize takes a floating-point image, not "
                        + str(src.dtype))
    h, w = src.shape[:2]
    if dsize is None:
        dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
        inv_x, inv_y = float(fx), float(fy)
    else:
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / w, dh / h
    if (dw, dh) == (w, h):
        return src.copy()
    x0, x1, ax0, ax1 = _taps(w, dw, 1.0 / inv_x)
    y0, y1, by0, by1 = _taps(h, dh, 1.0 / inv_y)
    tail = (1,) * (src.ndim - 2)
    ax0, ax1 = (a.astype(src.dtype).reshape((1, dw) + tail)
                for a in (ax0, ax1))
    by0, by1 = (b.astype(src.dtype).reshape((dh, 1) + tail)
                for b in (by0, by1))
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    return (rows[y0] * by0 + rows[y1] * by1).astype(src.dtype, copy=False)
