"""Anchor generation — Detectron's exact recipe (the port's copy of
detectron_tpu/ops/anchors.py).

Byte-for-byte reproduction of the semantics of the reference's
lib/modeling/generate_anchors.py (symbols: generate_anchors, _whctrs,
_mkanchors, _ratio_enum, _scale_enum): anchors are windows enumerated around a
stride-sized base box with rounded widths/heights. This rounding is
AP-critical, so anchors are computed once in numpy at trace/config time and
embedded as constants into the jitted graph; nothing here runs on-device.

Also provides the precomputed full anchor field over a feature grid
(the reference caches this per (stride, sizes, ratios) in
lib/roi_data/data_utils.py :: get_field_of_anchors).
"""

import numpy as np


def generate_anchors(stride=16, sizes=(32, 64, 128, 256, 512),
                     aspect_ratios=(0.5, 1, 2)):
    """Generate anchor windows by enumerating aspect ratios X scales w.r.t. a
    reference (0, 0, stride-1, stride-1) window. Output (A, 4) float32
    [x1, y1, x2, y2]."""
    return _generate_anchors(
        stride,
        np.array(sizes, dtype=np.float64) / stride,
        np.array(aspect_ratios, dtype=np.float64),
    )


def _generate_anchors(base_size, scales, aspect_ratios):
    anchor = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    anchors = _ratio_enum(anchor, aspect_ratios)
    anchors = np.vstack(
        [_scale_enum(anchors[i, :], scales) for i in range(anchors.shape[0])]
    )
    return anchors.astype(np.float32)


def _whctrs(anchor):
    """Return width, height, x-center, and y-center for an anchor (window)."""
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr):
    """Given widths/heights vectors and a center, output a set of anchors."""
    ws = ws[:, np.newaxis]
    hs = hs[:, np.newaxis]
    anchors = np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )
    return anchors


def _ratio_enum(anchor, ratios):
    """Enumerate a set of anchors for each aspect ratio wrt an anchor."""
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    """Enumerate a set of anchors for each scale wrt an anchor."""
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def anchor_field(stride, sizes, aspect_ratios, field_h, field_w):
    """Full anchor field over a (field_h, field_w) feature grid: shifts the
    (A, 4) cell anchors by every stride step. Output (field_h*field_w*A, 4)
    float32, ordered row-major with A fastest (matches the reference's
    reshape of the (A*4, H, W) conv outputs to (H*W*A, 4) after transpose)."""
    cell_anchors = generate_anchors(stride, sizes, aspect_ratios)
    shift_x = np.arange(field_w) * stride
    shift_y = np.arange(field_h) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    # (H*W, 1, 4) + (1, A, 4) -> (H*W, A, 4)
    field = shifts[:, None, :].astype(np.float32) + cell_anchors[None, :, :]
    return field.reshape(-1, 4)
