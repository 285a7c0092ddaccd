"""Exact multilevel RoIAlign by gathering (port of detectron_tpu/ops/
multilevel_roi.py: multilevel_roi_align :46-80, multilevel_roi_align_canvas
_flat :136-182, _gather_pool :185-262).

Detectron v1 RoIAlign semantics: no half-pixel offset, RoI size floored at
1, samples outside [-1, size] weigh zero, clamp-to-edge bilinear; each RoI
pools from its FPN level (eq. 1 of the FPN paper). Each sample's 4
neighbours are gathered from a flattened feature tensor. This is the CPU
oracle for the windowed ladder (ops/windowed_roi.py) and the ladder's exact
fix-up for slivers no window rung covers.
"""

import torch

from detectron_tpu_torch.utils import tracing

# RoIs per gather chunk: bounds the (chunk, S, S, C) sample tensor.
_CHUNK = 128


def roi_levels(rois, k_min, k_max, canonical_scale, canonical_level):
    """FPN level of each RoI (..., 4), clipped to [k_min, k_max]."""
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    s = torch.sqrt(torch.clamp(w * h, min=1e-12))
    lvl = torch.floor(canonical_level
                      + torch.log2(s / canonical_scale + 1e-6))
    return torch.clamp(lvl, k_min, k_max).to(torch.int64)


def sample_coords(start, size, pooled, ratio):
    """(R,) start/size -> (R, pooled * ratio) sample coordinates."""
    bin_size = size / pooled
    p = torch.arange(pooled * ratio, dtype=start.dtype, device=start.device)
    bins = torch.div(p, ratio, rounding_mode="floor")
    g = p % ratio
    return start[:, None] + bins[None, :] * bin_size[:, None] + \
        (g[None, :] + 0.5) * bin_size[:, None] / ratio


def _gather_pool(flat, rois, off, Hl, Wl, lvl_scale, pooled, sampling_ratio,
                 row_stride, dtype):
    """flat: (M, C) features. RoI r's level starts at flat row off[r], and
    one feature row of it spans row_stride[r] flat rows (int64 tensors);
    Hl/Wl are the level's dims."""
    C = flat.shape[-1]
    x1 = rois[:, 0] * lvl_scale
    y1 = rois[:, 1] * lvl_scale
    roi_w = torch.clamp((rois[:, 2] - rois[:, 0]) * lvl_scale, min=1.0)
    roi_h = torch.clamp((rois[:, 3] - rois[:, 1]) * lvl_scale, min=1.0)

    ys = sample_coords(y1, roi_h, pooled, sampling_ratio)
    xs = sample_coords(x1, roi_w, pooled, sampling_ratio)
    Hf = Hl.to(ys.dtype)[:, None]
    Wf = Wl.to(xs.dtype)[:, None]
    in_y = (ys >= -1.0) & (ys <= Hf)
    in_x = (xs >= -1.0) & (xs <= Wf)
    yc = torch.minimum(torch.clamp(ys, min=0.0), Hf - 1.0)
    xc = torch.minimum(torch.clamp(xs, min=0.0), Wf - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    ly = yc - y0
    lx = xc - x0
    y1i = torch.minimum(y0 + 1.0, Hf - 1.0)
    x1i = torch.minimum(x0 + 1.0, Wf - 1.0)

    base = off[:, None, None]
    stride = row_stride[:, None, None]

    def flat_idx(yy, xx):
        return base + yy.long()[:, :, None] * stride + xx.long()[:, None, :]

    idx = [flat_idx(y0, x0), flat_idx(y0, x1i), flat_idx(y1i, x0),
           flat_idx(y1i, x1i)]
    wy0 = (1.0 - ly) * in_y
    wy1 = ly * in_y
    wx0 = (1.0 - lx) * in_x
    wx1 = lx * in_x
    wts = [(a[:, :, None] * b[:, None, :]).to(dtype)
           for a, b in ((wy0, wx0), (wy0, wx1), (wy1, wx0), (wy1, wx1))]

    R = rois.shape[0]
    out = []
    for s in range(0, R, _CHUNK):
        e = min(R, s + _CHUNK)
        v = flat[idx[0][s:e]] * wts[0][s:e, ..., None]
        for i in range(1, 4):
            v = v + flat[idx[i][s:e]] * wts[i][s:e, ..., None]
        cs = v.reshape(e - s, pooled, sampling_ratio, pooled,
                       sampling_ratio, C)
        out.append(cs.mean(dim=(2, 4)))
    return torch.cat(out, dim=0)


def multilevel_roi_align(pyramid, scales, rois, pooled, sampling_ratio,
                         k_min, k_max, canonical_scale=224,
                         canonical_level=4):
    """pyramid: levels k_min..k_max of ONE image, each (H_l, W_l, C);
    rois: (R, 4) image coords. Returns (R, pooled, pooled, C)."""
    assert sampling_ratio > 0, "the gather path needs a static sampling ratio"
    assert len(pyramid) == k_max - k_min + 1
    dev = rois.device
    C = pyramid[0].shape[-1]
    # Four host lists copied to the device, each a blocking copy.
    tracing.sync("multilevel_roi.geometry", 4)
    heights = torch.tensor([f.shape[0] for f in pyramid], device=dev)
    widths = torch.tensor([f.shape[1] for f in pyramid], device=dev)
    sizes = [f.shape[0] * f.shape[1] for f in pyramid]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(pyramid))],
                           device=dev)
    flat = torch.cat([f.reshape(-1, C) for f in pyramid], dim=0)
    rois = rois.to(torch.float32)
    lvl = roi_levels(rois, k_min, k_max, canonical_scale,
                     canonical_level) - k_min
    lvl_scale = torch.tensor(scales, dtype=torch.float32, device=dev)[lvl]
    return _gather_pool(flat, rois, offsets[lvl], heights[lvl], widths[lvl],
                        lvl_scale, pooled, sampling_ratio, widths[lvl],
                        pyramid[0].dtype)


def multilevel_roi_align_canvas_flat(canvas, level_dims, row_off, col_off,
                                     scales, rois, img_idx, pooled,
                                     sampling_ratio, k_min, k_max,
                                     canonical_scale=224, canonical_level=4):
    """Exact RoIAlign reading the levels in place from a canvas
    (B, Hc, Wc, C): level l of image b lives at rows [row_off[l],
    row_off[l] + H_l) and columns [col_off[l], col_off[l] + W_l) of
    canvas[b]. rois (R, 4) with img_idx (R,). Returns (R, P, P, C)."""
    assert sampling_ratio > 0, "the gather path needs a static sampling ratio"
    assert len(level_dims) == k_max - k_min + 1
    B, Hc, Wc, C = canvas.shape
    dev = canvas.device
    tracing.sync("multilevel_roi.geometry", 5)
    heights = torch.tensor([d[0] for d in level_dims], device=dev)
    widths = torch.tensor([d[1] for d in level_dims], device=dev)
    row_off = torch.tensor(row_off, device=dev)
    col_off = torch.tensor(col_off, device=dev)
    rois = rois.to(torch.float32)
    lvl = roi_levels(rois, k_min, k_max, canonical_scale,
                     canonical_level) - k_min
    lvl_scale = torch.tensor(scales, dtype=torch.float32, device=dev)[lvl]
    off = (img_idx.long() * Hc + row_off[lvl]) * Wc + col_off[lvl]
    return _gather_pool(canvas.reshape(-1, C), rois, off, heights[lvl],
                        widths[lvl], lvl_scale, pooled, sampling_ratio,
                        torch.full_like(off, Wc), canvas.dtype)
