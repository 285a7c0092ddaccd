"""Windowed multilevel RoIAlign with the window-rung ladder (port of
detectron_tpu/ops/windowed_roi.py :: window_params :64-162, _rung_route
:234-257 and multilevel_roi_align_pallas_ladder :451-650).

The FPN levels are stacked row-wise into one zero-padded canvas per image,
so a RoI's neighbourhood at any level is one contiguous window. Each RoI
then pools as two small contractions against per-RoI interpolation weights
(vy over window rows, vx over window columns, the sampling-grid average
folded in): kernel K2 (ops/cuda/roi_align_kernel.py) in the base sweep.
RoIs the base window cannot cover (elongated mid-level RoIs) are pooled
again at a taller or wider fix-up rung by kernel K3 over exactly the rows
of that rung, and the rare slivers no rung covers go through the exact
gather (ops/multilevel_roi.py). The result is exact RoIAlign for every RoI
(PARITY.md:125-135).

What the port simplifies against the TPU version, values unchanged: the
canvas is row-stacked (no 2-D packing), the fix-up rungs keep their
configured widths (no VMEM fitting), the output is in (p, q) order (no
out_qp), and the fix-up compaction is a Python loop over torch.nonzero
(the eager port knows each rung's count on the host).
"""

import torch

from detectron_tpu_torch.ops import multilevel_roi as ml
from detectron_tpu_torch.ops.cuda.roi_align_kernel import (
    roi_window_pool, roi_window_pool_seg)


# Window x origins are rounded down to this; the base window's +8 x slack
# and the rungs' +12 x routing margin cover it. TPU DMA tiling chose 8; it
# is kept so that routing matches the JAX ladder RoI for RoI.
ALIGN_X = 8


def _round8(v):
    return -(-v // 8) * 8


def _axis_weights_window(rel, in_bounds, size):
    """(n, S) window-relative sample coords -> (n, S, size) bilinear
    weights, zero where the sample is out of bounds."""
    c = torch.clamp(rel, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=rel.dtype, device=rel.device)
    w = torch.clamp(1.0 - torch.abs(c[..., None] - idx), min=0.0)
    return w * in_bounds[..., None]


def window_params(rois, geom, scales, pooled, sampling_ratio, k_min, k_max,
                  canonical_scale, canonical_level, window_y, window_x,
                  weight_dtype):
    """Per-RoI window origins and interpolation weights for rois (n, 4).

    Returns (start_y, start_x) int32 (n,) into the canvas, vy (n, P, WY),
    vx (n, P, WX) in weight_dtype, and ok (n,) bool: True iff the window
    covers every in-bounds sample of the RoI, so that the windowed result
    is exact RoIAlign."""
    dev = rois.device
    lvl = ml.roi_levels(rois, k_min, k_max, canonical_scale,
                        canonical_level) - k_min
    lvl_scale = torch.tensor(scales, dtype=torch.float32, device=dev)[lvl]
    Hl = geom["heights"].to(dev)[lvl]
    Wl = geom["widths"].to(dev)[lvl]
    off_y = geom["row_off"].to(dev)[lvl]
    Hp = geom["pad_rows"].to(dev)[lvl]

    x1 = rois[:, 0] * lvl_scale
    y1 = rois[:, 1] * lvl_scale
    roi_w = torch.clamp((rois[:, 2] - rois[:, 0]) * lvl_scale, min=1.0)
    roi_h = torch.clamp((rois[:, 3] - rois[:, 1]) * lvl_scale, min=1.0)
    ys = ml.sample_coords(y1, roi_h, pooled, sampling_ratio)
    xs = ml.sample_coords(x1, roi_w, pooled, sampling_ratio)

    in_y = (ys >= -1.0) & (ys <= Hl[:, None])
    in_x = (xs >= -1.0) & (xs <= Wl[:, None])
    yc = torch.minimum(torch.clamp(ys, min=0.0), Hl[:, None] - 1.0)
    xc = torch.minimum(torch.clamp(xs, min=0.0), Wl[:, None] - 1.0)

    # Window origin: just above-left of the RoI, kept inside the level's
    # padded block (rows) and the level (columns).
    wy0 = torch.minimum(torch.clamp(torch.floor(y1) - 1.0, min=0.0),
                        torch.clamp(Hp - window_y, min=0.0))
    wx0 = torch.minimum(torch.clamp(torch.floor(x1) - 1.0, min=0.0),
                        torch.clamp(Wl - window_x, min=0.0))
    wx0 = torch.floor(wx0 / ALIGN_X) * ALIGN_X

    rel_y_raw = yc - wy0[:, None]
    rel_x_raw = xc - wx0[:, None]
    ok = (torch.all(~in_y | ((rel_y_raw >= 0.0)
                             & (rel_y_raw <= window_y - 1.0)), dim=1)
          & torch.all(~in_x | ((rel_x_raw >= 0.0)
                               & (rel_x_raw <= window_x - 1.0)), dim=1))
    rel_y = torch.clamp(rel_y_raw, 0.0, window_y - 1.0)
    rel_x = torch.clamp(rel_x_raw, 0.0, window_x - 1.0)

    n = rois.shape[0]
    vy = _axis_weights_window(rel_y, in_y.float(), window_y).reshape(
        n, pooled, sampling_ratio, window_y).mean(dim=2)
    vx = _axis_weights_window(rel_x, in_x.float(), window_x).reshape(
        n, pooled, sampling_ratio, window_x).mean(dim=2)
    return ((off_y + wy0).to(torch.int32), wx0.to(torch.int32),
            vy.to(weight_dtype).contiguous(),
            vx.to(weight_dtype).contiguous(), ok)


def ladder_geom(dims, rungs):
    """Static ladder geometry for levels of dims [(H_l, W_l), ...]: the base
    window (rung 0's height, x widened to the whole top level when that
    level fits the base height), the fix-up rungs, and the row-stacked
    canvas layout (each level padded to >= the base height; the bottom
    padded so the tallest rung never reads past the canvas)."""
    H_top, W_top = dims[-1]
    wy_base = rungs[0][0]
    x_cover = W_top if H_top <= wy_base else 0
    wx_base = _round8(max(rungs[0][1], wy_base + 8, x_cover))
    fix_rungs = tuple((int(wy), int(wx)) for wy, wx in rungs[1:])
    wy_max = max([wy_base] + [wy for wy, _ in fix_rungs])
    wx_max = max([wx_base] + [wx for _, wx in fix_rungs])
    pad_rows = [max(h, wy_base) for h, _ in dims]
    row_off = [sum(pad_rows[:i]) for i in range(len(dims))]
    return dict(
        wy_base=wy_base, wx_base=wx_base, fix_rungs=fix_rungs,
        row_off_l=row_off, pad_rows_l=pad_rows,
        Hc=sum(pad_rows) + max(0, wy_max - pad_rows[-1]),
        Wc=_round8(max(w for _, w in dims) + wx_max),
        heights=torch.tensor([float(h) for h, _ in dims]),
        widths=torch.tensor([float(w) for _, w in dims]),
        row_off=torch.tensor([float(r) for r in row_off]),
        pad_rows=torch.tensor([float(r) for r in pad_rows]))


def build_canvas(pyramid, geom):
    """pyramid: list of (B, H_l, W_l, C) -> zero-padded (B, Hc, Wc, C)
    canvas with level l at rows [row_off[l], row_off[l] + H_l), columns
    [0, W_l)."""
    B, _, _, C = pyramid[0].shape
    canvas = pyramid[0].new_zeros((B, geom["Hc"], geom["Wc"], C))
    for f, r in zip(pyramid, geom["row_off_l"]):
        canvas[:, r:r + f.shape[1], :f.shape[2]] = f
    return canvas


def rung_route(rois, geom, scales, k_min, k_max, canonical_scale,
               canonical_level):
    """Per-RoI fix-up routing: the first rung whose window covers the RoI's
    level-clamped extent (+4 rows for the bilinear border and origin floor,
    +12 columns adding the x alignment), or the whole level. Returns
    (covered (n,) bool, rid (n,) int64)."""
    dev = rois.device
    lvl = ml.roi_levels(rois, k_min, k_max, canonical_scale,
                        canonical_level) - k_min
    sc = torch.tensor(scales, dtype=torch.float32, device=dev)[lvl]
    Hl = geom["heights"].to(dev)[lvl]
    Wl = geom["widths"].to(dev)[lvl]
    ex = torch.minimum((rois[:, 2] - rois[:, 0] + 1.0) * sc, Wl)
    ey = torch.minimum((rois[:, 3] - rois[:, 1] + 1.0) * sc, Hl)
    rid = torch.zeros(rois.shape[0], dtype=torch.int64, device=dev)
    covered = torch.zeros(rois.shape[0], dtype=torch.bool, device=dev)
    for r in range(len(geom["fix_rungs"]) - 1, -1, -1):
        wy_r, wx_r = geom["fix_rungs"][r]
        fits = (((ey + 4.0 <= wy_r) | (wy_r >= Hl))
                & ((ex + 12.0 <= wx_r) | (wx_r >= Wl)))
        rid = torch.where(fits, r, rid)
        covered = covered | fits
    return covered, rid


def multilevel_roi_align_ladder(pyramid, scales, rois, pooled,
                                sampling_ratio, k_min, k_max,
                                canonical_scale, canonical_level, rungs):
    """pyramid: levels k_min..k_max, each (B, H_l, W_l, C); rois (B, R, 4)
    in image coords. Returns (B, R, pooled, pooled, C) in the pyramid
    dtype, exact RoIAlign for every RoI."""
    assert sampling_ratio > 0
    B, R = rois.shape[:2]
    C = pyramid[0].shape[-1]
    n = B * R
    dims = [(f.shape[1], f.shape[2]) for f in pyramid]
    geom = ladder_geom(dims, rungs)
    canvas = build_canvas(pyramid, geom)
    dev = canvas.device
    rois_flat = rois.reshape(n, 4).to(torch.float32)
    img_idx = torch.arange(B, dtype=torch.int32,
                           device=dev).repeat_interleave(R)

    def params(r, wy, wx):
        return window_params(r, geom, scales, pooled, sampling_ratio, k_min,
                             k_max, canonical_scale, canonical_level, wy, wx,
                             canvas.dtype)

    def starts_of(img, sy, sx):
        return torch.stack([img, sy, sx], dim=-1).contiguous()

    sy, sx, vy, vx, ok = params(rois_flat, geom["wy_base"], geom["wx_base"])
    out = roi_window_pool(canvas, starts_of(img_idx, sy, sx), vy, vx)
    if not geom["fix_rungs"]:
        return out.reshape(B, R, pooled, pooled, C)

    need = ~ok
    covered, rid = rung_route(rois_flat, geom, scales, k_min, k_max,
                              canonical_scale, canonical_level)
    for r, (wy_r, wx_r) in enumerate(geom["fix_rungs"]):
        idx = torch.nonzero(need & covered & (rid == r)).flatten()
        if idx.numel() == 0:
            continue
        fsy, fsx, fvy, fvx, _ = params(rois_flat[idx], wy_r, wx_r)
        out[idx] = roi_window_pool_seg(
            canvas, starts_of(img_idx[idx], fsy, fsx), fvy, fvx,
            (0, idx.numel()))

    idx = torch.nonzero(need & ~covered).flatten()
    if idx.numel():
        out[idx] = ml.multilevel_roi_align_canvas_flat(
            canvas, dims, geom["row_off_l"], [0] * len(dims), scales,
            rois_flat[idx], img_idx[idx], pooled, sampling_ratio, k_min,
            k_max, canonical_scale, canonical_level)
    return out.reshape(B, R, pooled, pooled, C)
