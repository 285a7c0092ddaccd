"""Windowed multilevel RoIAlign with the window-rung ladder (port of
detectron_tpu/ops/windowed_roi.py :: window_params :64-162, _rung_route
:234-257, multilevel_roi_align_pallas_ladder :451-650 and its trainable
form multilevel_roi_align_ladder_trainable / _ladder_trainable_bwd
:653-879).

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
    roi_window_accum, roi_window_pool, roi_window_pool_seg)


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
    # padded block (rows) and the level (columns), x rounded down to
    # ALIGN_X. The x bound is itself rounded up to ALIGN_X: rounding the
    # bound Wl - window_x down (the JAX package's order, windowed_roi.py
    # :131-134) leaves up to ALIGN_X - 1 of the level's last columns
    # outside every window of that width, so a RoI at the right edge of a
    # level whose width is not window_x plus a multiple of ALIGN_X (P4 of
    # an 832 x 1344 canvas: 84 - 48 = 36) pooled clamped samples even at
    # its fix-up rung. The window may then reach up to ALIGN_X - 1 columns
    # past the level, into the canvas's zero padding, where no sample
    # weighs (samples clamp to the level).
    wy0 = torch.minimum(torch.clamp(torch.floor(y1) - 1.0, min=0.0),
                        torch.clamp(Hp - window_y, min=0.0))
    wx_hi = torch.ceil(torch.clamp(Wl - window_x, min=0.0) / ALIGN_X) * \
        ALIGN_X
    wx0 = torch.minimum(torch.clamp(torch.floor(x1) - 1.0, min=0.0), wx_hi)
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


def _ladder_backward(ct, rois, dims, scales, pooled, sampling_ratio, k_min,
                     k_max, canonical_scale, canonical_level, rungs):
    """Gradient of multilevel_roi_align_ladder w.r.t. each pyramid level,
    in float32 (float64 for a float64 cotangent): ct (B, R, P, P, C) is the
    output cotangent."""
    B, R = rois.shape[:2]
    n = B * R
    C = ct.shape[-1]
    geom = ladder_geom(dims, rungs)
    dev = ct.device
    rois_flat = rois.reshape(n, 4).to(torch.float32)
    img_idx = torch.arange(B, dtype=torch.int32,
                           device=dev).repeat_interleave(R)
    # Weights and sums in float32 whatever the forward dtype (float64 for a
    # float64 cotangent, for gradcheck): the forward's bf16 weight rounding
    # is a forward-value detail, as in _ladder_trainable_bwd.
    acc = torch.float64 if ct.dtype == torch.float64 else torch.float32
    ct_flat = ct.reshape(n, pooled, pooled, C).to(acc)

    def params(r, wy, wx):
        return window_params(r, geom, scales, pooled, sampling_ratio, k_min,
                             k_max, canonical_scale, canonical_level, wy, wx,
                             acc)

    def starts_of(img, sy, sx):
        return torch.stack([img, sy, sx], dim=-1).contiguous()

    canvas = torch.zeros((B, geom["Hc"], geom["Wc"], C), dtype=acc,
                         device=dev)
    sy, sx, vy, vx, ok = params(rois_flat, geom["wy_base"], geom["wx_base"])
    # With no fix-up rungs the forward kept the base window's result for
    # every RoI, so every cotangent goes through the base window.
    d_base = ct_flat if not geom["fix_rungs"] else torch.where(
        ok[:, None, None, None], ct_flat, 0.0)
    roi_window_accum(canvas, starts_of(img_idx, sy, sx),
                     d_base.contiguous(), vy, vx)
    if geom["fix_rungs"]:
        need = ~ok
        covered, rid = rung_route(rois_flat, geom, scales, k_min, k_max,
                                  canonical_scale, canonical_level)
        for r, (wy_r, wx_r) in enumerate(geom["fix_rungs"]):
            idx = torch.nonzero(need & covered & (rid == r)).flatten()
            if idx.numel() == 0:
                continue
            fsy, fsx, fvy, fvx, _ = params(rois_flat[idx], wy_r, wx_r)
            roi_window_accum(canvas, starts_of(img_idx[idx], fsy, fsx),
                             ct_flat[idx].contiguous(), fvy, fvx)
        idx = torch.nonzero(need & ~covered).flatten()
        if idx.numel():
            with torch.enable_grad():
                cz = torch.zeros_like(canvas, requires_grad=True)
                out = ml.multilevel_roi_align_canvas_flat(
                    cz, dims, geom["row_off_l"], [0] * len(dims), scales,
                    rois_flat[idx], img_idx[idx], pooled, sampling_ratio,
                    k_min, k_max, canonical_scale, canonical_level)
                canvas += torch.autograd.grad(out, cz, ct_flat[idx])[0]
    return [canvas[:, r0:r0 + H, :W]
            for (H, W), r0 in zip(dims, geom["row_off_l"])]


class _LadderRoIAlign(torch.autograd.Function):
    """multilevel_roi_align_ladder, differentiable w.r.t. the pyramid."""

    @staticmethod
    def forward(ctx, rois, static, *pyramid):
        ctx.static = static
        ctx.dims = [(f.shape[1], f.shape[2]) for f in pyramid]
        ctx.dtype = pyramid[0].dtype
        ctx.save_for_backward(rois)
        return multilevel_roi_align_ladder(list(pyramid), static[0], rois,
                                           *static[1:])

    @staticmethod
    def backward(ctx, ct):
        rois, = ctx.saved_tensors
        d_pyr = _ladder_backward(ct, rois, ctx.dims, *ctx.static)
        return (None, None) + tuple(d.to(ctx.dtype) for d in d_pyr)


def multilevel_roi_align_ladder_trainable(pyramid, scales, rois, pooled,
                                          sampling_ratio, k_min, k_max,
                                          canonical_scale, canonical_level,
                                          rungs):
    """multilevel_roi_align_ladder (same arguments and result) with a
    backward to the pyramid through kernel K4. The RoIs are treated as
    constants (proposals are detached, as in the reference)."""
    static = (tuple(scales), pooled, sampling_ratio, k_min, k_max,
              canonical_scale, canonical_level, tuple(rungs))
    return _LadderRoIAlign.apply(rois.detach(), static, *pyramid)
