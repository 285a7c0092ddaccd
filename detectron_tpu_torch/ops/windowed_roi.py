"""Windowed multilevel RoIAlign: every FPN RoIAlign route of the JAX
package's model_builder.roi_feature_transform (port of detectron_tpu/ops/
windowed_roi.py).

The FPN levels are stacked row-wise into one zero-padded canvas, so a RoI's
neighbourhood at any level is one contiguous window. Each RoI then pools as
two small contractions against per-RoI interpolation weights (vy over
window rows, vx over window columns, the sampling-grid average folded in).
The routes (TPU.ROI_IMPL, TPU.ROI_LADDER, TPU.ROI_LADDER_NARROW):

- The window-rung ladder ('pallas', the default; window_params :64-162,
  _rung_route :234-257, multilevel_roi_align_pallas_ladder :451-650 and
  multilevel_roi_align_ladder_trainable / _ladder_trainable_bwd :653-879):
  kernel K2 (ops/cuda/roi_align_kernel.py) in the base sweep; RoIs the base
  window cannot cover (elongated mid-level RoIs) pool again at a taller or
  wider fix-up rung by kernel K3 over exactly the rows of that rung, and
  the rare slivers no rung covers go through the exact gather
  (ops/multilevel_roi.py). Exact RoIAlign for every RoI (PARITY.md:
  125-135). Under ROI_LADDER_NARROW (_ladder_geom :197-206) the base
  window stays at ROI_RUNGS[0] and a whole-top-level rung, first among the
  fix-up rungs, takes the top-level RoIs: the same values on other kernel
  shapes. The backward is kernel K4 routed by the same geometry.
- The single window ('pallas' with ROI_LADDER off;
  multilevel_roi_align_pallas :383-435, its trainable form :886-1034 and
  multilevel_roi_align_pallas_hybrid :1128-1190): K2 at one window shape
  for every RoI, clamping the samples of RoIs it does not cover, and K4 in
  the backward, the exact transpose of that clamped map. The top level
  takes whole-level windows where it fits the window height, else it is
  pooled densely (ops/roi_align.py) and selected per RoI.
- The windowed hybrid ('windowed'; multilevel_roi_align_windowed
  :307-355, multilevel_roi_align_hybrid :1085-1125): one image, a square
  window slice per RoI and two float32 products in plain PyTorch (XLA in
  the JAX package) below the top level, the top level pooled densely, and
  the exact gather for RoIs whose window was short. Exact for every RoI;
  differentiable by autograd.

What the port simplifies against the TPU version, values unchanged: the
canvas is row-stacked (no 2-D packing), the fix-up rungs keep their
configured widths (no VMEM fitting), the output is in (p, q) order (no
out_qp), the fix-up compaction is a Python loop over torch.nonzero (the
eager port knows each rung's count on the host), and the backward is K4
alone (no DETECTRON_TPU_ROI_BWD=gather switch).
"""

import logging
import math

import torch

from detectron_tpu_torch.ops import multilevel_roi as ml
from detectron_tpu_torch.ops import roi_align as ra
from detectron_tpu_torch.ops.cuda.roi_align_kernel import (
    MAX_WINDOW, roi_window_accum, roi_window_pool, roi_window_pool_seg)
from detectron_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

# Window x origins of the ladder and the single window are rounded down to
# this; the base window's +8 x slack and the rungs' +12 x routing margin
# cover it. TPU DMA tiling chose 8; it is kept so that routing matches the
# JAX ladder RoI for RoI. The windowed hybrid takes origins at any column
# (align_x 1).
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
                  weight_dtype, align_x=ALIGN_X):
    """Per-RoI window origins and interpolation weights for rois (n, 4).

    Returns (start_y, start_x) int32 (n,) into the canvas, vy (n, P, WY),
    vx (n, P, WX) in weight_dtype, and ok (n,) bool: True iff the window
    covers every in-bounds sample of the RoI, so that the windowed result
    is exact RoIAlign."""
    dev = rois.device
    lvl = ml.roi_levels(rois, k_min, k_max, canonical_scale,
                        canonical_level) - k_min
    # Five host tensors copied to the device, each a blocking copy.
    tracing.sync("windowed_roi.geometry", 5)
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
    # align_x. The x bound is itself rounded up to align_x: rounding the
    # bound Wl - window_x down (the JAX package's order, windowed_roi.py
    # :131-134) leaves up to align_x - 1 of the level's last columns
    # outside every window of that width, so a RoI at the right edge of a
    # level whose width is not window_x plus a multiple of align_x (P4 of
    # an 832 x 1344 canvas: 84 - 48 = 36) pooled clamped samples even at
    # its fix-up rung. The window may then reach up to align_x - 1 columns
    # past the level, into the canvas's zero padding, where no sample
    # weighs (samples clamp to the level). At align_x 1 both orders agree.
    wy0 = torch.minimum(torch.clamp(torch.floor(y1) - 1.0, min=0.0),
                        torch.clamp(Hp - window_y, min=0.0))
    wx_hi = torch.ceil(torch.clamp(Wl - window_x, min=0.0) / align_x) * \
        align_x
    wx0 = torch.minimum(torch.clamp(torch.floor(x1) - 1.0, min=0.0), wx_hi)
    if align_x > 1:
        wx0 = torch.floor(wx0 / align_x) * align_x

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


def _geom(dims, wy_base, wx_base, fix_rungs, overhang, Wc):
    """The geometry dict of a row-stacked canvas of levels dims [(H_l,
    W_l), ...], each padded to >= wy_base rows, `overhang` zero rows below
    the last and Wc columns: the base window, the fix-up rungs, the canvas
    size and the per-level tensors window_params reads."""
    pad_rows = [max(h, wy_base) for h, _ in dims]
    row_off = [sum(pad_rows[:i]) for i in range(len(dims))]
    return dict(
        wy_base=wy_base, wx_base=wx_base, fix_rungs=tuple(fix_rungs),
        row_off_l=row_off, pad_rows_l=pad_rows,
        Hc=sum(pad_rows) + overhang, Wc=Wc,
        heights=torch.tensor([float(h) for h, _ in dims]),
        widths=torch.tensor([float(w) for _, w in dims]),
        row_off=torch.tensor([float(r) for r in row_off]),
        pad_rows=torch.tensor([float(r) for r in pad_rows]))


def ladder_geom(dims, rungs, narrow_base=False):
    """Static ladder geometry for levels of dims [(H_l, W_l), ...]: the base
    window (rung 0's height, x widened to the whole top level when that
    level fits the base height, unless narrow_base), the fix-up rungs
    (under narrow_base a whole-top-level rung first, its sides at most
    MAX_WINDOW: RoIs it cannot cover go to the exact gather), and the
    row-stacked canvas layout (each level padded to >= the base height;
    the bottom padded so the tallest rung never reads past the canvas)."""
    H_top, W_top = dims[-1]
    wy_base = rungs[0][0]
    x_cover = 0 if narrow_base else (W_top if H_top <= wy_base else 0)
    wx_base = _round8(max(rungs[0][1], wy_base + 8, x_cover))
    fix_rungs = [(int(wy), int(wx)) for wy, wx in rungs[1:]]
    if narrow_base:
        fix_rungs.insert(0, (min(max(wy_base, H_top), MAX_WINDOW),
                             min(_round8(max(W_top, wy_base + 8)),
                                 MAX_WINDOW)))
    wy_max = max([wy_base] + [wy for wy, _ in fix_rungs])
    wx_max = max([wx_base] + [wx for _, wx in fix_rungs])
    return _geom(dims, wy_base, wx_base, fix_rungs,
                 max(0, wy_max - max(H_top, wy_base)),
                 _round8(max(w for _, w in dims) + wx_max))


def single_window_geom(dims, window, x_cover=0):
    """Geometry of the single-window route (multilevel_roi_align_pallas's):
    every RoI takes a window of `window` rows and round8(max(window + 8,
    x_cover)) columns (x_cover: the top level's width, so that its RoIs
    take whole-level windows), no fix-up rung."""
    wx = _round8(max(window + 8, x_cover))
    return _geom(dims, window, wx, (), 0,
                 _round8(max(w for _, w in dims) + wx))


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
    tracing.sync("windowed_roi.geometry", 3)
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


def _windows_pool(pyramid, geom, scales, rois, pooled, sampling_ratio,
                  k_min, k_max, canonical_scale, canonical_level):
    """The windowed forward over geometry `geom` (ladder_geom or
    single_window_geom): K2 at the base window for every RoI; with fix-up
    rungs, K3 at its rung for each RoI the base does not cover and the
    exact gather for those no rung covers. pyramid: levels k_min..k_max,
    each (B, H_l, W_l, C); rois (B, R, 4). Returns (B, R, P, P, C)."""
    assert sampling_ratio > 0
    B, R = rois.shape[:2]
    C = pyramid[0].shape[-1]
    n = B * R
    dims = [(f.shape[1], f.shape[2]) for f in pyramid]
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
        tracing.sync("windowed_roi.fixup")
        idx = torch.nonzero(need & covered & (rid == r)).flatten()
        if idx.numel() == 0:
            continue
        fsy, fsx, fvy, fvx, _ = params(rois_flat[idx], wy_r, wx_r)
        out[idx] = roi_window_pool_seg(
            canvas, starts_of(img_idx[idx], fsy, fsx), fvy, fvx,
            (0, idx.numel()))

    tracing.sync("windowed_roi.gather")
    idx = torch.nonzero(need & ~covered).flatten()
    if idx.numel():
        out[idx] = ml.multilevel_roi_align_canvas_flat(
            canvas, dims, geom["row_off_l"], [0] * len(dims), scales,
            rois_flat[idx], img_idx[idx], pooled, sampling_ratio, k_min,
            k_max, canonical_scale, canonical_level)
    return out.reshape(B, R, pooled, pooled, C)


def multilevel_roi_align_ladder(pyramid, scales, rois, pooled,
                                sampling_ratio, k_min, k_max,
                                canonical_scale, canonical_level, rungs,
                                narrow_base=False):
    """pyramid: levels k_min..k_max, each (B, H_l, W_l, C); rois (B, R, 4)
    in image coords. Returns (B, R, pooled, pooled, C) in the pyramid
    dtype, exact RoIAlign for every RoI (the base window narrowed to
    rungs[0] under narrow_base)."""
    dims = [(f.shape[1], f.shape[2]) for f in pyramid]
    return _windows_pool(pyramid, ladder_geom(dims, rungs, narrow_base),
                         scales, rois, pooled, sampling_ratio, k_min, k_max,
                         canonical_scale, canonical_level)


def _windows_backward(ct, rois, dims, geom, scales, pooled, sampling_ratio,
                      k_min, k_max, canonical_scale, canonical_level):
    """Gradient of _windows_pool over `geom` w.r.t. each pyramid level, in
    float32 (float64 for a float64 cotangent): ct (B, R, P, P, C) is the
    output cotangent."""
    B, R = rois.shape[:2]
    n = B * R
    C = ct.shape[-1]
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
    # every RoI, clamped or not, so every cotangent goes through the base
    # window: the transpose of the clamped map.
    d_base = ct_flat if not geom["fix_rungs"] else torch.where(
        ok[:, None, None, None], ct_flat, 0.0)
    roi_window_accum(canvas, starts_of(img_idx, sy, sx),
                     d_base.contiguous(), vy, vx)
    if geom["fix_rungs"]:
        need = ~ok
        covered, rid = rung_route(rois_flat, geom, scales, k_min, k_max,
                                  canonical_scale, canonical_level)
        for r, (wy_r, wx_r) in enumerate(geom["fix_rungs"]):
            tracing.sync("windowed_roi.fixup_backward")
            idx = torch.nonzero(need & covered & (rid == r)).flatten()
            if idx.numel() == 0:
                continue
            fsy, fsx, fvy, fvx, _ = params(rois_flat[idx], wy_r, wx_r)
            roi_window_accum(canvas, starts_of(img_idx[idx], fsy, fsx),
                             ct_flat[idx].contiguous(), fvy, fvx)
        tracing.sync("windowed_roi.gather_backward")
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


def _ladder_backward(ct, rois, dims, scales, pooled, sampling_ratio, k_min,
                     k_max, canonical_scale, canonical_level, rungs,
                     narrow_base=False):
    """Gradient of multilevel_roi_align_ladder w.r.t. each pyramid level
    (_windows_backward over the ladder's geometry)."""
    return _windows_backward(ct, rois, dims,
                             ladder_geom(dims, rungs, narrow_base), scales,
                             pooled, sampling_ratio, k_min, k_max,
                             canonical_scale, canonical_level)


class _WindowRoIAlign(torch.autograd.Function):
    """_windows_pool over a geometry, differentiable w.r.t. the pyramid:
    the backward is _windows_backward over the same geometry."""

    @staticmethod
    def forward(ctx, rois, geom, static, *pyramid):
        ctx.geom, ctx.static = geom, static
        ctx.dims = [(f.shape[1], f.shape[2]) for f in pyramid]
        ctx.dtype = pyramid[0].dtype
        ctx.save_for_backward(rois)
        return _windows_pool(list(pyramid), geom, static[0], rois,
                             *static[1:])

    @staticmethod
    def backward(ctx, ct):
        rois, = ctx.saved_tensors
        d_pyr = _windows_backward(ct, rois, ctx.dims, ctx.geom, *ctx.static)
        return (None, None, None) + tuple(d.to(ctx.dtype) for d in d_pyr)


def _window_roi_align(pyramid, geom, scales, rois, pooled, sampling_ratio,
                      k_min, k_max, canonical_scale, canonical_level):
    static = (tuple(scales), pooled, sampling_ratio, k_min, k_max,
              canonical_scale, canonical_level)
    return _WindowRoIAlign.apply(rois.detach(), geom, static, *pyramid)


def multilevel_roi_align_ladder_trainable(pyramid, scales, rois, pooled,
                                          sampling_ratio, k_min, k_max,
                                          canonical_scale, canonical_level,
                                          rungs, narrow_base=False):
    """multilevel_roi_align_ladder (same arguments and result) with a
    backward to the pyramid through kernel K4. The RoIs are treated as
    constants (proposals are detached, as in the reference)."""
    dims = [(f.shape[1], f.shape[2]) for f in pyramid]
    return _window_roi_align(pyramid, ladder_geom(dims, rungs, narrow_base),
                             scales, rois, pooled, sampling_ratio, k_min,
                             k_max, canonical_scale, canonical_level)


def multilevel_roi_align_single_window(pyramid, scales, rois, pooled,
                                       sampling_ratio, k_min, k_max,
                                       canonical_scale=224,
                                       canonical_level=4, window=32,
                                       x_cover=0):
    """The single-window route (multilevel_roi_align_pallas and its
    trainable form): pyramid levels k_min..k_max, each (B, H_l, W_l, C);
    rois (B, R, 4). Every RoI pools through K2 at a window of `window` rows
    and round8(max(window + 8, x_cover)) columns, its samples clamped to
    the window where it does not fit (exact for every RoI the window
    covers); the backward is K4 over the same windows, the exact transpose
    of that clamped map. Returns (B, R, pooled, pooled, C)."""
    dims = [(f.shape[1], f.shape[2]) for f in pyramid]
    return _window_roi_align(pyramid, single_window_geom(dims, window,
                                                         x_cover),
                             scales, rois, pooled, sampling_ratio, k_min,
                             k_max, canonical_scale, canonical_level)


def min_exact_window(canonical_scale, canonical_level, sampling_ratio):
    """Smallest window (cells) exact for all unclamped levels: max extent
    2 s0 / 2^l0, +2 bilinear border, +1 window-origin floor, rounded up."""
    return int(math.ceil(2.0 * canonical_scale / (2 ** canonical_level))) \
        + 4


_warned_small_window = set()


def _warn_if_window_small(window, canonical_scale, canonical_level,
                          sampling_ratio):
    """Logs once per window size when `window` is below min_exact_window:
    windows below the top level then clamp the samples of mid-range RoIs
    (the single window keeps those values; the windowed hybrid recomputes
    them by the exact gather)."""
    need = min_exact_window(canonical_scale, canonical_level, sampling_ratio)
    if window < need and window not in _warned_small_window:
        log.warning("ROI window %d < %d: sub-top-level RoIAlign may clamp "
                    "samples for mid-range RoIs (exact at window >= %d)",
                    window, need, need)
        _warned_small_window.add(window)


def multilevel_roi_align_single_window_hybrid(pyramid, scales, rois, pooled,
                                              sampling_ratio, k_min, k_max,
                                              canonical_scale=224,
                                              canonical_level=4, window=32):
    """The route of TPU.ROI_IMPL 'pallas' with TPU.ROI_LADDER off
    (multilevel_roi_align_pallas_hybrid), batched: pyramid levels k_min..
    k_max, each (B, H_l, W_l, C); rois (B, R, 4). Where the top level fits
    the window height (at 832 x 1344 P5 is 26 x 42), the single window over
    every level with the top level's width as x_cover, so that top-level
    RoIs take whole-level windows. Otherwise the single window below the
    top level, the top level pooled densely (ops/roi_align.py: K2 over the
    whole level, K4 in its backward), and each RoI takes the result of its
    own level: the window part gets no cotangent from top-level RoIs.
    Returns (B, R, pooled, pooled, C)."""
    if len(pyramid) == 1:
        return ra.roi_align_batched(pyramid[0], rois, scales[0], pooled,
                                    sampling_ratio)
    _warn_if_window_small(window, canonical_scale, canonical_level,
                          sampling_ratio)
    H_top, W_top = pyramid[-1].shape[1], pyramid[-1].shape[2]
    if H_top <= window:
        return multilevel_roi_align_single_window(
            pyramid, scales, rois, pooled, sampling_ratio, k_min, k_max,
            canonical_scale, canonical_level, window, x_cover=W_top)
    out_win = multilevel_roi_align_single_window(
        pyramid[:-1], scales[:-1], rois, pooled, sampling_ratio, k_min,
        k_max - 1, canonical_scale, canonical_level, window)
    out_top = ra.roi_align_batched(pyramid[-1], rois, scales[-1], pooled,
                                   sampling_ratio)
    is_top = ml.roi_levels(rois.to(torch.float32), k_min, k_max,
                           canonical_scale, canonical_level) == k_max
    return torch.where(is_top[..., None, None, None], out_top,
                       out_win.to(out_top.dtype))


def canvas_meta(dims, window):
    """The windowed hybrid's canvas geometry (JAX build_canvas :44-62 and
    _canvas_meta :165-174) for one image's levels dims [(H_l, W_l), ...]:
    levels stacked by rows, each padded to at least `window` rows, every
    row max(W_l) + window wide."""
    return _geom(dims, window, window, (), 0,
                 max(w for _, w in dims) + window)


def build_canvas_windowed(pyramid, window):
    """pyramid: list of one image's levels (H_l, W_l, C) -> (canvas (Hc, Wc,
    C), canvas_meta)."""
    geom = canvas_meta([(f.shape[0], f.shape[1]) for f in pyramid], window)
    return build_canvas([f[None] for f in pyramid], geom)[0], geom


def multilevel_roi_align_windowed(pyramid, scales, rois, pooled,
                                  sampling_ratio, k_min, k_max,
                                  canonical_scale=224, canonical_level=4,
                                  window=40, chunk=256):
    """pyramid: list of (H_l, W_l, C) for ONE image (k_min..k_max); rois
    (R, 4) image coords. Each RoI takes a window x window slice of the
    canvas (x origin at any column) and pools it with two products in
    float32 (float64 for a float64 pyramid), its weights first rounded to
    the pyramid dtype; `chunk` RoIs at a time bound the slices' memory.
    Plain PyTorch, differentiable by autograd. Returns ((R, pooled,
    pooled, C) in the pyramid dtype, ok (R,) bool: the window covered
    every sample of the RoI, see window_params)."""
    assert sampling_ratio > 0
    assert len(pyramid) == k_max - k_min + 1
    canvas, geom = build_canvas_windowed(pyramid, window)
    dtype = canvas.dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    sy, sx, vy, vx, ok = window_params(
        rois.to(torch.float32), geom, scales, pooled, sampling_ratio, k_min,
        k_max, canonical_scale, canonical_level, window, window, dtype,
        align_x=1)
    d = torch.arange(window, device=canvas.device)
    outs = []
    for s in range(0, rois.shape[0], chunk):
        e = min(rois.shape[0], s + chunk)
        ys = (sy[s:e].long()[:, None] + d)[:, :, None]
        xs = (sx[s:e].long()[:, None] + d)[:, None, :]
        win = canvas[ys, xs].to(acc)                   # (n, WIN, WIN, C)
        tmp = torch.einsum("rph,rhwc->rpwc", vy[s:e].to(acc), win)
        outs.append(torch.einsum("rqw,rpwc->rpqc", vx[s:e].to(acc),
                                 tmp).to(dtype))
    if not outs:
        C = canvas.shape[-1]
        return canvas.new_zeros((0, pooled, pooled, C)), ok
    return torch.cat(outs, dim=0), ok


def multilevel_roi_align_hybrid(pyramid, scales, rois, pooled,
                                sampling_ratio, k_min, k_max,
                                canonical_scale=224, canonical_level=4,
                                window=32, chunk=256):
    """The route of TPU.ROI_IMPL 'windowed', ONE image: pyramid levels
    (H_l, W_l, C), rois (R, 4). Exact RoIAlign for every RoI: the windowed
    slices below the top level, the top level pooled densely
    (ops/roi_align.py: K2 over the whole level, K4 in its backward), and
    the exact gather (ops/multilevel_roi.py) for the RoIs below the top
    level whose window was short, run only when some RoI needs it.
    Differentiable w.r.t. the pyramid by autograd. Returns (R, pooled,
    pooled, C)."""
    if len(pyramid) == 1:
        return ra.roi_align(pyramid[0], rois, scales[0], pooled,
                            sampling_ratio)
    _warn_if_window_small(window, canonical_scale, canonical_level,
                          sampling_ratio)
    out_win, win_ok = multilevel_roi_align_windowed(
        pyramid[:-1], scales[:-1], rois, pooled, sampling_ratio, k_min,
        k_max - 1, canonical_scale, canonical_level, window, chunk)
    out_top = ra.roi_align(pyramid[-1], rois, scales[-1], pooled,
                           sampling_ratio)
    is_top = ml.roi_levels(rois.to(torch.float32), k_min, k_max,
                           canonical_scale, canonical_level) == k_max
    out = torch.where(is_top[:, None, None, None], out_top, out_win)
    tracing.sync("windowed_roi.hybrid_gather")
    idx = torch.nonzero(~win_ok & ~is_top).flatten()
    if idx.numel() == 0:
        return out
    fix = ml.multilevel_roi_align(
        pyramid, scales, rois[idx], pooled, sampling_ratio, k_min, k_max,
        canonical_scale, canonical_level).to(out.dtype)
    return out.index_put((idx,), fix)
