"""Single-level RoIAlign, the RoI feature transform of the C4 models (port
of detectron_tpu/ops/roi_align.py: _axis_weights :33-61, roi_align
:64-147, roi_align_batched :170-190).

Detectron v1 semantics: no half-pixel offset, a RoI extent of
max(x2 s - x1 s, 1), a sample outside [-1, size] is zero and its
coordinate clamps to [0, size - 1]. With sampling_ratio 0 the adaptive
grid ceil(roi_size / pooled) is capped at grid_cap = 4 samples per bin
axis, as in the JAX package (Detectron's grid is uncapped; the two differ
only for RoIs over 4 * pooled / scale pixels, 896 px at 14 x 14 on a
stride-16 map).

Bilinear sampling separates per axis into interpolation weights, the
sampling grid's average folded in: vy (R, P, H) and vx (R, P, W), and

    out[r, p, q, c] = sum_w vx[r, q, w] sum_h vy[r, p, h] feat[b, h, w, c].

The JAX package evaluates that as two dense products, in RoI chunks (the
first product's (chunk, P, W, C) intermediate is ~4.8 MB a RoI at a
52 x 84 x 1024 map). The port pools it with kernel K2
(ops/cuda/roi_align_kernel.roi_window_pool), whose window is the whole map
(starts (b, 0, 0)): the kernel reads only the cells the weights reach and
keeps no intermediate. Its backward is the transpose, kernel K4
(roi_window_accum), into a float32 map gradient. Both sums are float32;
in bfloat16 the weights are rounded to bfloat16 first, as the JAX package
rounds them (roi_align.py:105-111), and the result is in the feature dtype.
K2 and K4 take windows of up to MAX_WINDOW (128) cells a side: on a map
side longer than that (an image side over 2048 px at stride 16), each RoI
gets the window of its own reach along that side, and only a RoI whose
reach is itself longer raises. On CPU tensors the kernels' plain versions
run.
"""

import torch

from detectron_tpu_torch.ops.cuda.roi_align_kernel import (
    MAX_WINDOW, roi_window_accum, roi_window_pool)
from detectron_tpu_torch.utils import tracing


def axis_weights(starts, bin_sizes, grid_counts, pooled, grid_cap, size):
    """Interpolation weights of one axis: starts, bin_sizes (R,) float32
    in feature coordinates, grid_counts (R,) the samples per bin
    (<= grid_cap). Returns (R, pooled, size) float32, the 1/grid average
    folded in, out-of-bounds samples zero."""
    dt, dev = starts.dtype, starts.device
    p = torch.arange(pooled, dtype=dt, device=dev)
    g = torch.arange(grid_cap, dtype=dt, device=dev)
    gc = grid_counts.to(dt)[:, None, None]
    coords = (starts[:, None, None] + p[None, :, None]
              * bin_sizes[:, None, None]
              + (g[None, None, :] + 0.5) * bin_sizes[:, None, None] / gc)
    in_grid = g[None, None, :] < gc
    in_bounds = (coords >= -1.0) & (coords <= size)
    cc = torch.clamp(coords, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=dt, device=dev)
    w = torch.clamp(1.0 - torch.abs(cc[..., None] - idx), min=0.0)
    w = torch.where((in_grid & in_bounds)[..., None], w, 0.0)
    return w.sum(2) / gc


def roi_weights(rois, spatial_scale, pooled, sampling_ratio, H, W,
                grid_cap=4):
    """vy (R, pooled, H) and vx (R, pooled, W), float32, for rois (R, 4)
    [x1, y1, x2, y2] in image coordinates."""
    rois = rois.to(torch.float32)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = roi_w / pooled
    bin_h = roi_h / pooled
    if sampling_ratio > 0:
        G = sampling_ratio
        gh = gw = torch.full(rois.shape[:1], G, dtype=torch.int32,
                             device=rois.device)
    else:
        G = grid_cap
        gh = torch.clamp(torch.ceil(roi_h / pooled), 1, G).to(torch.int32)
        gw = torch.clamp(torch.ceil(roi_w / pooled), 1, G).to(torch.int32)
    return (axis_weights(y1, bin_h, gh, pooled, G, H),
            axis_weights(x1, bin_w, gw, pooled, G, W))


def _window(v, size):
    """Window origins (R,) int32 and the weights v (R, P, size) cut to a
    window of at most MAX_WINDOW cells along the last axis: the whole
    side where it fits, else each RoI's own reach (the span of its
    nonzero weights), one window length for all RoIs. Raises where a RoI
    reaches further than MAX_WINDOW cells."""
    R = v.shape[0]
    if size <= MAX_WINDOW:
        return torch.zeros(R, dtype=torch.int32, device=v.device), v
    idx = torch.arange(size, device=v.device)
    nz = v.ne(0).any(1)
    lo = torch.where(nz, idx, size).amin(1)
    hi = torch.where(nz, idx, -1).amax(1)
    tracing.sync("roi_align.window", 1 if R else 0)
    reach = int((hi - lo + 1).clamp(min=1).max()) if R else 1
    if reach > MAX_WINDOW:
        raise ValueError(
            "roi_align: a RoI reaches {} cells of a {}-cell map side; the "
            "RoIAlign kernels take windows of at most {}".format(
                reach, size, MAX_WINDOW))
    start = torch.clamp(lo, max=size - reach)
    cols = start[:, None] + torch.arange(reach, device=v.device)
    win = torch.gather(v, 2, cols[:, None, :].expand(-1, v.shape[1], -1))
    return start.to(torch.int32), win.contiguous()


class _RoIAlign(torch.autograd.Function):
    """K2 over per-RoI windows; backward K4 into a float32 map gradient
    (float64 for a float64 cotangent). vy and vx are the forward's
    weights, in the feature dtype."""

    @staticmethod
    def forward(ctx, feat, starts, vy, vx):
        ctx.save_for_backward(starts, vy, vx)
        ctx.shape, ctx.dtype = feat.shape, feat.dtype
        return roi_window_pool(feat, starts, vy, vx)

    @staticmethod
    def backward(ctx, ct):
        starts, vy, vx = ctx.saved_tensors
        acc = torch.float64 if ct.dtype == torch.float64 else torch.float32
        grad = torch.zeros(ctx.shape, dtype=acc, device=ct.device)
        roi_window_accum(grad, starts, ct.to(acc).contiguous(),
                         vy.to(acc).contiguous(), vx.to(acc).contiguous())
        return grad.to(ctx.dtype), None, None, None


def roi_align_batched(feats, rois, spatial_scale, pooled, sampling_ratio=0,
                      grid_cap=4):
    """feats (B, H, W, C); rois (B, R, 4) in image coordinates. Returns
    (B, R, pooled, pooled, C) in the feature dtype, differentiable w.r.t.
    feats (the RoIs are constants: proposals are detached, as in the
    reference)."""
    B, H, W, C = feats.shape
    R = rois.shape[1]
    flat = rois.detach().reshape(B * R, 4)
    vy, vx = roi_weights(flat, spatial_scale, pooled, sampling_ratio, H, W,
                         grid_cap)
    y0, vy = _window(vy, H)
    x0, vx = _window(vx, W)
    img = torch.arange(B, dtype=torch.int32,
                       device=feats.device).repeat_interleave(R)
    starts = torch.stack([img, y0, x0], dim=-1).contiguous()
    out = _RoIAlign.apply(feats.contiguous(), starts,
                          vy.to(feats.dtype).contiguous(),
                          vx.to(feats.dtype).contiguous())
    return out.reshape(B, R, pooled, pooled, C)


def roi_align(feat, rois, spatial_scale, pooled, sampling_ratio=0,
              grid_cap=4):
    """One image: feat (H, W, C), rois (R, 4) -> (R, pooled, pooled, C)."""
    return roi_align_batched(feat[None], rois[None], spatial_scale, pooled,
                             sampling_ratio, grid_cap)[0]
