"""RoIPool ('RoIPoolF'), Caffe2 semantics (port of detectron_tpu/ops/
roi_pool.py:22-72; reference: lib/model/roi_pooling's RoIPoolFunction).

Each RoI is scaled and rounded to map cells (x1 = round(x1 s), ...; round
half to even, as jnp.round), its extent is max(x2 - x1 + 1, 1), and bin p
of P covers the cells [floor(p b), ceil((p + 1) b)) + x1, clamped to the
map; the output is the max over the bin's cells, 0 for an empty bin. The
bin size b is extent x float32(1 / P), as the JAX package's compiled
graph computes extent / P (XLA turns a division by a constant into that
product); Caffe2 divides, which differs where (p + 1) b lands within an
ulp of an integer (extent 3, P = 14: ceil(14 b) is 4 here, 3 there).

The JAX package computes it in plain XLA (no Pallas kernel), as a scan
over the map's rows then its columns with bin-membership masks and an
(R, Ph, W, C) carry. The port is plain torch too, in RoI chunks: it
gathers each bin's rows (at most max-extent of them), takes their max and
its row, then the same over each bin's columns, so a chunk's largest
intermediate is (r, Ph, Lh, W, C) for the longest row bin Lh, bounded by
CHUNK_BYTES. The gradient goes to the argmax (the first one in the scan
order where values tie), which is what autodiff of the JAX package's max
gives away from ties; where the features need a gradient the forward
keeps the argmax cell of each output (int32) instead of a carry per map
row, and the backward adds the output gradient there (index_put_ with
accumulate, deterministic under torch's switch).
"""

import torch

from detectron_tpu_torch.utils import tracing

# Bytes of a chunk's intermediates in the forward.
CHUNK_BYTES = 1 << 28


def _bins(lo, extent, pooled, size):
    """[start, end) cell ranges (R, pooled) int64 of one axis's bins."""
    p = torch.arange(pooled, dtype=torch.float32, device=lo.device)
    tracing.sync("roi_pool.bins")
    b = extent * (1.0 / p.new_tensor(float(pooled)))
    start = torch.floor(p[None] * b[:, None]) + lo[:, None]
    end = torch.ceil((p[None] + 1) * b[:, None]) + lo[:, None]
    return (torch.clamp(start, 0, size).long(),
            torch.clamp(end, 0, size).long())


def _pool_chunk(feats, bidx, hs, he, ws, we, want_cell):
    """Max over each bin for r RoIs: feats (B, H, W, C); bidx (r,) image
    of each RoI; hs, he (r, Ph) and ws, we (r, Pw) bin ranges. Returns
    (out (r, Ph, Pw, C), and with want_cell the int32 flat (b, h, w) index
    of each argmax, -1 for an empty bin, else None)."""
    B, H, W, C = feats.shape
    r, Ph = hs.shape
    Pw = ws.shape[1]
    dev = feats.device
    tracing.sync("roi_pool.chunk_reach", 2)
    Lh = max(int((he - hs).max()), 1)
    Lw = max(int((we - ws).max()), 1)
    rows = hs[..., None] + torch.arange(Lh, device=dev)
    x = feats[bidx[:, None, None], rows.clamp(max=H - 1)]
    x = x.masked_fill((rows >= he[..., None])[..., None, None], -torch.inf)
    tmp, ih = x.max(dim=2)                                  # (r, Ph, W, C)
    cols = ws[..., None] + torch.arange(Lw, device=dev)
    y = tmp[torch.arange(r, device=dev)[:, None, None, None],
            torch.arange(Ph, device=dev)[None, :, None, None],
            cols.clamp(max=W - 1)[:, None]]             # (r, Ph, Pw, Lw, C)
    y = y.masked_fill((cols >= we[..., None])[:, None, :, :, None],
                      -torch.inf)
    out, iw = y.max(dim=3)                                  # (r, Ph, Pw, C)
    empty = out == -torch.inf
    out = out.masked_fill(empty, 0)
    if not want_cell:
        return out, None
    w = ws[:, None, :, None] + iw
    h = hs[:, :, None, None] + torch.gather(ih, 2, w.clamp(max=W - 1))
    cell = (bidx[:, None, None, None] * H + h) * W + w
    return out, cell.masked_fill(empty, -1).to(torch.int32)


class _RoIPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, rois, spatial_scale, pooled):
        B, H, W, C = feats.shape
        R = rois.shape[1]
        dev = feats.device
        sr = (rois.reshape(B * R, 4).to(torch.float32)
              * spatial_scale).round()
        bidx = torch.arange(B, device=dev).repeat_interleave(R)
        hs, he = _bins(sr[:, 1],
                       torch.clamp(sr[:, 3] - sr[:, 1] + 1, min=1.0),
                       pooled, H)
        ws, we = _bins(sr[:, 0],
                       torch.clamp(sr[:, 2] - sr[:, 0] + 1, min=1.0),
                       pooled, W)
        isz = feats.element_size()
        tracing.sync("roi_pool.reach", 2 if B * R else 0)
        lh = max(int((he - hs).max()), 1) if B * R else 1
        lw = max(int((we - ws).max()), 1) if B * R else 1
        per_roi = pooled * C * (W * (lh * isz + isz + 8)
                                + pooled * (lw * isz + 20))
        chunk = max(1, CHUNK_BYTES // per_roi)
        want_cell = ctx.needs_input_grad[0]
        outs, cells = [], []
        for s in range(0, B * R, chunk):
            o, c = _pool_chunk(feats, bidx[s:s + chunk], hs[s:s + chunk],
                               he[s:s + chunk], ws[s:s + chunk],
                               we[s:s + chunk], want_cell)
            outs.append(o)
            cells.append(c)
        out = torch.cat(outs) if outs else feats.new_zeros(
            0, pooled, pooled, C)
        if want_cell:
            ctx.save_for_backward(torch.cat(cells) if cells else
                                  torch.zeros(0, pooled, pooled, C,
                                              dtype=torch.int32,
                                              device=dev))
        ctx.shape = feats.shape
        ctx.dtype = feats.dtype
        return out.reshape(B, R, pooled, pooled, C)

    @staticmethod
    def backward(ctx, g):
        cell, = ctx.saved_tensors
        B, H, W, C = ctx.shape
        valid = cell >= 0
        idx = cell.clamp(min=0).long() * C + torch.arange(
            C, device=cell.device)
        acc = torch.promote_types(ctx.dtype, torch.float32)
        grad = torch.zeros(B * H * W * C, dtype=acc, device=cell.device)
        grad.index_put_((idx.reshape(-1),),
                        (g.reshape(cell.shape).to(acc) * valid).reshape(-1),
                        accumulate=True)
        return grad.reshape(B, H, W, C).to(ctx.dtype), None, None, None


def roi_pool_batched(feats, rois, spatial_scale, pooled):
    """feats (B, H, W, C); rois (B, R, 4) in image coords. Returns
    (B, R, pooled, pooled, C) in the feature dtype, differentiable w.r.t.
    feats."""
    return _RoIPool.apply(feats, rois, float(spatial_scale), int(pooled))
