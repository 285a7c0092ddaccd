"""RoICrop: the spatial-transformer bilinear crop of ROI_XFORM_METHOD
'RoICrop' (port of detectron_tpu/ops/roi_crop.py:22-64; reference:
lib/model/roi_crop with its affine grid generator).

Output index p of P samples the coordinate start + (end - start) p /
(P - 1) on each axis (the align-corners affine grid over the scaled RoI,
its end included), bilinearly, with zeros outside the map. Under
CROP_RESIZE_WITH_MAX_POOL the crop is taken at 2P x 2P and max-pooled
2 x 2. Per axis the samples are interpolation weights vy (R, P, H) and
vx (R, P, W), and

    out[r, p, q, c] = sum_w vx[r, q, w] sum_h vy[r, p, h] feat[b, h, w, c],

two float32 products (the JAX package's einsums at precision HIGHEST),
in RoI chunks: the first product's (r, P, W, C) float32 intermediate is
bounded by CHUNK_BYTES. Plain torch, as the JAX package's is plain XLA;
autograd gives the gradient (the pool's goes to its max, split evenly
between ties, as JAX's reduce_max does).
"""

import torch

from detectron_tpu_torch.utils import tracing

# Bytes of a chunk's float32 intermediate.
CHUNK_BYTES = 1 << 28


def crop_axis_weights(starts, ends, pooled, size):
    """(R, pooled, size) float32 bilinear weights of the grid coordinates
    starts + (ends - starts) p / max(pooled - 1, 1); zero for a coordinate
    outside [0, size - 1]. The division is a product with
    float32(1 / max(pooled - 1, 1)), as the JAX package's compiled graph
    computes it (ops/roi_pool.py says why it matters)."""
    p = torch.arange(pooled, dtype=torch.float32, device=starts.device)
    tracing.sync("roi_crop.weights")
    inv = 1.0 / p.new_tensor(float(max(pooled - 1, 1)))
    coords = starts[:, None] + (ends - starts)[:, None] * p[None, :] * inv
    in_bounds = (coords >= 0.0) & (coords <= size - 1.0)
    cc = torch.clamp(coords, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=torch.float32, device=starts.device)
    w = torch.clamp(1.0 - torch.abs(cc[..., None] - idx), min=0.0)
    return w * in_bounds[..., None]


def roi_crop_batched(feats, rois, spatial_scale, pooled, max_pool=True):
    """feats (B, H, W, C); rois (B, R, 4) image coords. Returns
    (B, R, pooled, pooled, C) in the feature dtype."""
    B, H, W, C = feats.shape
    R = rois.shape[1]
    n = 2 * pooled if max_pool else pooled
    r = rois.to(torch.float32) * spatial_scale
    vy = crop_axis_weights(r[..., 1].reshape(-1), r[..., 3].reshape(-1), n,
                           H).reshape(B, R, n, H)
    vx = crop_axis_weights(r[..., 0].reshape(-1), r[..., 2].reshape(-1), n,
                           W).reshape(B, R, n, W)
    chunk = max(1, CHUNK_BYTES // (n * W * C * 4))
    outs = []
    for b in range(B):
        f = feats[b].to(torch.float32)
        for s in range(0, R, chunk):
            tmp = torch.einsum("rph,hwc->rpwc", vy[b, s:s + chunk], f)
            outs.append(torch.einsum("rqw,rpwc->rpqc", vx[b, s:s + chunk],
                                     tmp))
    out = torch.cat(outs).reshape(B * R, n, n, C)
    if max_pool:
        out = out.reshape(B * R, pooled, 2, pooled, 2, C).amax(dim=(2, 4))
    return out.to(feats.dtype).reshape(B, R, pooled, pooled, C)
