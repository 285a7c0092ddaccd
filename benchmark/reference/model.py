"""Plain PyTorch Mask R-CNN inference (ResNet-50 FPN or C4), image by image.

The yardstick that decides `correct`. It reads the configuration's keys
(benchmark/configs/<config>.json, "cfg") and a weights tree in the layout
the benchmark makes (benchmark/weights.py), and imports nothing of the
program. It follows Detectron's published inference:

- ResNet body with frozen BatchNorm as a per-channel affine, the stride on
  the 1x1 conv (RESNETS.STRIDE_1X1), res2-res5 feeding an FPN (1x1
  laterals, nearest x2 top-down, 3x3 output convs, P6 by subsampling P5),
  or res2-res4 feeding a single-level RPN (C4);
- RPN: a 3x3 conv, objectness and box deltas per anchor; per level the
  top RPN_PRE_NMS_TOP_N anchors, decoded, clipped, filtered at
  RPN_MIN_SIZE, NMS at RPN_NMS_THRESH; FPN keeps every survivor of every
  level and takes the RPN_POST_NMS_TOP_N best over all levels, C4 the
  best RPN_POST_NMS_TOP_N survivors;
- RoIAlign (Detectron v1: no half-pixel offset, extent at least 1, a
  sample outside [-1, size] weighs zero), on the FPN level of
  floor(4 + log2(sqrt(area) / 224)) clipped to [2, 5]; an adaptive
  sampling grid (ratio 0) is capped at 4 samples a bin axis, as the
  program documents (Detectron's grid is uncapped; the two differ only
  for RoIs over 896 px at 14 x 14 on a stride-16 map);
- box head (2mlp, or C4's res5 and a spatial mean), softmax, per-class
  decode with BBOX_REG_WEIGHTS, clip, SCORE_THRESH, per-class NMS at
  TEST.NMS, the best DETECTIONS_PER_IM over all classes;
- mask head (4 convs + deconv, or C4's shared res5 + deconv) on given
  boxes, each box's class channel through a sigmoid.

Everything runs in float32 with TF32 off (the caller runs it inside
no_tf32(), which restores the backends' flags after). A `Precision` of
the control rounds the inputs and weights of every convolution and fully
connected layer one precision below the configuration's: float8 e4m3 with
a per-tensor scale for bfloat16 (and bfloat16 for a float32 configuration
of the CPU tests).

Greedy NMS keeps a box unless a kept box before it in score order
overlaps it with IoU > the threshold (boxes with Detectron's +1 extent);
equal scores keep their index order.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """The reference's float32: matmuls and cuDNN convolutions without
    TF32 inside the block; the flags the process had are restored after,
    so the program runs with its own."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class Precision:
    """float32 (dtype None), or the control's rounding of every matmul
    input to `dtype`: float8 e4m3 with a per-tensor scale, or bfloat16."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def q(self, x):
        if self.dtype is None:
            return x
        if self.dtype == torch.bfloat16:
            return x.to(torch.bfloat16).to(torch.float32)
        s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(self.dtype).to(torch.float32) * s


# The control's precision: the nearest below each compute dtype.
CONTROL = {"bfloat16": torch.float8_e4m3fn, "float32": torch.bfloat16}


F32 = Precision()


class Model:
    """The configuration's model over a weights tree, float32 on the
    tree's device. `cfg` is the configuration file's "cfg" dict."""

    def __init__(self, cfg, params, prec=F32):
        self.cfg = cfg
        self.p = params
        self.prec = prec
        self.fpn = bool(cfg["FPN.FPN_ON"])

    # ---- layers -----------------------------------------------------

    def conv(self, p, x, stride=1, padding=0):
        w = p["w"].float()
        y = F.conv2d(self.prec.q(x), self.prec.q(w), None, stride, padding)
        if "b" in p:
            y = y + p["b"].float()[None, :, None, None]
        return y

    def deconv(self, p, x):
        y = F.conv_transpose2d(self.prec.q(x), self.prec.q(p["w"].float()),
                               None, 2, 0)
        return y + p["b"].float()[None, :, None, None]

    def fc(self, p, x):
        return self.prec.q(x) @ self.prec.q(p["w"].float()) + p["b"].float()

    @staticmethod
    def affine(p, x):
        return x * p["s"].float()[None, :, None, None] + \
            p["b"].float()[None, :, None, None]

    def bottleneck(self, p, x, stride):
        h = torch.relu(self.affine(p["branch2a_bn"],
                                   self.conv(p["branch2a"], x, stride)))
        h = torch.relu(self.affine(p["branch2b_bn"],
                                   self.conv(p["branch2b"], h, 1, 1)))
        h = self.affine(p["branch2c_bn"], self.conv(p["branch2c"], h))
        sc = x
        if "branch1" in p:
            sc = self.affine(p["branch1_bn"], self.conv(p["branch1"], x,
                                                        stride))
        return torch.relu(h + sc)

    def stage(self, blocks, x, stride):
        for i, bp in enumerate(blocks):
            x = self.bottleneck(bp, x, stride if i == 0 else 1)
        return x

    # ---- body, FPN, RPN ----------------------------------------------

    def features(self, image):
        """image (H, W, 3) -> ([feature maps (1, C, h, w)], [scales])."""
        b = self.p["body"]
        x = image.float().permute(2, 0, 1)[None]
        x = self.conv(b["conv1"], x, 2, 3)
        x = torch.relu(self.affine(b["res_conv1_bn"], x))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        n_stages = 4 if self.fpn else 3
        for s in range(n_stages):
            x = self.stage(b["res{}".format(s + 2)], x, 1 if s == 0 else 2)
            outs.append(x)
        if not self.fpn:
            return [outs[-1]], [1.0 / 16]
        p = self.p["fpn"]
        inner, td = {}, None
        for i in reversed(range(4)):
            lat = self.conv(p["fpn_inner_res{}".format(i + 2)], outs[i])
            if td is not None:
                up = td.repeat_interleave(2, 2).repeat_interleave(2, 3)
                lat = lat + up[:, :, :lat.shape[2], :lat.shape[3]]
            td = inner[i + 2] = lat
        pyr = [self.conv(p["fpn_res{}".format(l)], inner[l], 1, 1)
               for l in range(2, 6)]
        pyr.append(pyr[-1][:, :, ::2, ::2])
        return pyr, [1.0 / 2 ** l for l in range(2, 7)]

    def anchor_configs(self):
        c = self.cfg
        if self.fpn:
            lo = c["FPN.RPN_MIN_LEVEL"]
            return [(2 ** l, (c["FPN.RPN_ANCHOR_START_SIZE"] * 2 ** (l - lo),),
                     c["FPN.RPN_ASPECT_RATIOS"])
                    for l in range(lo, c["FPN.RPN_MAX_LEVEL"] + 1)]
        return [(c["RPN.STRIDE"], c["RPN.SIZES"], c["RPN.ASPECT_RATIOS"])]

    def rpn(self, feats):
        """Per level (objectness logits (n,), box deltas (n, 4), anchors
        (n, 4)), cells row-major and anchors fastest."""
        p = self.p["rpn"]
        out = []
        for f, (stride, sizes, ratios) in zip(feats, self.anchor_configs()):
            h = torch.relu(self.conv(p["conv_rpn"], f, 1, 1))
            logits = self.conv(p["rpn_cls_logits"], h)[0]      # (A, H, W)
            deltas = self.conv(p["rpn_bbox_pred"], h)[0]       # (4A, H, W)
            A, H, W = logits.shape
            out.append((logits.permute(1, 2, 0).reshape(-1),
                        deltas.reshape(A, 4, H, W).permute(2, 3, 0, 1)
                        .reshape(-1, 4),
                        torch.from_numpy(anchor_field(
                            stride, sizes, ratios, H, W)).to(logits.device)))
        return out

    def level_candidates(self, rpn, im_info, k):
        """Per level the top k anchors by objectness, decoded and clipped:
        (boxes (k, 4), scores (k,), valid (k,)) in score order."""
        c = self.cfg
        h_im, w_im, scale = (float(v) for v in im_info)
        levels = []
        for logits, deltas, anchors in rpn:
            top, idx = torch.sort(logits, descending=True, stable=True)
            top, idx = top[:k], idx[:k]
            boxes = decode(anchors[idx], deltas[idx], (1.0, 1.0, 1.0, 1.0),
                           c["BBOX_XFORM_CLIP"])
            boxes = clip_boxes(boxes, h_im, w_im)
            ws = boxes[:, 2] - boxes[:, 0] + 1
            hs = boxes[:, 3] - boxes[:, 1] + 1
            min_size = c["TEST.RPN_MIN_SIZE"] * scale
            levels.append((boxes, torch.sigmoid(top),
                           (ws >= min_size) & (hs >= min_size)))
        return levels

    def proposals(self, feats, im_info, rpn=None):
        """(rois (R, 4), valid (R,)) of one image, R = RPN_POST_NMS_TOP_N
        slots."""
        c = self.cfg
        post_n = c["TEST.RPN_POST_NMS_TOP_N"]
        levels = self.level_candidates(rpn or self.rpn(feats), im_info,
                                       c["TEST.RPN_PRE_NMS_TOP_N"])
        keeps = nms_lanes([b for b, _, _ in levels], [v for _, _, v in levels],
                          c["TEST.RPN_NMS_THRESH"])
        if len(levels) == 1:
            boxes, scores, _ = levels[0]
            kept = torch.nonzero(keeps[0]).reshape(-1)[:post_n]
            rois = torch.zeros(post_n, 4, device=boxes.device)
            valid = torch.zeros(post_n, dtype=torch.bool, device=boxes.device)
            rois[:len(kept)] = boxes[kept]
            valid[:len(kept)] = True
            return rois, valid
        boxes = torch.cat([b for b, _, _ in levels])
        scores = torch.cat([torch.where(k, s, -math.inf)
                            for (_, s, _), k in zip(levels, keeps)])
        top, idx = torch.sort(scores, descending=True, stable=True)
        n = min(post_n, len(top))
        valid = torch.isfinite(top[:n])
        return boxes[idx[:n]] * valid[:, None], valid

    def pool(self, feats, scales, im_info, margin, rpn=None):
        """The candidates of every anchor among each level's top
        margin x RPN_PRE_NMS_TOP_N, before NMS: (probs (N, C), class boxes
        (N, C, 4)). A superset of the proposals that the top-k and NMS
        choose in any precision close to this one."""
        k = math.ceil(margin * self.cfg["TEST.RPN_PRE_NMS_TOP_N"])
        levels = self.level_candidates(rpn or self.rpn(feats), im_info, k)
        rois = torch.cat([b for b, _, _ in levels])
        valid = torch.cat([v for _, _, v in levels])
        return self.candidates(feats, scales, rois, valid, im_info)

    # ---- RoI transform and heads ------------------------------------

    def roi_features(self, feats, scales, rois, pooled, ratio):
        """(R, C, P, P) RoIAlign of rois (R, 4), each on its FPN level."""
        if not self.fpn:
            return roi_align(feats[0][0], rois, scales[0], pooled, ratio)
        c = self.cfg
        k_min, k_max = c["FPN.ROI_MIN_LEVEL"], c["FPN.ROI_MAX_LEVEL"]
        lvl = roi_levels(rois, k_min, k_max, c["FPN.ROI_CANONICAL_SCALE"],
                         c["FPN.ROI_CANONICAL_LEVEL"])
        out = torch.zeros(rois.shape[0], feats[0].shape[1], pooled, pooled,
                          device=rois.device)
        for l in range(k_min, k_max + 1):
            sel = torch.nonzero(lvl == l).reshape(-1)
            if len(sel):
                out[sel] = roi_align(feats[l - 2][0], rois[sel],
                                     scales[l - 2], pooled, ratio)
        return out

    def res5(self, x):
        return self.stage(self.p["box_head"]["res5"], x, 2)

    def box_features(self, feats, scales, rois, chunk=1024):
        """The box head's features of rois (R, 4), (R, hidden), in RoI
        chunks."""
        c = self.cfg
        out = []
        for i in range(0, rois.shape[0], chunk):
            x = self.roi_features(feats, scales, rois[i:i + chunk],
                                  c["FAST_RCNN.ROI_XFORM_RESOLUTION"],
                                  c["FAST_RCNN.ROI_XFORM_SAMPLING_RATIO"])
            if self.fpn:
                hp = self.p["box_head"]
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                x = torch.relu(self.fc(hp["fc7"], torch.relu(
                    self.fc(hp["fc6"], x))))
            else:
                x = self.res5_chunked(x).mean((2, 3))
            out.append(x)
        return torch.cat(out)

    def box_outputs(self, feats, scales, rois):
        x = self.box_features(feats, scales, rois)
        o = self.p["box_outs"]
        return self.fc(o["cls_score"], x), self.fc(o["bbox_pred"], x)

    def res5_chunked(self, x, chunk=128):
        return torch.cat([self.res5(x[i:i + chunk])
                          for i in range(0, x.shape[0], chunk)])

    def candidates(self, feats, scales, rois, valid, im_info):
        """Every proposal's class probabilities (R, C) and decoded, clipped
        class boxes (R, C, 4)."""
        c = self.cfg
        logits, deltas = self.box_outputs(feats, scales, rois)
        probs = torch.softmax(logits, -1) * valid[:, None]
        boxes = decode(rois, deltas, c["MODEL.BBOX_REG_WEIGHTS"],
                       c["BBOX_XFORM_CLIP"])
        h_im, w_im = float(im_info[0]), float(im_info[1])
        return probs, clip_boxes(boxes.reshape(-1, 4), h_im, w_im).reshape(
            boxes.shape)

    def detections(self, probs, boxes):
        """Per-class NMS and the best DETECTIONS_PER_IM: (boxes (D, 4),
        scores (D,), classes (D,) int64, valid (D,))."""
        c = self.cfg
        D = c["TEST.DETECTIONS_PER_IM"]
        thresh = c["TEST.SCORE_THRESH"]
        s = probs[:, 1:].t()                                # (C-1, R)
        b = boxes[:, 1:].transpose(0, 1)                    # (C-1, R, 4)
        s = torch.where(s > thresh, s, -math.inf)
        order = torch.sort(s, dim=1, descending=True, stable=True)[1]
        s = torch.gather(s, 1, order)
        b = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
        keep = nms_lanes(list(b), list(torch.isfinite(s)), c["TEST.NMS"])
        kept = torch.where(torch.stack(keep), s, -math.inf).reshape(-1)
        top, idx = torch.sort(kept, descending=True, stable=True)
        top, idx = top[:D], idx[:D]
        valid = torch.isfinite(top)
        R = s.shape[1]
        cls = torch.div(idx, R, rounding_mode="floor") + 1
        out_b = b.reshape(-1, 4)[idx] * valid[:, None]
        return (out_b, torch.where(valid, top, 0.0),
                torch.where(valid, cls, 0), valid)

    def mask_probs(self, feats, scales, boxes, classes):
        """Sigmoid of each box's class channel, (D, M, M)."""
        logits = self.mask_logits(feats, scales, boxes)
        sel = torch.gather(logits, 1, classes.long()[:, None, None, None]
                           .expand(-1, 1, *logits.shape[2:]))[:, 0]
        return torch.sigmoid(sel)

    def mask_logits(self, feats, scales, boxes):
        """Every class's mask logits on boxes (D, 4), (D, C, M, M)."""
        c = self.cfg
        x = self.roi_features(feats, scales, boxes,
                              c["MRCNN.ROI_XFORM_RESOLUTION"],
                              c["MRCNN.ROI_XFORM_SAMPLING_RATIO"])
        mp = self.p["mask_head"]
        if self.fpn:
            for cp in mp["convs"]:
                x = torch.relu(self.conv(cp, x, 1, 1))
        else:
            x = self.res5_chunked(x)
        x = torch.relu(self.deconv(mp["deconv"], x))
        return self.conv(self.p["mask_outs"]["mask_fcn_logits"], x)


# ---- geometry ---------------------------------------------------------

def generate_anchors(stride, sizes, aspect_ratios):
    """Detectron's cell anchors: a (0, 0, stride-1, stride-1) window,
    enumerated over aspect ratios (rounded widths and heights) then
    scales. (A, 4) float32."""
    base = np.array([1, 1, stride, stride], np.float64) - 1

    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack((xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)))

    w, h, xc, yc = whctrs(base)
    ratios = np.array(aspect_ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    by_ratio = mk(ws, hs, xc, yc)
    scales = np.array(sizes, np.float64) / stride
    out = []
    for a in by_ratio:
        w, h, xc, yc = whctrs(a)
        out.append(mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def anchor_field(stride, sizes, ratios, H, W):
    """(H * W * A, 4) anchors, row-major over cells, anchors fastest."""
    cell = generate_anchors(stride, sizes, ratios)
    sx, sy = np.meshgrid(np.arange(W) * stride, np.arange(H) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (shifts[:, None, :].astype(np.float32) + cell[None]).reshape(-1, 4)


def decode(boxes, deltas, weights, clip):
    """Box deltas (N, 4K) against boxes (N, 4) -> (N, K, 4)."""
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    d = deltas.reshape(deltas.shape[0], -1, 4)
    wx, wy, ww, wh = weights
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=float(clip))
    dh = torch.clamp(d[..., 3] / wh, max=float(clip))
    pcx = dx * w[:, None] + cx[:, None]
    pcy = dy * h[:, None] + cy[:, None]
    pw = torch.exp(dw) * w[:, None]
    ph = torch.exp(dh) * h[:, None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], -1)
    return out if deltas.shape[1] > 4 else out[:, 0]


def clip_boxes(boxes, h, w):
    x = boxes[..., 0::2].clamp(0.0, w - 1.0)
    y = boxes[..., 1::2].clamp(0.0, h - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def iou_matrix(a, b):
    """IoU (N, M) of boxes a (N, 4) and b (M, 4), +1 extents."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms_lanes(boxes, valid, thresh):
    """Greedy NMS of each lane of score-sorted boxes (lists of (N_l, 4) and
    (N_l,) bool). Returns the keep masks, (N_l,) bool each."""
    out = []
    for b, v in zip(boxes, valid):
        n_valid = int(v.sum())
        keep = v.cpu().numpy().copy()
        if n_valid:
            last = int(torch.nonzero(v).max()) + 1
            sup = (iou_matrix(b[:last], b[:last]) > thresh).cpu().numpy()
            for i in range(last):
                if keep[i]:
                    keep[i + 1:last] &= ~sup[i, i + 1:]
        out.append(torch.from_numpy(keep).to(b.device))
    return out


def roi_levels(rois, k_min, k_max, canonical_scale, canonical_level):
    w = rois[:, 2] - rois[:, 0] + 1
    h = rois[:, 3] - rois[:, 1] + 1
    s = torch.sqrt(torch.clamp(w * h, min=1e-12))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale
                                                    + 1e-6))
    return torch.clamp(lvl, k_min, k_max).long()


def axis_taps(start, extent, pooled, ratio, size, grid_cap=4):
    """Bilinear taps of one axis for RoIs (R,): indices and weights (R,
    pooled, 2 G), the 1/G sample average folded in; G = ratio, or the
    adaptive ceil(extent / pooled) capped at grid_cap when ratio is 0."""
    R = start.shape[0]
    dev = start.device
    bin_size = extent / pooled
    if ratio > 0:
        G = ratio
        count = torch.full((R,), float(G), device=dev)
    else:
        G = grid_cap
        count = torch.clamp(torch.ceil(extent / pooled), 1, G)
    p = torch.arange(pooled, device=dev, dtype=torch.float32)
    g = torch.arange(G, device=dev, dtype=torch.float32)
    coords = (start[:, None, None] + p[None, :, None] * bin_size[:, None, None]
              + (g[None, None, :] + 0.5) * bin_size[:, None, None]
              / count[:, None, None])
    used = (g[None, None, :] < count[:, None, None]) & (coords >= -1.0) & \
        (coords <= size)
    cc = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(cc)
    hi = torch.clamp(lo + 1, max=size - 1.0)
    frac = cc - lo
    wt = used.float() / count[:, None, None]
    idx = torch.cat([lo, hi], -1).long()
    w = torch.cat([(1 - frac) * wt, frac * wt], -1)
    return idx, w


def roi_align(feat, rois, scale, pooled, ratio, max_elems=2 ** 28):
    """RoIAlign of rois (R, 4) on feat (C, H, W) -> (R, C, P, P): each
    output is the weighted sum of its samples' four neighbours, gathered
    and summed elementwise, in RoI chunks that bound the gathered block."""
    C, H, W = feat.shape
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    ext_w = torch.clamp(rois[:, 2] * scale - x1, min=1.0)
    ext_h = torch.clamp(rois[:, 3] * scale - y1, min=1.0)
    iy, wy = axis_taps(y1, ext_h, pooled, ratio, H)
    ix, wx = axis_taps(x1, ext_w, pooled, ratio, W)
    R, P, T = iy.shape
    chunk = max(1, max_elems // (C * (P * T) ** 2))
    out = []
    for s in range(0, R, chunk):
        e = min(R, s + chunk)
        r = e - s
        yy = iy[s:e].reshape(r, P * T)
        xx = ix[s:e].reshape(r, P * T)
        g = feat[:, yy[:, :, None], xx[:, None, :]]       # (C, r, PT, PT)
        g = g.reshape(C, r, P * T, P, T) * wx[s:e][None, :, None]
        g = g.sum(-1).reshape(C, r, P, T, P) * wy[s:e][None, :, :, :, None]
        out.append(g.sum(3).permute(1, 0, 2, 3))
    return torch.cat(out) if out else feat.new_zeros(0, C, pooled, pooled)
