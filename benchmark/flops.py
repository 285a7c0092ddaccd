"""The work of one image's inference, counted from the configuration and the
cell's shapes: every convolution, transposed convolution and fully
connected layer at 2 FLOPs a multiply-add, at the RoI and detection slots
the program runs (RPN_POST_NMS_TOP_N proposals, DETECTIONS_PER_IM masks,
valid or not). It is the same whatever kernel implements the work; the
RoI transforms, NMS, sorts and elementwise work count nothing here.
"""

R50_BLOCKS = (3, 4, 6, 3)
# One H100 SXM's dense peak by compute dtype (NVIDIA's data sheet, 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def conv(cin, cout, k, h_out, w_out):
    return 2 * cin * cout * k * k * h_out * w_out


def out_size(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _bottleneck(cin, cout, inner, stride, h, w, shortcut):
    """(FLOPs, h_out, w_out); the stride is on the 1x1 (STRIDE_1X1)."""
    ho, wo = out_size(h, 1, stride, 0), out_size(w, 1, stride, 0)
    f = conv(cin, inner, 1, ho, wo) + conv(inner, inner, 3, ho, wo) + \
        conv(inner, cout, 1, ho, wo)
    if shortcut:
        f += conv(cin, cout, 1, ho, wo)
    return f, ho, wo


def _stage(n, cin, cout, inner, stride, h, w):
    total = 0
    for i in range(n):
        f, h, w = _bottleneck(cin if i == 0 else cout, cout, inner,
                              stride if i == 0 else 1, h, w, i == 0)
        total += f
    return total, h, w


def inference_per_image(cfg, canvas):
    """FLOPs of one image at `canvas` (H, W), and the maps' sizes."""
    fpn = bool(cfg["FPN.FPN_ON"])
    H, W = canvas
    h, w = out_size(H, 7, 2, 3), out_size(W, 7, 2, 3)
    total = conv(3, 64, 7, h, w)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    sizes, cin = [], 64
    for s in range(4 if fpn else 3):
        f, h, w = _stage(R50_BLOCKS[s], cin, 256 * 2 ** s, 64 * 2 ** s,
                         1 if s == 0 else 2, h, w)
        total += f
        sizes.append((h, w))
        cin = 256 * 2 ** s
    n_cls = cfg["MODEL.NUM_CLASSES"]
    pre_n, post_n = cfg["TEST.RPN_PRE_NMS_TOP_N"], cfg[
        "TEST.RPN_POST_NMS_TOP_N"]
    D = cfg["TEST.DETECTIONS_PER_IM"]
    red = cfg["MRCNN.DIM_REDUCED"]
    if fpn:
        dim = cfg["FPN.DIM"]
        for (h, w), c in zip(sizes, (256, 512, 1024, 2048)):
            total += conv(c, dim, 1, h, w) + conv(dim, dim, 3, h, w)
        levels = sizes + [((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2)]
        A = len(cfg["FPN.RPN_ASPECT_RATIOS"])
    else:
        dim = 1024
        levels = sizes[-1:]
        A = len(cfg["RPN.ASPECT_RATIOS"]) * len(cfg["RPN.SIZES"])
    slots = 0
    for h, w in levels:
        total += conv(dim, dim, 3, h, w) + conv(dim, A, 1, h, w) + \
            conv(dim, 4 * A, 1, h, w)
        slots += min(pre_n, h * w * A)
    R = min(post_n, slots)
    if fpn:
        P = cfg["FAST_RCNN.ROI_XFORM_RESOLUTION"]
        hidden = cfg["FAST_RCNN.MLP_HEAD_DIM"]
        total += R * 2 * (dim * P * P * hidden + hidden * hidden)
        M = cfg["MRCNN.ROI_XFORM_RESOLUTION"]
        mask = 4 * conv(dim, red, 3, M, M) + conv(red, red, 2, M, M)
        m_out = 2 * M
    else:
        hidden = 2048
        P = cfg["FAST_RCNN.ROI_XFORM_RESOLUTION"]
        res5, ph, pw = _stage(R50_BLOCKS[3], 1024, 2048, 512, 2, P, P)
        total += R * res5
        M = cfg["MRCNN.ROI_XFORM_RESOLUTION"]
        m5, mh, mw = _stage(R50_BLOCKS[3], 1024, 2048, 512, 2, M, M)
        mask = m5 + conv(2048, red, 2, mh, mw)
        m_out = 2 * mh
    total += R * 2 * hidden * (n_cls + 4 * n_cls)
    total += D * (mask + conv(red, n_cls, 1, m_out, m_out))
    return total
