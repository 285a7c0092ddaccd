"""Feature Pyramid Network (port of detectron_tpu/models/fpn.py:66-120):
1x1 laterals, nearest 2x top-down adds cropped to the lateral's size, 3x3
posthoc convs, and the levels above P5: with FPN.EXTRA_CONV_LEVELS a
3x3/s2 conv on res5 (fpn_6) and a ReLU then another such conv for each
further level up to RPN_MAX_LEVEL, else P6 by stride-2 subsampling of P5
when RPN_MAX_LEVEL is 6. With FPN.USE_GN each lateral and posthoc conv is
followed by its GroupNorm (`<conv>_gn`). A conv4 body gives P2-P4, and P5
from subsampling P4, as in the JAX package."""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L

HIGHEST_BACKBONE_LVL = 5


def lowest_backbone_lvl():
    return 2


def _conv_gn(p, name, x, padding):
    y = L.conv2d(p[name], x, stride=1, padding=padding)
    if cfg.FPN.USE_GN:
        y = L.group_norm_cfg(p[name + "_gn"], y)
    return y


def apply_fpn(p, body_outs):
    """body_outs: [res2, ..., res5] (NHWC). Returns (pyramid [P2, ...],
    scales [1/4, ...])."""
    n = len(body_outs)
    inners = {}
    td = None
    for i in reversed(range(n)):
        lvl = i + 2
        lat = _conv_gn(p, "fpn_inner_res{}".format(lvl), body_outs[i], 0)
        if td is not None:
            H, W = lat.shape[1], lat.shape[2]
            up = td.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            lat = lat + up[:, :H, :W, :]
        td = lat
        inners[lvl] = lat
    pyramid, scales = [], []
    for lvl in sorted(inners):
        pyramid.append(_conv_gn(p, "fpn_res{}".format(lvl), inners[lvl], 1))
        scales.append(1.0 / (2 ** lvl))
    max_lvl = cfg.FPN.RPN_MAX_LEVEL if cfg.FPN.MULTILEVEL_RPN else \
        HIGHEST_BACKBONE_LVL
    if cfg.FPN.EXTRA_CONV_LEVELS and max_lvl > HIGHEST_BACKBONE_LVL:
        h = body_outs[-1]
        for lvl in range(HIGHEST_BACKBONE_LVL + 1, max_lvl + 1):
            if lvl > HIGHEST_BACKBONE_LVL + 1:
                h = L.relu(h)
            h = L.conv2d(p["fpn_{}".format(lvl)], h, stride=2, padding=1)
            pyramid.append(h)
            scales.append(1.0 / (2 ** lvl))
    elif max_lvl == HIGHEST_BACKBONE_LVL + 1:
        pyramid.append(pyramid[-1][:, ::2, ::2, :])
        scales.append(scales[-1] / 2.0)
    return pyramid, scales
