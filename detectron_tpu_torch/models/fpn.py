"""Feature Pyramid Network (port of detectron_tpu/models/fpn.py:66-120):
1x1 laterals, nearest 2x top-down adds cropped to the lateral's size, 3x3
posthoc convs, and P6 by stride-2 subsampling of P5. With FPN.USE_GN each
lateral and posthoc conv is followed by its GroupNorm (`<conv>_gn`)."""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L


def lowest_backbone_lvl():
    return 2


def _conv_gn(p, name, x, padding):
    y = L.conv2d(p[name], x, stride=1, padding=padding)
    if cfg.FPN.USE_GN:
        y = L.group_norm_cfg(p[name + "_gn"], y)
    return y


def apply_fpn(p, body_outs):
    """body_outs: [res2, ..., res5] (NHWC). Returns (pyramid [P2, ..., P6],
    scales [1/4, ..., 1/64])."""
    if cfg.FPN.EXTRA_CONV_LEVELS:
        raise NotImplementedError(
            "not ported yet (ROADMAP Queue A, A7.4): FPN extra conv levels")
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
    if cfg.FPN.MULTILEVEL_RPN and cfg.FPN.RPN_MAX_LEVEL == 6:
        pyramid.append(pyramid[-1][:, ::2, ::2, :])
        scales.append(scales[-1] / 2.0)
    elif cfg.FPN.MULTILEVEL_RPN and cfg.FPN.RPN_MAX_LEVEL != 5:
        raise NotImplementedError("FPN.RPN_MAX_LEVEL must be 5 or 6")
    return pyramid, scales
