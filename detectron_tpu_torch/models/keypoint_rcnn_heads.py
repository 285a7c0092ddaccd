"""Keypoint R-CNN head and outputs (port of detectron_tpu/models/
keypoint_rcnn_heads.py for roi_pose_head_v1convX: apply_pose_head :32-37,
apply_keypoint_outputs :61-93): a tower of 3x3 convs, a learned stride-2
deconv output, and a frozen bilinear upsampling. A head of the registry's
convention fallback (models/registry.py) runs its own apply."""

import torch
import torch.nn.functional as F

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import init
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.models import registry
from detectron_tpu_torch.utils import tracing


def apply_pose_head(p, roi_feat):
    """roi_feat (R, P, P, C) -> (R, P, P, CONV_HEAD_DIM): each conv with
    a ReLU."""
    head = init.keypoint_head_name()
    if head != registry.POSE_HEAD:
        return registry.get_func(head).apply(p, roi_feat)
    x = roi_feat
    pad = cfg.KRCNN.CONV_HEAD_KERNEL // 2
    for cp in p["convs"]:
        x = L.conv2d(cp, x, stride=1, padding=pad, relu=True)
    return x


def output_side(resolution):
    """The side of the heatmaps that apply_keypoint_outputs makes from
    RoI features of side `resolution`: each stride-2 deconv (padding
    DECONV_KERNEL / 2 - 1) doubles it, and the upsampling multiplies it by
    UP_SCALE."""
    side = resolution * (2 if cfg.KRCNN.USE_DECONV else 1) * \
        (2 if cfg.KRCNN.USE_DECONV_OUTPUT else 1)
    return side * max(cfg.KRCNN.UP_SCALE, 1)


def apply_keypoint_outputs(p, x):
    """x (R, P, P, D) -> heatmap logits (R, S, S, NUM_KEYPOINTS), S =
    output_side(P). The upsampling by f = UP_SCALE is a depthwise
    transposed conv with the frozen bilinear kernel (k = 2f - f % 2,
    stride f, padding ceil((f - 1) / 2)); the JAX package writes it as the
    equivalent input-dilated conv (the kernel is symmetric)."""
    pad = int(cfg.KRCNN.DECONV_KERNEL / 2 - 1)
    if cfg.KRCNN.USE_DECONV:
        x = L.conv_transpose2d(p["kps_deconv"], x, stride=2,
                               torch_padding=pad, relu=True)
    if cfg.KRCNN.USE_DECONV_OUTPUT:
        x = L.conv_transpose2d(p["kps_score"], x, stride=2,
                               torch_padding=pad)
    else:
        x = L.conv2d(p["kps_score"], x, stride=1, padding=0)
    f = cfg.KRCNN.UP_SCALE
    if f > 1:
        nk = x.shape[-1]
        # (k, k, 1, K) -> F.conv_transpose2d's (K, 1, k, k) with groups K.
        tracing.sync("keypoint_rcnn_heads.upsample_kernel")
        kern = torch.from_numpy(
            init.bilinear_upsample_kernel(f, nk).transpose(3, 2, 0, 1)).to(
                device=x.device, dtype=x.dtype)
        x = F.conv_transpose2d(x.permute(0, 3, 1, 2), kern, None, f,
                               (f - 1 + 1) // 2, groups=nk).permute(
                                   0, 2, 3, 1)
    return x
