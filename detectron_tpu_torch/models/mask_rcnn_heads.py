"""Mask R-CNN heads and outputs (port of detectron_tpu/models/
mask_rcnn_heads.py: apply_mask_head :57-80 for the shipped heads,
mask_rcnn_fcn_head_v1up4convs, its GroupNorm twin
mask_rcnn_fcn_head_v1up4convs_gn, mask_rcnn_fcn_head_v1up and the res5
heads mask_rcnn_fcn_head_v0upshare / v0up; apply_mask_outputs :97-106 with
its 1x1 conv or MRCNN.USE_FC_OUTPUT's FC). A head of the registry's
convention fallback (models/registry.py) runs its own apply."""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import init as init_mod
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.models import registry
from detectron_tpu_torch.models import resnet


def apply_mask_head(p, roi_feat, shared_res5_params=None):
    """roi_feat (R, P, P, C) -> (R, 2P', 2P', DIM_REDUCED), then ReLU:
    the v1up heads run their 3x3 convs (4, or 2 for v1up; dilation
    MRCNN.DILATION) with ReLU (P' = P), each with its GroupNorm before the
    ReLU under v1up4convs_gn; the v0up heads run res5 (P' = P / 2, or P
    with RES5_DILATION), the box head's res5 (shared_res5_params) under
    v0upshare, their own under v0up; then the 2x2 stride-2 deconv."""
    head = init_mod.mask_head_name()
    if head not in registry.MASK_HEADS:
        return registry.get_func(head).apply(p, roi_feat)
    if "v0up" in head:
        res5 = shared_res5_params if head.endswith("share") else p["res5"]
        x = resnet.apply_stage(res5, roi_feat,
                               *resnet.res5_stride_dilation())
    else:
        x = roi_feat
        d = cfg.MRCNN.DILATION
        for i, cp in enumerate(p["convs"]):
            x = L.conv2d(cp, x, stride=1, padding=d, dilation=d,
                         relu="gns" not in p)
            if "gns" in p:
                x = L.relu(L.group_norm_cfg(p["gns"][i], x))
    return L.conv_transpose2d(p["deconv"], x, stride=2, torch_padding=0,
                              relu=True)


def apply_mask_outputs(p, x):
    """x (R, M, M, D) -> mask logits (R, M, M, n_cls). With
    MRCNN.USE_FC_OUTPUT an FC over Caffe2's (D, M, M) flatten gives
    n_cls x RESOLUTION^2 logits, laid out (n_cls, res, res) as Detectron
    reshapes them, returned NHWC."""
    if cfg.MRCNN.USE_FC_OUTPUT:
        R = x.shape[0]
        res = cfg.MRCNN.RESOLUTION
        out = L.fc(p["mask_fcn_logits"], x.permute(0, 3, 1, 2).reshape(R, -1))
        return out.reshape(R, -1, res, res).permute(0, 2, 3, 1)
    return L.conv2d(p["mask_fcn_logits"], x, stride=1, padding=0)


def shared_res5(params):
    """The box head's res5 params (a C4 model's), or None."""
    return params.get("box_head", {}).get("res5")
