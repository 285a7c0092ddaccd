"""Mask R-CNN heads and outputs (port of detectron_tpu/models/
mask_rcnn_heads.py: apply_mask_head :57-80 for
mask_rcnn_fcn_head_v1up4convs, its GroupNorm twin
mask_rcnn_fcn_head_v1up4convs_gn and the res5 heads
mask_rcnn_fcn_head_v0upshare / v0up, apply_mask_outputs :97-106)."""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import init as init_mod
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.models import resnet


def apply_mask_head(p, roi_feat, shared_res5_params=None):
    """roi_feat (R, P, P, C) -> (R, 2P', 2P', DIM_REDUCED), then ReLU:
    v1up4convs runs 4 dilated 3x3 convs with ReLU (P' = P), each with its
    GroupNorm before the ReLU under v1up4convs_gn; the v0up heads
    run res5 at stride 2 (P' = P / 2), the box head's res5
    (shared_res5_params) under v0upshare, their own under v0up; then the
    2x2 stride-2 deconv."""
    head = cfg.MRCNN.ROI_MASK_HEAD
    if head in init_mod.MASK_HEADS_V0UP:
        res5 = shared_res5_params if head == init_mod.MASK_HEADS_V0UP[0] \
            else p["res5"]
        resnet.check_body_supported()
        x = resnet.apply_stage(res5, roi_feat, 2)
    elif head in (init_mod.MASK_HEAD_V1UP4CONVS,
                  init_mod.MASK_HEAD_V1UP4CONVS_GN):
        x = roi_feat
        d = cfg.MRCNN.DILATION
        for i, cp in enumerate(p["convs"]):
            x = L.conv2d(cp, x, stride=1, padding=d, dilation=d)
            if "gns" in p:
                x = L.group_norm_cfg(p["gns"][i], x)
            x = L.relu(x)
    else:
        raise NotImplementedError("not ported yet (ROADMAP Queue A, A7): "
                                  "mask head {!r} (v1up, the dotted-name "
                                  "registry)".format(head))
    return L.relu(L.conv_transpose2d(p["deconv"], x, stride=2,
                                     torch_padding=0))


def apply_mask_outputs(p, x):
    """x (R, M, M, D) -> mask logits (R, M, M, n_cls)."""
    if cfg.MRCNN.USE_FC_OUTPUT:
        raise NotImplementedError("not ported yet (ROADMAP Queue A, A7): "
                                  "MRCNN.USE_FC_OUTPUT")
    return L.conv2d(p["mask_fcn_logits"], x, stride=1, padding=0)


def shared_res5(params):
    """The box head's res5 params (a C4 model's), or None."""
    return params.get("box_head", {}).get("res5")
