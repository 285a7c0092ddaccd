"""Mask R-CNN head and outputs (port of detectron_tpu/models/
mask_rcnn_heads.py for mask_rcnn_fcn_head_v1up4convs: apply_mask_head
:57-80, apply_mask_outputs :97-106)."""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L


def apply_mask_head(p, roi_feat):
    """roi_feat (R, P, P, C) -> (R, 2P, 2P, DIM_REDUCED): 4 dilated 3x3
    convs with ReLU, then the 2x2 stride-2 deconv with ReLU."""
    if cfg.MRCNN.ROI_MASK_HEAD != \
            "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs":
        raise NotImplementedError("not ported yet (ROADMAP Queue A, A7): "
                                  + cfg.MRCNN.ROI_MASK_HEAD)
    x = roi_feat
    d = cfg.MRCNN.DILATION
    for cp in p["convs"]:
        x = L.relu(L.conv2d(cp, x, stride=1, padding=d, dilation=d))
    return L.relu(L.conv_transpose2d(p["deconv"], x, stride=2,
                                     torch_padding=0))


def apply_mask_outputs(p, x):
    """x (R, M, M, D) -> mask logits (R, M, M, n_cls)."""
    if cfg.MRCNN.USE_FC_OUTPUT:
        raise NotImplementedError("not ported yet (ROADMAP Queue A, A7): "
                                  "MRCNN.USE_FC_OUTPUT")
    return L.conv2d(p["mask_fcn_logits"], x, stride=1, padding=0)
