"""Fast R-CNN box heads and outputs (port of detectron_tpu/models/
fast_rcnn_heads.py: apply_roi_2mlp_head :52-60, apply_roi_Xconv1fc_head
:83-96, which also serves roi_Xconv1fc_gn_head, apply_fast_rcnn_outputs
:110-112)."""

from detectron_tpu_torch.models import layers as L


def apply_roi_2mlp_head(p, roi_feat):
    """roi_feat (R, P, P, C) in (p, q, c) order -> (R, MLP_HEAD_DIM). The
    bridge already permuted fc6's Caffe2 (C, P, P) rows to that order."""
    x = L.relu(L.fc(p["fc6"], roi_feat.reshape(roi_feat.shape[0], -1)))
    return L.relu(L.fc(p["fc7"], x))


def apply_roi_Xconv1fc_head(p, roi_feat):
    """roi_feat (R, P, P, C) -> NUM_STACKED_CONVS 3x3 convs, each with its
    GroupNorm where the params hold "gns" (roi_Xconv1fc_gn_head), and ReLU
    -> fc6 over the (p, q, c) flatten (the bridge permuted fc6's Caffe2
    (C, P, P) rows to that order) and ReLU, (R, MLP_HEAD_DIM)."""
    x = roi_feat
    for i, cp in enumerate(p["convs"]):
        x = L.conv2d(cp, x, stride=1, padding=1)
        if "gns" in p:
            x = L.group_norm_cfg(p["gns"][i], x)
        x = L.relu(x)
    return L.relu(L.fc(p["fc6"], x.reshape(x.shape[0], -1)))


def apply_fast_rcnn_outputs(p, x):
    """x (R, D) -> (cls_logits (R, C), bbox_pred (R, 4C'))."""
    return L.fc(p["cls_score"], x), L.fc(p["bbox_pred"], x)
