"""Fast R-CNN box head and outputs (port of detectron_tpu/models/
fast_rcnn_heads.py: apply_roi_2mlp_head :52-60, apply_fast_rcnn_outputs
:110-112)."""

from detectron_tpu_torch.models import layers as L


def apply_roi_2mlp_head(p, roi_feat):
    """roi_feat (R, P, P, C) in (p, q, c) order -> (R, MLP_HEAD_DIM). The
    bridge already permuted fc6's Caffe2 (C, P, P) rows to that order."""
    x = L.relu(L.fc(p["fc6"], roi_feat.reshape(roi_feat.shape[0], -1)))
    return L.relu(L.fc(p["fc7"], x))


def apply_fast_rcnn_outputs(p, x):
    """x (R, D) -> (cls_logits (R, C), bbox_pred (R, 4C'))."""
    return L.fc(p["cls_score"], x), L.fc(p["bbox_pred"], x)
