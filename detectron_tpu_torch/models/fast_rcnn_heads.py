"""Fast R-CNN box heads and outputs (port of detectron_tpu/models/
fast_rcnn_heads.py: apply_roi_2mlp_head :52-60, apply_roi_Xconv1fc_head
:83-96, which also serves roi_Xconv1fc_gn_head, apply_fast_rcnn_outputs
:110-112)."""

from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.parallel import comm


def apply_roi_2mlp_head(p, roi_feat, model_group=None):
    """roi_feat (R, P, P, C) in (p, q, c) order -> (R, MLP_HEAD_DIM). The
    bridge already permuted fc6's Caffe2 (C, P, P) rows to that order.

    On a model group (parallel/mesh.py) p holds this rank's fc6 columns
    and fc7 rows, the layout XLA builds from the JAX package's
    tp_param_shardings: fc6 column shard and ReLU, fc7's row-shard
    product, the sum over the model group, then fc7's bias and ReLU."""
    x = roi_feat.reshape(roi_feat.shape[0], -1)
    if model_group is None:
        return L.relu(L.fc(p["fc7"], L.relu(L.fc(p["fc6"], x))))
    h = L.relu(L.fc(p["fc6"], comm.copy_to_model(x, model_group)))
    y = comm.reduce_from_model(h @ p["fc7"]["w"].to(h.dtype), model_group)
    return L.relu(y + p["fc7"]["b"].to(y.dtype))


def apply_roi_Xconv1fc_head(p, roi_feat, model_group=None):
    """roi_feat (R, P, P, C) -> NUM_STACKED_CONVS 3x3 convs, each with its
    GroupNorm where the params hold "gns" (roi_Xconv1fc_gn_head), and ReLU
    -> fc6 over the (p, q, c) flatten (the bridge permuted fc6's Caffe2
    (C, P, P) rows to that order) and ReLU, (R, MLP_HEAD_DIM). On a model
    group fc6 is this rank's column shard, and the ranks' columns are
    gathered after the ReLU."""
    x = roi_feat
    for i, cp in enumerate(p["convs"]):
        x = L.conv2d(cp, x, stride=1, padding=1, relu="gns" not in p)
        if "gns" in p:
            x = L.relu(L.group_norm_cfg(p["gns"][i], x))
    x = comm.copy_to_model(x.reshape(x.shape[0], -1), model_group)
    return comm.gather_from_model(L.relu(L.fc(p["fc6"], x)), model_group)


def apply_fast_rcnn_outputs(p, x):
    """x (R, D) -> (cls_logits (R, C), bbox_pred (R, 4C'))."""
    return L.fc(p["cls_score"], x), L.fc(p["bbox_pred"], x)
