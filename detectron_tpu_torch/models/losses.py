"""Loss functions, Detectron semantics (port of detectron_tpu/models/
losses.py:20-121: smooth_l1, sigmoid_ce, rpn_losses, fast_rcnn_losses,
mask_rcnn_losses).

The losses take fixed-shape tensors with validity masks: a masked element
adds 0 to the sum and 0 to the normalizer, which reproduces the reference's
dynamically sized blobs. Everything is computed in float32.
"""

import torch

from detectron_tpu_torch.core.config import cfg


def smooth_l1(x, beta):
    """0.5 x^2 / beta where |x| < beta, else |x| - 0.5 beta."""
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def smooth_l1_loss(pred, targets, inside_weights, outside_weights,
                   beta=1.0):
    """sum(outside * smooth_l1(inside * (pred - targets))), unnormalized
    (lib/utils/net.py :: smooth_l1_loss)."""
    diff = inside_weights * (pred - targets)
    return torch.sum(outside_weights * smooth_l1(diff, beta))


def sigmoid_ce(logits, labels):
    """Elementwise sigmoid cross-entropy with logits, in the stable form.
    At a logit of exactly 0 (zero-padded canvas regions give many) the
    gradient is JAX's: max(x, 0) splits it 0.5 / 0.5, and |x| takes slope
    1 (torch.abs would take 0)."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, torch.zeros_like(logits)) - \
        logits * labels + torch.log1p(torch.exp(-abs_x))


def rpn_losses(cls_logits, bbox_pred, labels, bbox_targets, bbox_valid):
    """RPN losses over the sampled anchors of the whole batch.
    cls_logits, labels (N,), labels in {1, 0, -1 (ignored)}; bbox_pred,
    bbox_targets (N, 4); bbox_valid (N,) the fg anchors. Both losses are
    normalized by RPN_BATCH_SIZE_PER_IM * IMS_PER_BATCH; the box loss is
    smooth L1 with beta 1/9."""
    normalizer = cfg.TRAIN.RPN_BATCH_SIZE_PER_IM * cfg.TRAIN.IMS_PER_BATCH
    w = (labels >= 0).to(torch.float32)
    cls_loss = torch.sum(w * sigmoid_ce(
        cls_logits.to(torch.float32),
        torch.clamp(labels, min=0).to(torch.float32))) / normalizer
    fg = bbox_valid.to(torch.float32)[:, None]
    bbox_loss = smooth_l1_loss(bbox_pred.to(torch.float32), bbox_targets, fg,
                               torch.full_like(fg, 1.0 / normalizer) * fg,
                               beta=1.0 / 9.0)
    return cls_loss, bbox_loss


def fast_rcnn_losses(cls_logits, bbox_pred, labels, label_valid,
                     bbox_targets, bbox_fg):
    """Box head losses over the sampled RoIs of the whole batch.
    cls_logits (N, C); labels (N,) in [0, C); label_valid (N,); bbox_pred
    (N, 4C') per class (C' = 2 for class-agnostic regression: background
    and one foreground slot); bbox_targets (N, 4); bbox_fg (N,).
    Returns (softmax CE mean over valid RoIs, smooth L1 of the label
    class's deltas summed over fg / valid count, accuracy_cls)."""
    valid = label_valid.to(torch.float32)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    labels = labels.long()
    logp = torch.log_softmax(cls_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    cls_loss = torch.sum(nll * valid) / n_valid

    num_reg_cls = bbox_pred.shape[-1] // 4
    reg_labels = torch.clamp(labels, max=1) if num_reg_cls == 2 else labels
    pred4 = torch.gather(
        bbox_pred.to(torch.float32).reshape(-1, num_reg_cls, 4), 1,
        reg_labels[:, None, None].expand(-1, 1, 4))[:, 0]
    fg = bbox_fg.to(torch.float32)[:, None]
    bbox_loss = smooth_l1_loss(pred4, bbox_targets, fg, fg) / n_valid

    acc = torch.sum((cls_logits.argmax(dim=-1) == labels) * valid) / n_valid
    return cls_loss, bbox_loss, acc


def mask_rcnn_losses(mask_logits, mask_targets, mask_labels, mask_valid):
    """Mask head loss: sigmoid CE over every pixel of the valid fg RoIs on
    the label's channel (the only channel when class-agnostic), normalized
    by n_valid * M^2 and scaled by MRCNN.WEIGHT_LOSS_MASK.
    mask_logits (N, M, M, C'); mask_targets (N, M, M); mask_labels (N,);
    mask_valid (N,)."""
    N, M = mask_logits.shape[:2]
    if mask_logits.shape[-1] > 1:
        sel = torch.gather(mask_logits, 3, mask_labels.long().reshape(
            N, 1, 1, 1).expand(-1, M, M, 1))[..., 0]
    else:
        sel = mask_logits[..., 0]
    ce = sigmoid_ce(sel.to(torch.float32), mask_targets.to(torch.float32))
    valid = mask_valid.to(torch.float32)[:, None, None]
    denom = torch.clamp(valid.sum() * M * M, min=1.0)
    return cfg.MRCNN.WEIGHT_LOSS_MASK * torch.sum(ce * valid) / denom
