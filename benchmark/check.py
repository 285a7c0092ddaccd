"""The comparison that decides `correct` for inference cells.

For each image of the sample (drawn from the seed among the images the
window served), the plain reference (reference/model.py) runs in float32
with TF32 off on the same weights and image, and these numbers are taken:

- det_gap: for each detection the program returned (valid slots), the
  distance to the nearest candidate of the same class in the reference's
  pool: max(1 - IoU, |score difference| / the larger score). The pool is
  every anchor among each level's top POOL_MARGIN x RPN_PRE_NMS_TOP_N by
  the reference's objectness, decoded, through the box head: it comes
  before the RPN's NMS and cut and before the per-class NMS and the
  top-100 limit, so a detection finds its twin however the boundaries of
  top-k and the ties of NMS fall in the program's precision (in bfloat16
  10-30% of the proposals differ from float32's). Each detection the
  reference makes beyond the program's number counts a distance of 1. The
  image's number is the QUANTILE of the distances;
- score_rank_gap: the detections' scores rank by rank against the
  reference's final detections, |difference| / the larger score, the
  QUANTILE over the ranks: which detections were chosen (the per-class
  NMS, the top-100 limit and, through the proposals, the RPN's NMS);
- nms_iou_max: the largest IoU of two valid detections of one class: the
  configuration's guarantee that no two exceed TEST.NMS;
- score_order: the largest breach of the output's order: a valid slot
  after an invalid one (1), a score above the one before it, or a score
  below TEST.SCORE_THRESH (by how much);
- mask_gap: the reference's mask head on the program's own boxes and
  classes (the reference reads them only to judge them), the largest
  difference of a mask probability.

Each run-level number is the largest over the sample. A number compared
is below or at its limit (workloads/<cell>.json, "limits").
"""

import torch

from benchmark.reference import model as ref_model

QUANTILE = 0.9
# The pool's anchors: each level's top POOL_MARGIN x RPN_PRE_NMS_TOP_N.
POOL_MARGIN = 1.5


def twin_distance(boxes, scores, classes, pool_probs, pool_boxes):
    """For each detection (boxes (n, 4), scores (n,), classes (n,)), the
    distance to the nearest candidate of its class among pool_probs (N,
    C) and pool_boxes (N, C, 4): max(1 - IoU, |score difference| / the
    larger score). (n,)."""
    out = []
    for i in range(boxes.shape[0]):
        c = int(classes[i])
        ps = pool_probs[:, c]
        iou = ref_model.iou_matrix(boxes[i:i + 1], pool_boxes[:, c])[0]
        rel = (scores[i] - ps).abs() / torch.maximum(scores[i], ps).clamp(
            min=1e-12)
        out.append(torch.maximum(1.0 - iou, rel).amin())
    return torch.stack(out) if out else boxes.new_zeros(0)


def selection_numbers(boxes, scores, classes, valid, score_thresh):
    """nms_iou_max and score_order of one image's outputs."""
    n = int(valid.sum())
    order = 0.0 if bool(valid[:n].all()) else 1.0
    s = scores[:n]
    if n > 1:
        order = max(order, float((s[1:] - s[:-1]).clamp(min=0).max()))
    if n:
        order = max(order, float((score_thresh - s).clamp(min=0).max()))
    iou_max = 0.0
    b, c = boxes[valid], classes[valid]
    for k in torch.unique(c):
        bk = b[c == k]
        if bk.shape[0] > 1:
            iou = ref_model.iou_matrix(bk, bk)
            iou.fill_diagonal_(0.0)
            iou_max = max(iou_max, float(iou.max()))
    return {"nms_iou_max": iou_max, "score_order": order}


def image_numbers(ref, image, im_info, prog):
    """The numbers of one image. prog: the program's outputs of the image
    (boxes (D, 4), scores (D,), classes (D,), valid (D,), mask_probs (D, M,
    M)) on the reference's device. det_gap_p50, det_gap_max and the two
    detection counts are printed beside them, not compared."""
    cfg = ref.cfg
    feats, scales = ref.features(image)
    rpn = ref.rpn(feats)
    rois, valid = ref.proposals(feats, im_info, rpn)
    probs, boxes = ref.candidates(feats, scales, rois, valid, im_info)
    _, r_scores, _, r_valid = ref.detections(probs, boxes)
    n_ref = int(r_valid.sum())
    v = prog["valid"]
    n = int(v.sum())
    pb, ps = prog["boxes"].float(), prog["scores"].float()
    out = {"n_program": n, "n_reference": n_ref, "mask_gap": 0.0,
           **selection_numbers(pb, ps, prog["classes"], v,
                               cfg["TEST.SCORE_THRESH"])}
    m = min(n, n_ref)
    ranks = (ps[:m] - r_scores[:m]).abs() / torch.maximum(
        ps[:m], r_scores[:m]) if m else torch.zeros(1)
    out["score_rank_gap"] = float(torch.quantile(ranks, QUANTILE))
    gap = torch.ones(max(n, n_ref), device=image.device)
    if n:
        pool_probs, pool_boxes = ref.pool(feats, scales, im_info,
                                          POOL_MARGIN, rpn)
        gap[:n] = twin_distance(pb[v], ps[v], prog["classes"][v],
                                pool_probs, pool_boxes)
        masks = ref.mask_probs(feats, scales, pb, prog["classes"])
        out["mask_gap"] = float((masks[v] - prog["mask_probs"][v].float())
                                .abs().max())
    if len(gap) == 0:
        gap = torch.zeros(1)
    out["det_gap"] = float(torch.quantile(gap, QUANTILE))
    out["det_gap_p50"] = float(gap.median())
    out["det_gap_max"] = float(gap.max())
    return out


def model_cfg(config):
    """The reference's view of a configuration file: its cfg keys and
    constants."""
    return {**config["cfg"], **config["constants"]}


@torch.no_grad()
def check(config, params, samples, device):
    """samples: [(image (H, W, 3), im_info (3,), program outputs)]. Runs
    the float32 reference and returns the run-level numbers {name: value}
    (those that image_numbers prints beside them are not compared)."""
    with ref_model.no_tf32():
        ref = ref_model.Model(model_cfg(config), ref_model_tree(params))
        worst = {}
        for image, im_info, prog in samples:
            prog = {k: t.to(device) for k, t in prog.items()}
            nums = image_numbers(ref, image.to(device), im_info, prog)
            for k, x in nums.items():
                worst[k] = max(worst.get(k, 0.0), x)
    return worst


def ref_model_tree(params):
    from benchmark.weights import tree_map

    return tree_map(lambda t: t.float(), params)


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}})."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows


@torch.no_grad()
def reference_outputs(config, params, image, im_info, prec):
    """detect_graph's outputs of one image computed by the reference in
    `prec`: the control, put in the program's place."""
    with ref_model.no_tf32():
        ref = ref_model.Model(model_cfg(config), ref_model_tree(params),
                              prec)
        feats, scales = ref.features(image)
        rois, valid = ref.proposals(feats, im_info)
        probs, boxes = ref.candidates(feats, scales, rois, valid, im_info)
        b, s, c, v = ref.detections(probs, boxes)
        return {"boxes": b, "scores": s, "classes": c, "valid": v,
                "mask_probs": ref.mask_probs(feats, scales, b, c)}
