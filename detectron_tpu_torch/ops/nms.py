"""Batched greedy NMS over score-descending lanes (port of detectron_tpu/
ops/nms.py :: nms_batched_sorted and nms_batched_sorted_mask, nms.py:
160-214, on its Pallas route). Every form runs kernel K1
(ops/cuda/nms_kernel.py) on CUDA tensors and its plain version on CPU
tensors; nms_stacked_mask runs several groups of lanes (the RPN's levels)
in one K1 call.
"""

import torch
import torch.nn.functional as F

from detectron_tpu_torch.ops.cuda.nms_kernel import nms_keep_mask
from detectron_tpu_torch.ops.topk import top_k


def nms_batched_sorted_mask(boxes, scores, iou_threshold):
    """boxes (L, N, 4), scores (L, N) score-descending per lane, -inf
    invalid. Returns keep (L, N) bool: the survivors in place."""
    return nms_keep_mask(boxes.to(torch.float32).contiguous(),
                         torch.isfinite(scores).contiguous(), iou_threshold)


def nms_stacked_mask(group_boxes, group_scores, iou_threshold):
    """nms_batched_sorted_mask of several groups of lanes in one K1 call:
    group g is (L_g, N_g, 4) boxes and (L_g, N_g) scores. The lanes are
    stacked, padded to the largest N_g with invalid slots (a lane stops at
    its last valid box, so padding costs nothing), and each group's keep
    (L_g, N_g) is sliced back out: the same masks, lane by lane."""
    n = max(s.shape[-1] for s in group_scores)
    boxes = torch.cat([F.pad(b.to(torch.float32), (0, 0, 0, n - b.shape[1]))
                       for b in group_boxes])
    valid = torch.cat([F.pad(torch.isfinite(s), (0, n - s.shape[1]))
                       for s in group_scores])
    keep = nms_keep_mask(boxes, valid, iou_threshold)
    out, lo = [], 0
    for s in group_scores:
        out.append(keep[lo:lo + s.shape[0], :s.shape[1]])
        lo += s.shape[0]
    return out


def compact_keep(keep, max_output_size):
    """The compacted form of a keep mask (detectron_tpu nms_kernel.nms_many,
    :138-156): the survivors' lane indices first, in score order. Returns
    (idx (L, K) int64, valid (L, K) bool), K = min(max_output_size, N);
    slots past the survivors hold index 0."""
    N = keep.shape[-1]
    pos = torch.arange(N, device=keep.device)
    key = torch.where(keep, N - pos, 0)
    kv, sel = top_k(key, min(max_output_size, N))
    valid = kv > 0
    return torch.where(valid, sel, 0), valid


def nms_batched_sorted(boxes, scores, iou_threshold, max_output_size):
    """Compacted form: compact_keep of nms_batched_sorted_mask."""
    return compact_keep(nms_batched_sorted_mask(boxes, scores, iou_threshold),
                        max_output_size)
