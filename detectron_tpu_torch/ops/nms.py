"""Batched greedy NMS over score-descending lanes (port of detectron_tpu/
ops/nms.py :: nms_batched_sorted and nms_batched_sorted_mask, nms.py:
160-214, on its Pallas route). Both forms run kernel K1
(ops/cuda/nms_kernel.py) on CUDA tensors and its plain version on CPU
tensors.
"""

import torch

from detectron_tpu_torch.ops.cuda.nms_kernel import nms_keep_mask
from detectron_tpu_torch.ops.topk import top_k


def nms_batched_sorted_mask(boxes, scores, iou_threshold):
    """boxes (L, N, 4), scores (L, N) score-descending per lane, -inf
    invalid. Returns keep (L, N) bool: the survivors in place."""
    return nms_keep_mask(boxes.to(torch.float32).contiguous(),
                         torch.isfinite(scores).contiguous(), iou_threshold)


def nms_batched_sorted(boxes, scores, iou_threshold, max_output_size):
    """Compacted form (detectron_tpu nms_kernel.nms_many, :138-156): the
    survivors' lane indices first, in score order. Returns (idx (L, K)
    int64, valid (L, K) bool), K = min(max_output_size, N); slots past the
    survivors hold index 0."""
    N = scores.shape[-1]
    keep = nms_batched_sorted_mask(boxes, scores, iou_threshold)
    pos = torch.arange(N, device=scores.device)
    key = torch.where(keep, N - pos, 0)
    kv, sel = top_k(key, min(max_output_size, N))
    valid = kv > 0
    return torch.where(valid, sel, 0), valid
