"""K1: batched greedy NMS keep mask (kernel csrc/nms_keep_mask.cu).

Replaces detectron_tpu/ops/pallas/nms_kernel.py::nms_keep_mask. Bounded by
the latency of the serial pivot recurrence, not by memory: the kernel
first computes every IoU bit of a lane in parallel into a 64-bit mask
(scratch the wrapper allocates, (L, N, ceil(N / 64)) int64), then one warp
per lane scans it with the lane's removed mask in registers, one word per
thread, so a lane holds at most MAX_BOXES = 32 x 64 boxes.
"""

import ctypes

import torch

from detectron_tpu_torch.ops.cuda import build

MAX_BOXES = 2048


def nms_keep_mask_plain(boxes, valid, thr):
    """Plain PyTorch version: boxes (L, N, 4) score-descending per lane,
    valid (L, N) bool. Returns keep (L, N) bool. The IoU is evaluated op by
    op in f32 in the kernel's order, so keep masks agree exactly."""
    boxes = boxes.to(torch.float32)
    L, N = valid.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    thr32 = torch.tensor(thr, dtype=torch.float32, device=boxes.device)
    keep = valid.clone()
    pos = torch.arange(N, device=boxes.device)
    n_iter = int(torch.where(valid, pos + 1, 0).max())
    for i in range(n_iter):
        sl = slice(i, i + 1)
        iw = torch.clamp(torch.minimum(x2, x2[:, sl])
                         - torch.maximum(x1, x1[:, sl]) + 1.0, min=0.0)
        ih = torch.clamp(torch.minimum(y2, y2[:, sl])
                         - torch.maximum(y1, y1[:, sl]) + 1.0, min=0.0)
        inter = iw * ih
        iou = inter / (area + area[:, sl] - inter)
        keep &= ~((iou > thr32) & (pos > i) & keep[:, sl])
    return keep


def nms_keep_mask(boxes, valid, thr):
    """Greedy NMS keep mask over L lanes of N score-descending boxes.
    boxes: (L, N, 4) float32; valid: (L, N) bool; thr: IoU threshold
    (iou > thr suppresses). Returns keep (L, N) bool."""
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, thr)
    if not (boxes.is_cuda and valid.is_cuda
            and boxes.device == valid.device):
        raise ValueError("nms_keep_mask: boxes and valid must both be on "
                         "one CUDA device (or both on the CPU)")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("nms_keep_mask takes float32 boxes and bool valid, "
                        "got {} and {}".format(boxes.dtype, valid.dtype))
    L, N = valid.shape
    if boxes.shape != (L, N, 4):
        raise ValueError("nms_keep_mask: boxes {} vs valid {}".format(
            tuple(boxes.shape), tuple(valid.shape)))
    if N > MAX_BOXES:
        raise ValueError("nms_keep_mask: N={} > {} boxes per lane".format(
            N, MAX_BOXES))
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep_mask needs contiguous inputs")
    fn = build.load("nms_keep_mask.cu", "nms_keep_mask_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    keep = torch.empty((L, N), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((L, N, -(-N // 64)), dtype=torch.int64,
                       device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
             mask.data_ptr(), L, N, float(thr), stream)
    nms_keep_mask.launches += int(L > 0 and N > 0)
    build.check(err, "nms_keep_mask")
    return keep


nms_keep_mask.launches = 0
