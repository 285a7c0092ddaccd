"""K2 / K3: windowed RoIAlign pooling (kernel csrc/roi_window_pool.cu).

roi_window_pool replaces detectron_tpu/ops/pallas/roi_align_kernel.py ::
roi_window_pool (the ladder's base sweep) and roi_window_pool_seg replaces
::roi_window_pool_seg (the ladder's fix-up sweeps). One CUDA kernel serves
both: it pools an active row range [lo, hi), the whole array for K2. For
each RoI row n:

    out[n, p, q, c] = sum_w vx[n, q, w] * sum_h vy[n, p, h]
                      * canvas[b, y0 + h, x0 + w, c],  (b, y0, x0) = starts[n]

with both sums in f32 and the result in the canvas dtype. Bound by the
window reads (hundreds of KB per RoI against a few MFLOP).
"""

import ctypes

import torch

from detectron_tpu_torch.ops.cuda import build

MAX_POOLED = 16
MAX_WINDOW = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def roi_window_pool_plain(canvas, starts, vy, vx, rows=None):
    """Plain PyTorch version. canvas (B, Hc, Wc, C); starts (N, 3) int32
    [img, y0, x0]; vy (N, P, WY), vx (N, P, WX) in the canvas dtype.
    Returns (N, P, P, C) with rows [lo, hi) = `rows` (default all) pooled
    and the others left unset."""
    N, P, WY = vy.shape
    WX = vx.shape[2]
    C = canvas.shape[-1]
    lo, hi = (0, N) if rows is None else rows
    out = torch.empty((N, P, P, C), dtype=canvas.dtype, device=canvas.device)
    s = starts[lo:hi].long()
    dev = canvas.device
    ys = s[:, 1:2] + torch.arange(WY, device=dev)
    xs = s[:, 2:3] + torch.arange(WX, device=dev)
    win = canvas[s[:, 0, None, None], ys[:, :, None], xs[:, None, :]]
    t1 = torch.einsum("nph,nhwc->npwc", vy[lo:hi].float(), win.float())
    out[lo:hi] = torch.einsum("nqw,npwc->npqc", vx[lo:hi].float(),
                              t1).to(canvas.dtype)
    return out


def _launch(canvas, starts, vy, vx, rows, name):
    if not (canvas.is_cuda and starts.device == canvas.device
            and vy.device == canvas.device and vx.device == canvas.device):
        raise ValueError(name + ": all inputs must be on one CUDA device "
                         "(or all on the CPU)")
    if canvas.dtype not in _DTYPE_CODES or vy.dtype != canvas.dtype or \
            vx.dtype != canvas.dtype or starts.dtype != torch.int32:
        raise TypeError(name + ": canvas/vy/vx must share float32 or "
                        "bfloat16 and starts must be int32; got {} {} {} "
                        "{}".format(canvas.dtype, vy.dtype, vx.dtype,
                                    starts.dtype))
    B, Hc, Wc, C = canvas.shape
    N, P, WY = vy.shape
    WX = vx.shape[2]
    if starts.shape != (N, 3) or vx.shape[:2] != (N, P):
        raise ValueError(name + ": starts {} / vy {} / vx {} disagree".format(
            tuple(starts.shape), tuple(vy.shape), tuple(vx.shape)))
    if P > MAX_POOLED or WY > MAX_WINDOW or WX > MAX_WINDOW:
        raise ValueError(name + ": pooled <= {} and windows <= {} only, got "
                         "P={} window=({}, {})".format(
                             MAX_POOLED, MAX_WINDOW, P, WY, WX))
    lo, hi = rows
    if not 0 <= lo <= hi <= N:
        raise ValueError(name + ": rows ({}, {}) outside [0, {}]".format(
            lo, hi, N))
    if not all(t.is_contiguous() for t in (canvas, starts, vy, vx)):
        raise ValueError(name + " needs contiguous inputs")
    fn = build.load("roi_window_pool.cu", "roi_window_pool_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                    + [ctypes.c_void_p])
    out = torch.empty((N, P, P, C), dtype=canvas.dtype, device=canvas.device)
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    err = fn(canvas.data_ptr(), starts.data_ptr(), vy.data_ptr(),
             vx.data_ptr(), out.data_ptr(), B, Hc, Wc, C, lo, hi, WY, WX, P,
             _DTYPE_CODES[canvas.dtype], stream)
    build.check(err, name)
    return out


def roi_window_pool(canvas, starts, vy, vx):
    """K2: pool every row. Shapes as roi_window_pool_plain; returns
    (N, P, P, C) in the canvas dtype."""
    if canvas.device.type == "cpu":
        return roi_window_pool_plain(canvas, starts, vy, vx)
    out = _launch(canvas, starts, vy, vx, (0, vy.shape[0]),
                  "roi_window_pool")
    roi_window_pool.launches += int(vy.shape[0] > 0)
    return out


def roi_window_pool_seg(canvas, starts, vy, vx, rows):
    """K3: pool only rows [lo, hi) = `rows` of a capacity of N rows; the
    other rows of the (N, P, P, C) result are undefined."""
    if canvas.device.type == "cpu":
        return roi_window_pool_plain(canvas, starts, vy, vx, rows)
    out = _launch(canvas, starts, vy, vx, tuple(rows), "roi_window_pool_seg")
    roi_window_pool_seg.launches += int(rows[1] > rows[0])
    return out


roi_window_pool.launches = 0
roi_window_pool_seg.launches = 0
