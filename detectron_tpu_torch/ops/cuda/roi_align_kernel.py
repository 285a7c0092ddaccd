"""K2 / K3: windowed RoIAlign pooling (kernel csrc/roi_window_pool.cu), and
K4: its transpose, the window accumulate of the RoIAlign backward (kernel
csrc/roi_window_accum.cu).

roi_window_pool replaces detectron_tpu/ops/pallas/roi_align_kernel.py ::
roi_window_pool (the ladder's base sweep) and roi_window_pool_seg replaces
::roi_window_pool_seg (the ladder's fix-up sweeps). One CUDA kernel serves
both: it pools an active row range [lo, hi), the whole array for K2. For
each RoI row n:

    out[n, p, q, c] = sum_w vx[n, q, w] * sum_h vy[n, p, h]
                      * canvas[b, y0 + h, x0 + w, c],  (b, y0, x0) = starts[n]

with both sums in f32 and the result in the canvas dtype. Bound by the
bytes of the canvas cells each RoI's nonzero weights reach, which the
kernel finds from vy and vx and reads once per RoI and channel tile.

roi_window_accum replaces ::roi_window_accum_seg: for each RoI row n of an
active range, in f32 and in place,

    canvas_grad[b, y0 + h, x0 + w, c] += sum_p vy[n, p, h]
                                         * sum_q vx[n, q, w] * ct[n, p, q, c]

with overlapping windows summed (atomic adds on the card, so the order of
the sum, and its last bits, change from run to run).
"""

import ctypes

import torch

from detectron_tpu_torch.ops.cuda import build

MAX_POOLED = 16
MAX_WINDOW = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype):
    """The plain versions' accumulation type: float32, or float64 for a
    float64 input (CPU checks such as torch.autograd.gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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
    acc = _acc_dtype(canvas.dtype)
    t1 = torch.einsum("nph,nhwc->npwc", vy[lo:hi].to(acc), win.to(acc))
    out[lo:hi] = torch.einsum("nqw,npwc->npqc", vx[lo:hi].to(acc),
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


def roi_window_accum_plain(canvas_grad, starts, ct, vy, vx, rows=None,
                           chunk=128):
    """Plain PyTorch version of K4, in place: per RoI, the window gradient
    einsum("ph,pqc,qw->hwc") scattered into canvas_grad with index_put_
    (accumulate=True), `chunk` rows at a time. Cells past the canvas edge
    are dropped. Returns canvas_grad."""
    B, Hc, Wc, C = canvas_grad.shape
    N, P, WY = vy.shape
    WX = vx.shape[2]
    lo, hi = (0, N) if rows is None else rows
    dev = canvas_grad.device
    dy = torch.arange(WY, device=dev)
    dx = torch.arange(WX, device=dev)
    for s in range(lo, hi, chunk):
        e = min(hi, s + chunk)
        st = starts[s:e].long()
        acc = _acc_dtype(canvas_grad.dtype)
        u = torch.einsum("nqw,npqc->npwc", vx[s:e].to(acc), ct[s:e].to(acc))
        d = torch.einsum("nph,npwc->nhwc", vy[s:e].to(acc), u)
        ys = (st[:, 1:2] + dy)[:, :, None].expand(-1, WY, WX)
        xs = (st[:, 2:3] + dx)[:, None, :].expand(-1, WY, WX)
        img = st[:, 0, None, None].expand(-1, WY, WX)
        inside = (ys < Hc) & (xs < Wc)
        canvas_grad.index_put_((img[inside], ys[inside], xs[inside]),
                               d[inside].to(canvas_grad.dtype),
                               accumulate=True)
    return canvas_grad


def roi_window_accum(canvas_grad, starts, ct, vy, vx, rows=None):
    """K4: accumulate the window gradients of rows [lo, hi) = `rows`
    (default all) into canvas_grad (B, Hc, Wc, C) float32, in place.
    starts (N, 3) int32 [img, y0, x0]; ct (N, P, P, C), vy (N, P, WY) and
    vx (N, P, WX) float32. Returns canvas_grad."""
    if canvas_grad.device.type == "cpu":
        return roi_window_accum_plain(canvas_grad, starts, ct, vy, vx, rows)
    name = "roi_window_accum"
    if not all(t.is_cuda and t.device == canvas_grad.device
               for t in (starts, ct, vy, vx)):
        raise ValueError(name + ": all inputs must be on one CUDA device "
                         "(or all on the CPU)")
    if any(t.dtype != torch.float32 for t in (canvas_grad, ct, vy, vx)) or \
            starts.dtype != torch.int32:
        raise TypeError(name + ": canvas_grad/ct/vy/vx must be float32 and "
                        "starts int32; got {} {} {} {} {}".format(
                            canvas_grad.dtype, ct.dtype, vy.dtype, vx.dtype,
                            starts.dtype))
    B, Hc, Wc, C = canvas_grad.shape
    N, P, WY = vy.shape
    WX = vx.shape[2]
    if starts.shape != (N, 3) or vx.shape[:2] != (N, P) or \
            ct.shape != (N, P, P, C):
        raise ValueError(name + ": starts {} / ct {} / vy {} / vx {} / canvas "
                         "{} disagree".format(
                             tuple(starts.shape), tuple(ct.shape),
                             tuple(vy.shape), tuple(vx.shape),
                             tuple(canvas_grad.shape)))
    if P > MAX_POOLED or WY > MAX_WINDOW or WX > MAX_WINDOW:
        raise ValueError(name + ": pooled <= {} and windows <= {} only, got "
                         "P={} window=({}, {})".format(
                             MAX_POOLED, MAX_WINDOW, P, WY, WX))
    lo, hi = (0, N) if rows is None else tuple(rows)
    if not 0 <= lo <= hi <= N:
        raise ValueError(name + ": rows ({}, {}) outside [0, {}]".format(
            lo, hi, N))
    if not all(t.is_contiguous() for t in (canvas_grad, starts, ct, vy, vx)):
        raise ValueError(name + " needs contiguous inputs")
    fn = build.load("roi_window_accum.cu", "roi_window_accum_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(canvas_grad.device).cuda_stream
    err = fn(canvas_grad.data_ptr(), starts.data_ptr(), ct.data_ptr(),
             vy.data_ptr(), vx.data_ptr(), B, Hc, Wc, C, lo, hi, WY, WX, P,
             stream)
    build.check(err, name)
    roi_window_accum.launches += int(hi > lo)
    return canvas_grad


roi_window_pool.launches = 0
roi_window_pool_seg.launches = 0
roi_window_accum.launches = 0
