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

over the cells the weights reach only, with overlapping windows summed
(16-byte vector reductions on the card, so the order of the sum, and its
last bits, change from run to run). Under torch.use_deterministic_algorithms
the wrapper launches roi_window_accum_det (csrc/roi_window_accum_det.cu)
instead: the same function without float atomics, so its bits repeat. A
pre-pass lists on the device, for every (image, DET_TILE canvas tile), the
RoI rows whose nonzero weights reach it, in row order (its contract is
roi_tile_lists_plain); the accumulate adds each list, 32 rows a work item,
into the tile's cells, and the items of one tile in list order.
"""

import ctypes

import torch

from detectron_tpu_torch.ops.cuda import build

MAX_POOLED = 16
MAX_WINDOW = 128
# Canvas tile (rows, columns) of roi_window_accum_det's per-tile RoI lists.
DET_TILE = (8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype):
    """The plain versions' accumulation type: float32, or float64 for a
    float64 input (CPU checks such as torch.autograd.gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# The plain versions gather each RoI's whole window: they take RoIs in
# chunks whose gathered windows stay within this many bytes (a whole-map
# window of the C4 models' res4 is 17.9 MB a RoI in float32).
PLAIN_CHUNK_BYTES = 1 << 30


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
    dev = canvas.device
    acc = _acc_dtype(canvas.dtype)
    chunk = max(1, PLAIN_CHUNK_BYTES // (WY * WX * C * 8))
    for s0 in range(lo, hi, chunk):
        e = min(hi, s0 + chunk)
        s = starts[s0:e].long()
        ys = s[:, 1:2] + torch.arange(WY, device=dev)
        xs = s[:, 2:3] + torch.arange(WX, device=dev)
        win = canvas[s[:, 0, None, None], ys[:, :, None], xs[:, None, :]]
        t1 = torch.einsum("nph,nhwc->npwc", vy[s0:e].to(acc), win.to(acc))
        out[s0:e] = torch.einsum("nqw,npwc->npqc", vx[s0:e].to(acc),
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
    (accumulate=True), `chunk` rows at a time (fewer where their windows
    pass PLAIN_CHUNK_BYTES). Cells past the canvas edge are dropped.
    Returns canvas_grad."""
    B, Hc, Wc, C = canvas_grad.shape
    N, P, WY = vy.shape
    WX = vx.shape[2]
    chunk = max(1, min(chunk, PLAIN_CHUNK_BYTES // (WY * WX * C * 8)))
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


def _check_accum(name, canvas_grad, starts, ct, vy, vx, rows):
    """Validate K4's inputs on the card; returns (lo, hi)."""
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
    C = canvas_grad.shape[-1]
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
    return lo, hi


def roi_window_accum(canvas_grad, starts, ct, vy, vx, rows=None):
    """K4: accumulate the window gradients of rows [lo, hi) = `rows`
    (default all) into canvas_grad (B, Hc, Wc, C) float32, in place.
    starts (N, 3) int32 [img, y0, x0]; ct (N, P, P, C), vy (N, P, WY) and
    vx (N, P, WX) float32. Returns canvas_grad. While
    torch.use_deterministic_algorithms is on, a CUDA call runs
    roi_window_accum_det instead (no atomics: equal bits from call to
    call)."""
    if canvas_grad.device.type == "cpu":
        return roi_window_accum_plain(canvas_grad, starts, ct, vy, vx, rows)
    if torch.are_deterministic_algorithms_enabled():
        return roi_window_accum_det(canvas_grad, starts, ct, vy, vx, rows)
    name = "roi_window_accum"
    lo, hi = _check_accum(name, canvas_grad, starts, ct, vy, vx, rows)
    B, Hc, Wc, C = canvas_grad.shape
    N, P, WY = vy.shape
    fn = build.load("roi_window_accum.cu", "roi_window_accum_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(canvas_grad.device).cuda_stream
    err = fn(canvas_grad.data_ptr(), starts.data_ptr(), ct.data_ptr(),
             vy.data_ptr(), vx.data_ptr(), B, Hc, Wc, C, lo, hi, WY,
             vx.shape[2], P, stream)
    build.check(err, name)
    roi_window_accum.launches += int(hi > lo)
    return canvas_grad


def _det_layout(canvas_shape, C, rows, WY, WX, P):
    """roi_window_accum_det's scratch layout for these shapes, from the
    kernel's source (roi_window_accum_det_layout): the tile, the tiles
    along each side, and the int32 offsets of the tile counts and list
    entries and the scratch's size (int32 1 holds the entries' number)."""
    B, Hc, Wc = canvas_shape[:3]
    fn = build.load("roi_window_accum_det.cu", "roi_window_accum_det_layout",
                    [ctypes.c_int] * 8 + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 7)()
    build.check(fn(B, Hc, Wc, C, rows, WY, WX, P, ctypes.addressof(out)),
                "roi_window_accum_det_layout")
    keys = ("tile_h", "tile_w", "tiles_y", "tiles_x", "counts", "entries",
            "ints")
    lay = dict(zip(keys, out))
    if (lay["tile_h"], lay["tile_w"]) != DET_TILE:
        raise RuntimeError("roi_window_accum_det.cu tiles the canvas {} x "
                           "{}, DET_TILE says {}".format(
                               lay["tile_h"], lay["tile_w"], DET_TILE))
    return lay


def roi_window_accum_det(canvas_grad, starts, ct, vy, vx, rows=None):
    """K4 without float atomics (kernel csrc/roi_window_accum_det.cu): the
    same function and arguments as roi_window_accum, each canvas cell's
    terms added in an order fixed by the inputs (the rows of each DET_TILE
    tile's list in row order, 32 a work item, the items in list order), so
    two calls on the same inputs give the same bits. The wrapper allocates
    the kernel's int32 scratch (the per-tile lists and their counts). CPU
    tensors take the plain version."""
    if canvas_grad.device.type == "cpu":
        return roi_window_accum_plain(canvas_grad, starts, ct, vy, vx, rows)
    name = "roi_window_accum_det"
    lo, hi = _check_accum(name, canvas_grad, starts, ct, vy, vx, rows)
    B, Hc, Wc, C = canvas_grad.shape
    N, P, WY = vy.shape
    lay = _det_layout(canvas_grad.shape, C, hi - lo, WY, vx.shape[2], P)
    fn = build.load("roi_window_accum_det.cu", "roi_window_accum_det_launch",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    scratch = torch.empty(max(lay["ints"], 1), dtype=torch.int32,
                          device=canvas_grad.device)
    stream = torch.cuda.current_stream(canvas_grad.device).cuda_stream
    err = fn(canvas_grad.data_ptr(), starts.data_ptr(), scratch.data_ptr(),
             ct.data_ptr(), vy.data_ptr(), vx.data_ptr(), B, Hc, Wc, C, lo,
             hi, WY, vx.shape[2], P, stream)
    build.check(err, name)
    roi_window_accum_det.launches += int(hi > lo)
    return canvas_grad


def roi_tile_lists_plain(starts, vy, vx, rows, canvas_shape, tile):
    """Plain version of roi_window_accum_det's pre-pass contract. A RoI row
    n of [lo, hi) = `rows` (None: all) reaches canvas cell (b, y0 + h, x0 +
    w), (b, y0, x0) = starts[n], where some vy[n, :, h] and some vx[n, :, w]
    are nonzero and the cell lies on the canvas (B, Hc, Wc, ...); rows with
    b outside [0, B) or a negative origin reach nothing. With the canvas cut
    into tiles of `tile` = (rows, columns), returns (counts (B, tiles_y,
    tiles_x) int32: the rows that reach each tile; lists (sum of counts,)
    int64: each tile's rows in increasing order, the tiles in (b, ty, tx)
    order)."""
    B, Hc, Wc = canvas_shape[:3]
    th, tw = tile
    ty_n, tx_n = -(-Hc // th), -(-Wc // tw)
    N, _, WY = vy.shape
    WX = vx.shape[2]
    lo, hi = (0, N) if rows is None else rows
    dev = vy.device
    st = starts[lo:hi].long()
    b, y0, x0 = st[:, 0], st[:, 1], st[:, 2]
    valid = (b >= 0) & (b < B) & (y0 >= 0) & (x0 >= 0)
    ys = y0[:, None] + torch.arange(WY, device=dev)
    xs = x0[:, None] + torch.arange(WX, device=dev)
    row_hit = vy[lo:hi].ne(0).any(1) & (ys < Hc) & valid[:, None]
    col_hit = vx[lo:hi].ne(0).any(1) & (xs < Wc) & valid[:, None]
    # Tile bands each row reaches: (n, ty_n) and (n, tx_n).
    bands_y = torch.zeros((hi - lo, ty_n + 1), dtype=torch.bool, device=dev)
    bands_x = torch.zeros((hi - lo, tx_n + 1), dtype=torch.bool, device=dev)
    bands_y.scatter_(1, torch.where(row_hit, ys // th, ty_n).clamp(0, ty_n),
                     True)
    bands_x.scatter_(1, torch.where(col_hit, xs // tw, tx_n).clamp(0, tx_n),
                     True)
    hit = bands_y[:, :ty_n, None] & bands_x[:, None, :tx_n]   # (n, ty, tx)
    grid = torch.zeros((B, ty_n, tx_n, hi - lo), dtype=torch.bool,
                       device=dev)
    idx = valid.nonzero()[:, 0]
    grid[b[idx], :, :, idx] = hit[idx]
    counts = grid.sum(-1).to(torch.int32)
    lists = grid.nonzero()[:, 3] + lo
    return counts, lists


def roi_tile_lists(starts, vy, vx, rows, canvas_shape):
    """roi_window_accum_det's pre-pass alone, on the card: (counts, lists)
    as roi_tile_lists_plain gives them at tile = DET_TILE, read back from
    the kernel's scratch (a check of the lists; no path calls it). CPU
    tensors take the plain version."""
    if vy.device.type == "cpu":
        return roi_tile_lists_plain(starts, vy, vx, rows, canvas_shape,
                                    DET_TILE)
    name = "roi_tile_lists"
    B, Hc, Wc, C = canvas_shape
    N, P, WY = vy.shape
    WX = vx.shape[2]
    if not (starts.is_cuda and starts.device == vy.device
            and vx.device == vy.device):
        raise ValueError(name + ": all inputs must be on one CUDA device "
                         "(or all on the CPU)")
    if vy.dtype != torch.float32 or vx.dtype != torch.float32 or \
            starts.dtype != torch.int32:
        raise TypeError(name + ": vy/vx must be float32 and starts int32")
    if starts.shape != (N, 3) or vx.shape[:2] != (N, P) or \
            P > MAX_POOLED or WY > MAX_WINDOW or WX > MAX_WINDOW:
        raise ValueError(name + ": starts {} / vy {} / vx {} disagree or "
                         "exceed P <= {}, windows <= {}".format(
                             tuple(starts.shape), tuple(vy.shape),
                             tuple(vx.shape), MAX_POOLED, MAX_WINDOW))
    lo, hi = (0, N) if rows is None else tuple(rows)
    if not 0 <= lo <= hi <= N:
        raise ValueError(name + ": rows ({}, {}) outside [0, {}]".format(
            lo, hi, N))
    if not all(t.is_contiguous() for t in (starts, vy, vx)):
        raise ValueError(name + " needs contiguous inputs")
    lay = _det_layout(canvas_shape, C, hi - lo, WY, WX, P)
    if hi == lo:
        return (torch.zeros((B, lay["tiles_y"], lay["tiles_x"]),
                            dtype=torch.int32, device=vy.device),
                torch.zeros(0, dtype=torch.int64, device=vy.device))
    fn = build.load("roi_window_accum_det.cu", "roi_window_accum_det_lists",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    scratch = torch.empty(max(lay["ints"], 1), dtype=torch.int32,
                          device=vy.device)
    stream = torch.cuda.current_stream(vy.device).cuda_stream
    build.check(fn(starts.data_ptr(), scratch.data_ptr(), vy.data_ptr(),
                   vx.data_ptr(), B, Hc, Wc, C, lo, hi, WY, WX, P, stream),
                name)
    roi_tile_lists.launches += 1
    tiles = B * lay["tiles_y"] * lay["tiles_x"]
    counts = scratch[lay["counts"]:lay["counts"] + tiles].view(
        B, lay["tiles_y"], lay["tiles_x"])
    n = int(scratch[1])
    lists = scratch[lay["entries"]:lay["entries"] + 4 * n].view(n, 4)[:, 0]
    return counts.clone(), lists.long()


roi_window_pool.launches = 0
roi_window_pool_seg.launches = 0
roi_window_accum.launches = 0
roi_window_accum_det.launches = 0
roi_tile_lists.launches = 0
