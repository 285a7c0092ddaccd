"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card: K1 keep masks exactly, K2/K3 to 1e-5 relative in float32 and 2
bf16 ulps in bfloat16 (both sum in f32, in different orders), K4 within
1e-5 max|ref| + 1e-6 (its atomic adds sum overlapping windows in an order
that changes from run to run), K5 exactly, K6 to 1e-5 of max|ref| in
float32 and, in bfloat16, to 2^-7 |ref| + 2^-6 max|ref| (an ulp of the
value plus 2 to 4 at the top magnitude) with under 20% of the elements
differing: the kernel and cuDNN sum in other orders, so a bf16 rounding
may fall the other way, later convs carry that on, and a residual add
that cancels keeps its operands' ulps; a systematic rounding fault would
move about half the elements. Under torch.use_deterministic_algorithms,
K4's deterministic variant (roi_window_accum_det) gives equal bits in two
calls, and two identical training steps equal gradients. Every test skips
where no CUDA device is present. On a machine with an NVIDIA GPU (no
JAX needed, so without the suite's conftest):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from detectron_tpu_torch.ops import nms as nms_ops
from detectron_tpu_torch.ops import windowed_roi as win
from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
from detectron_tpu_torch.ops.cuda import nms_kernel
from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

pytestmark = pytest.mark.cuda

# Deterministic cuBLAS (torch.use_deterministic_algorithms raises in a
# matmul without it); read when cuBLAS starts, so set before any test runs.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    # Plain versions' float32 convolutions in full float32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lanes(seed, L, N, device):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (L, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 80, (L, N, 2))], -1)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]  # repeats
    valid = rng.rand(L, N) < 0.9
    valid[:, rng.randint(0, N + 1):] = False
    return (torch.tensor(boxes, dtype=torch.float32, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.parametrize("L,N,thr", [(1, 1, 0.5), (3, 64, 0.5),
                                     (2, 1000, 0.7), (161, 400, 0.5),
                                     (4, 2048, 0.3), (3, 65, 0.5),
                                     (2, 819, 0.7), (10, 2000, 0.7),
                                     (2, 2049, 0.7), (2, 6000, 0.5),
                                     (2, 12000, 0.7), (1, 20000, 0.7)])
def test_nms_keep_mask_matches_plain(device, L, N, thr):
    """Random lanes with invalid holes mid-lane, repeated boxes (IoU
    exactly 1) and a tail of invalid slots; N not a multiple of 64 (65,
    819), the largest short lane (2048) and long lanes, whose scan keeps
    its mask in shared memory: one word past the short ones (2049), the
    default cfg's RPN_PRE_NMS_TOP_N (12000) and N = 20000 (313 words: past
    the short scan's slabs and past 65,535 (row block, column block)
    pairs)."""
    boxes, valid = _lanes(L + N, L, N, device)
    before = nms_kernel.nms_keep_mask.launches
    got = nms_kernel.nms_keep_mask(boxes, valid, thr)
    assert nms_kernel.nms_keep_mask.launches == before + 1
    ref = nms_kernel.nms_keep_mask_plain(boxes, valid, thr)
    assert torch.equal(got, ref)


def test_nms_keep_mask_edge_lanes(device):
    """A lane with no valid box, one with a single valid box first, one
    with a single valid box last, one of identical boxes, one whose
    second and third 64-box blocks are all invalid, and one of boxes that
    touch without overlapping (IoU 0) or overlap by a +1 pixel."""
    L, N = 6, 300
    boxes, valid = _lanes(7, L, N, device)
    valid[:] = True
    valid[0] = False
    valid[1, 1:] = False
    valid[2, :-1] = False
    boxes[3] = boxes[3, :1]
    valid[4, 64:192] = False
    x = torch.arange(N, device=device, dtype=torch.float32) * 10.0
    boxes[5] = torch.stack([x, x * 0, x + 9.0 + (x % 20 == 0), x * 0 + 9],
                           -1)
    got = nms_kernel.nms_keep_mask(boxes, valid, 0.0)
    ref = nms_kernel.nms_keep_mask_plain(boxes, valid, 0.0)
    assert torch.equal(got, ref)
    assert not got[0].any() and got[1, 0] and got[2, -1]
    assert int(got[3].sum()) == 1 and not got[4, 64:192].any()
    for thr in (0.3, 0.7):
        assert torch.equal(nms_kernel.nms_keep_mask(boxes, valid, thr),
                           nms_kernel.nms_keep_mask_plain(boxes, valid, thr))


def test_nms_stacked_lanes_of_different_lengths(device):
    """The RPN's stacked call: groups of B = 2 lanes of N = 1000, 819 and
    65 boxes padded to 1000 with invalid slots, in one launch, give each
    group's keep mask exactly."""
    groups = [_lanes(N, 2, N, device) for N in (1000, 819, 65)]
    scores = [torch.where(v, torch.linspace(1, 0, v.shape[1], device=device),
                          -torch.inf) for _, v in groups]
    before = nms_kernel.nms_keep_mask.launches
    got = nms_ops.nms_stacked_mask([b for b, _ in groups], scores, 0.7)
    assert nms_kernel.nms_keep_mask.launches == before + 1
    for (b, v), k in zip(groups, got):
        assert torch.equal(k, nms_kernel.nms_keep_mask_plain(b, v, 0.7))


def test_nms_stacked_lanes_of_the_default_cfg(device):
    """The RPN's stacked call at the default cfg (RPN_PRE_NMS_TOP_N 12000)
    on an 832 x 1344 canvas, B = 2: P2-P4 give 12000 boxes, P5 3276 and P6
    819, padded to 12000 in one launch of the long scan."""
    groups = [_lanes(N + 1, 2, N, device)
              for N in (12000, 12000, 12000, 3276, 819)]
    scores = [torch.where(v, torch.linspace(1, 0, v.shape[1], device=device),
                          -torch.inf) for _, v in groups]
    before = nms_kernel.nms_keep_mask.launches
    got = nms_ops.nms_stacked_mask([b for b, _ in groups], scores, 0.7)
    assert nms_kernel.nms_keep_mask.launches == before + 1
    for (b, v), k in zip(groups, got):
        assert torch.equal(k, nms_kernel.nms_keep_mask_plain(b, v, 0.7))


def _pool_inputs(seed, N, P, WY, WX, dtype, device, C=80, Hc=120,
                 Wc=200):
    rng = np.random.RandomState(seed)
    B = 2
    canvas = torch.tensor(rng.randn(B, Hc, Wc, C), dtype=dtype,
                          device=device)
    starts = torch.tensor(np.stack(
        [rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
         rng.randint(0, Wc - WX + 1, N)], -1), dtype=torch.int32,
        device=device)
    vy = torch.tensor(rng.rand(N, P, WY), dtype=dtype, device=device)
    vx = torch.tensor(rng.rand(N, P, WX), dtype=dtype, device=device)
    return canvas, starts, vy, vx


def _close(got, ref, dtype):
    """1e-5 relative in float32, 2 bf16 ulps in bfloat16, each with a
    floor of that share of max|ref| for cancelling sums."""
    got, ref = got.float(), ref.float()
    rtol = 1e-5 if dtype == torch.float32 else 1.0 / 64
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,WY,WX,rows,C", [(7, 32, 48, None, 80),
                                            (14, 32, 48, None, 80),
                                            (7, 64, 48, (3, 17), 80),
                                            (14, 16, 96, (0, 5), 80),
                                            (7, 32, 48, None, 35)])
def test_roi_window_pool_matches_plain(device, P, WY, WX, rows, C, dtype):
    """Dense random weights; C = 35 takes the kernel's element-wise copy
    (rows of 70 or 140 bytes admit no 16-byte copies) and a partial
    channel tile."""
    args = _pool_inputs(P + WY, 24, P, WY, WX, dtype, device, C=C)
    if rows is None:
        got = rk.roi_window_pool(*args)
        ref = rk.roi_window_pool_plain(*args)
        rows = (0, 24)
    else:
        got = rk.roi_window_pool_seg(*args, rows)
        ref = rk.roi_window_pool_plain(*args, rows=rows)
    _close(got[rows[0]:rows[1]], ref[rows[0]:rows[1]], dtype)


def _ladder_pool_inputs(seed, n, pooled, window, dtype, device, C=64):
    """The ladder's sparse weights, as on the main path: a 2-image canvas
    from a random P2-P5 pyramid of a 256 x 320 image, and
    windowed_roi.window_params of n RoIs of detector-like sizes at
    `window` (None: the base window)."""
    rng = np.random.RandomState(seed)
    dims = [(256 // s, 320 // s) for s in (4, 8, 16, 32)]
    pyramid = [torch.tensor(rng.randn(2, h, w, C), dtype=dtype,
                            device=device) for h, w in dims]
    geom = win.ladder_geom(dims, ((32, 40), (64, 48), (16, 96), (32, 96),
                                  (128, 128)))
    canvas = win.build_canvas(pyramid, geom)
    wy, wx = window or (geom["wy_base"], geom["wx_base"])
    xy = rng.uniform(0, 280, (n, 2))
    wh = rng.lognormal(3.5, 0.8, (n, 2)).clip(2, 300)
    rois = torch.tensor(np.concatenate([xy, xy + wh], 1),
                        dtype=torch.float32, device=device)
    sy, sx, vy, vx, _ = win.window_params(
        rois, geom, (0.25, 0.125, 0.0625, 0.03125), pooled, 2, 2, 5, 224, 4,
        wy, wx, dtype)
    img = torch.tensor(rng.randint(0, 2, n), dtype=torch.int32,
                       device=device)
    return canvas, torch.stack([img, sy, sx], -1).contiguous(), vy, vx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,window,rows", [(7, None, None),
                                           (14, None, None),
                                           (7, (64, 48), (2, 30)),
                                           (7, (16, 96), (0, 40)),
                                           (7, (32, 96), (4, 9)),
                                           (16, (128, 128), (0, 12))])
def test_roi_window_pool_sparse_weights(device, P, window, rows, dtype):
    """The ladder's own weights (each pooled row reaches a few window rows
    and columns), with one RoI whose vy is all zero and one whose vx is:
    those pool to exact zeros."""
    canvas, starts, vy, vx = _ladder_pool_inputs(P + len(rows or ()), 40, P,
                                                 window, dtype, device)
    vy[3] = 0
    vx[5] = 0
    before = (rk.roi_window_pool.launches, rk.roi_window_pool_seg.launches)
    if rows is None:
        rows = (0, 40)
        got = rk.roi_window_pool(canvas, starts, vy, vx)
        assert rk.roi_window_pool.launches == before[0] + 1
    else:
        got = rk.roi_window_pool_seg(canvas, starts, vy, vx, rows)
        assert rk.roi_window_pool_seg.launches == before[1] + 1
    ref = rk.roi_window_pool_plain(canvas, starts, vy, vx, rows)
    lo, hi = rows
    _close(got[lo:hi], ref[lo:hi], dtype)
    for k in (3, 5):
        if lo <= k < hi:
            assert not got[k].any()
    assert got[lo:hi].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,WY,WX", [(7, 32, 48), (16, 128, 128)])
def test_roi_window_pool_clips_at_the_canvas_edge(device, P, WY, WX, dtype):
    """Windows that run past the canvas's bottom and right edges, dense
    weights: the kernel skips the cells past the edge, which is the plain
    version on the canvas padded with zeros. Also the wrapper's limits
    (P = 16, a 128 x 128 window)."""
    canvas, starts, vy, vx = _pool_inputs(WY + P, 12, P, WY, WX, dtype,
                                          device, C=48, Hc=140, Wc=150)
    Hc, Wc = canvas.shape[1:3]
    starts[:, 1] = torch.arange(12, device=device) % 4 * (Hc - WY // 2) // 3
    starts[:, 2] = torch.arange(12, device=device) // 4 * (Wc - WX // 3) // 2
    padded = torch.nn.functional.pad(canvas, (0, 0, 0, WX, 0, WY))
    _close(rk.roi_window_pool(canvas, starts, vy, vx),
           rk.roi_window_pool_plain(padded, starts, vy, vx), dtype)


@pytest.mark.parametrize("P,WY,WX,rows", [(7, 32, 48, None),
                                          (14, 32, 48, None),
                                          (7, 64, 48, (3, 17)),
                                          (14, 32, 96, (0, 5)),
                                          (16, 96, 128, (2, 4))])
def test_roi_window_accum_matches_plain(device, P, WY, WX, rows):
    """Overlapping windows (24 RoIs on a 2 x 120 x 200 canvas), windows
    running past the canvas edge, and an active row range."""
    canvas, starts, vy, vx = _pool_inputs(P * WX, 24, P, WY, WX,
                                          torch.float32, device)
    starts[::5, 1] = canvas.shape[1] - WY // 2
    ct = torch.randn((24, P, P, canvas.shape[-1]), device=device,
                     generator=torch.Generator(device).manual_seed(P))
    base = torch.randn(canvas.shape, device=device,
                       generator=torch.Generator(device).manual_seed(1))
    got = base.clone()
    before = rk.roi_window_accum.launches
    assert rk.roi_window_accum(got, starts, ct, vy, vx, rows) is got
    assert rk.roi_window_accum.launches == before + 1
    ref = rk.roi_window_accum_plain(base.clone(), starts, ct, vy, vx, rows)
    torch.cuda.synchronize()
    bound = 1e-5 * float(ref.abs().max()) + 1e-6
    assert float((got - ref).abs().max()) <= bound


def _accum_check(canvas, starts, ct, vy, vx, rows=None):
    """K4 on a random base canvas against its plain version, within 1e-5
    max|ref| + 1e-6; returns the kernel's canvas."""
    base = torch.randn(canvas.shape, device=canvas.device,
                       generator=torch.Generator(canvas.device).manual_seed(1))
    got = base.clone()
    before = rk.roi_window_accum.launches
    assert rk.roi_window_accum(got, starts, ct, vy, vx, rows) is got
    assert rk.roi_window_accum.launches == before + 1
    ref = rk.roi_window_accum_plain(base.clone(), starts, ct, vy, vx, rows)
    torch.cuda.synchronize()
    bound = 1e-5 * float(ref.abs().max()) + 1e-6
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= bound
    return got - base


@pytest.mark.parametrize("C", [35, 80, 256])
def test_roi_window_accum_on_one_spot(device, C):
    """Every RoI on one spot: 64 RoIs with one origin and the ladder's
    weights of one box (the one whose weights reach the most cells), so
    each reached cell takes 64 reductions from 64 CTAs at once. C = 35
    takes the scalar adds (no 16-byte lanes)."""
    canvas, starts, vy, vx = _ladder_pool_inputs(C, 64, 7, None,
                                                 torch.float32, device, C=C)
    k = int((vy.ne(0).any(1).sum(1) * vx.ne(0).any(1).sum(1)).argmax())
    starts[:] = starts[k].clone()
    vy[:] = vy[k].clone()
    vx[:] = vx[k].clone()
    ct = torch.randn((64, 7, 7, C), device=device,
                     generator=torch.Generator(device).manual_seed(C))
    d = _accum_check(canvas, starts, ct, vy, vx)
    assert float(d.abs().max()) > 0


@pytest.mark.parametrize("C", [35, 80, 256])
@pytest.mark.parametrize("P,window,rows", [(7, None, None), (14, None, None),
                                           (7, (16, 96), (3, 29)),
                                           (16, (128, 128), (0, 12))])
def test_roi_window_accum_sparse_weights(device, P, window, rows, C):
    """The ladder's own weights, with one RoI whose vy is all zero and one
    whose vx is (they add nothing), at the base window, a rung with an
    active row range, and the wrapper's limits (P = 16 on a 128 x 128
    window)."""
    canvas, starts, vy, vx = _ladder_pool_inputs(P + C, 40, P, window,
                                                 torch.float32, device, C=C)
    vy[3] = 0
    vx[5] = 0
    ct = torch.randn((40, P, P, C), device=device,
                     generator=torch.Generator(device).manual_seed(P))
    _accum_check(canvas, starts, ct, vy, vx, rows)
    zero = torch.zeros_like(canvas)
    rk.roi_window_accum(zero, starts[[3, 5]], ct[[3, 5]], vy[[3, 5]],
                        vx[[3, 5]])
    assert not zero.any()


@pytest.mark.parametrize("P,WY,WX,C", [(7, 32, 48, 256), (16, 128, 128, 35),
                                       (14, 32, 96, 80)])
def test_roi_window_accum_clips_at_the_canvas_edge(device, P, WY, WX, C):
    """Windows past the canvas's bottom and right edges, dense weights:
    the cells past the edge are dropped, as the plain version drops
    them."""
    canvas, starts, vy, vx = _pool_inputs(WY + P + C, 12, P, WY, WX,
                                          torch.float32, device, C=C,
                                          Hc=140, Wc=150)
    Hc, Wc = canvas.shape[1:3]
    starts[:, 1] = torch.arange(12, device=device) % 4 * (Hc - WY // 2) // 3
    starts[:, 2] = torch.arange(12, device=device) // 4 * (Wc - WX // 3) // 2
    ct = torch.randn((12, P, P, C), device=device,
                     generator=torch.Generator(device).manual_seed(WY))
    _accum_check(canvas, starts, ct, vy, vx)


def test_wrappers_raise_instead_of_falling_back(device):
    canvas, starts, vy, vx = _pool_inputs(0, 8, 7, 32, 48, torch.float32,
                                          device)
    with pytest.raises(TypeError):
        rk.roi_window_pool(canvas, starts.long(), vy, vx)
    with pytest.raises(ValueError):
        rk.roi_window_pool(canvas, starts, vy.cpu(), vx)
    with pytest.raises(ValueError):
        rk.roi_window_pool(canvas, starts,
                           vy.transpose(1, 2).contiguous().transpose(1, 2),
                           vx)
    ct = torch.zeros((8, 7, 7, 80), device=device)
    with pytest.raises(TypeError):
        rk.roi_window_accum(canvas.bfloat16(), starts, ct, vy, vx)
    with pytest.raises(ValueError):
        rk.roi_window_accum(canvas, starts, ct[:, :6], vy, vx)
    with pytest.raises(ValueError):
        rk.roi_window_accum(canvas, starts, ct, vy, vx, rows=(0, 9))
    boxes, valid = _lanes(0, 2, 3000, device)
    with pytest.raises(ValueError):
        nms_kernel.nms_keep_mask(boxes[:, :2999].contiguous(), valid, 0.5)
    with pytest.raises(ValueError):
        nms_kernel.nms_keep_mask(boxes, valid.cpu(), 0.5)
    # Lanes whose IoU mask (80 GB) and scan words pass what the card holds.
    with pytest.raises(ValueError):
        nms_kernel.nms_keep_mask(torch.zeros((1, 800000, 4), device=device),
                                 torch.ones((1, 800000), dtype=torch.bool,
                                            device=device), 0.5)
    with pytest.raises(TypeError):
        nms_kernel.nms_keep_mask(boxes.double(), valid, 0.5)


@pytest.mark.parametrize("shape", [(2, 32, 64, 64), (1, 30, 46, 64),
                                   (2, 416, 672, 64)])
def test_stem_pool_matches_plain_exactly(device, shape):
    rng = np.random.RandomState(shape[1])
    x = torch.tensor(rng.randn(*shape) * 2.0, dtype=torch.bfloat16,
                     device=device)
    s = torch.tensor(rng.uniform(0.5, 1.5, 64), dtype=torch.float32,
                     device=device)
    b = torch.tensor(rng.uniform(-0.5, 0.5, 64), dtype=torch.float32,
                     device=device)
    before = fk.stem_pool.launches
    got = fk.stem_pool(x, s, b)
    assert fk.stem_pool.launches == before + 1
    assert torch.equal(got, fk.stem_pool_plain(x, s, b))


def _res2_stage(seed, device):
    """A random res2 stage in the bridged (OIHW) layout, random affines."""
    rng = np.random.RandomState(seed)

    def conv(cout, cin, k):
        return {"w": torch.tensor(rng.randn(cout, cin, k, k) * np.sqrt(
            2.0 / (cin * k * k)), dtype=torch.float32, device=device)}

    def bn(c):
        return {k: torch.tensor(rng.uniform(lo, hi, c), dtype=torch.float32,
                                device=device)
                for k, lo, hi in (("s", 0.5, 1.5), ("b", -0.3, 0.3))}
    stage = []
    for i in range(3):
        cin = 64 if i == 0 else 256
        bp = {"branch2a": conv(64, cin, 1), "branch2a_bn": bn(64),
              "branch2b": conv(64, 64, 3), "branch2b_bn": bn(64),
              "branch2c": conv(256, 64, 1), "branch2c_bn": bn(256)}
        if i == 0:
            bp["branch1"], bp["branch1_bn"] = conv(256, 64, 1), bn(256)
        stage.append(bp)
    return stage


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 8, 16, 64),
                                   (1, 13, 21, 64), (2, 52, 84, 64)])
def test_fused_res2_matches_plain(device, shape, dtype):
    """Whole tiles, one tile, ragged tiles at the bottom and right edges,
    and many tiles."""
    folded = fk.fold_res2_weights(_res2_stage(shape[1], device), dtype)
    x = torch.tensor(np.random.RandomState(shape[2]).randn(*shape),
                     dtype=dtype, device=device).relu()
    before = fk.fused_res2.launches
    got = fk.fused_res2(x, folded)
    assert fk.fused_res2.launches == before + 1
    ref = fk.fused_res2_plain(x, folded)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    top = float(ref.abs().max())
    share = float((d > 0).float().mean())
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * top, (float(d.max()), top)
    else:
        bound = 2.0 ** -7 * ref.abs() + 2.0 ** -6 * top
        worst = int((d / bound).argmax())
        assert bool((d <= bound).all()) and share < 0.2, (
            float((d / bound).max()), share, float(d.max()), top,
            np.unravel_index(worst, d.shape), float(got.flatten()[worst]),
            float(ref.flatten()[worst]))


@pytest.mark.parametrize("shape", [(1, 9, 17, 64), (1, 37, 50, 64),
                                   (1, 211, 333, 64)])
def test_fused_res2_bf16_ragged_single_image(device, shape):
    """bf16, one image, H and W not multiples of the 8 x 16 tile (one tile
    and a ragged row and column of tiles; many tiles at about the stage's
    full size)."""
    folded = fk.fold_res2_weights(_res2_stage(shape[2], device),
                                  torch.bfloat16)
    x = torch.tensor(np.random.RandomState(shape[1]).randn(*shape),
                     dtype=torch.bfloat16, device=device).relu()
    got = fk.fused_res2(x, folded).float()
    ref = fk.fused_res2_plain(x, folded).float()
    d = (got - ref).abs()
    top = float(ref.abs().max())
    assert bool((d <= 2.0 ** -7 * ref.abs() + 2.0 ** -6 * top).all())
    assert float((d > 0).float().mean()) < 0.2


def test_fused_wrappers_raise_instead_of_falling_back(device):
    folded = fk.fold_res2_weights(_res2_stage(0, device), torch.bfloat16)
    x = torch.zeros((1, 8, 16, 64), dtype=torch.bfloat16, device=device)
    with pytest.raises(TypeError):
        fk.fused_res2(x.half(), folded)
    with pytest.raises(TypeError):
        fk.fused_res2(x.float(), folded)          # bf16 weights, f32 x
    with pytest.raises(ValueError):
        fk.fused_res2(x[..., :32].contiguous(), folded)
    with pytest.raises(ValueError):
        fk.fused_res2(x.transpose(1, 2), folded)  # not contiguous
    with pytest.raises(ValueError):
        fk.fused_res2(x.float().requires_grad_(True),
                      fk.fold_res2_weights(_res2_stage(0, device),
                                           torch.float32))
    cpu = [{k: t.cpu() for k, t in blk.items()} for blk in folded]
    with pytest.raises(ValueError):
        fk.fused_res2(x, cpu)
    s = torch.ones(64, device=device)
    b = torch.zeros(64, device=device)
    with pytest.raises(TypeError):
        fk.stem_pool(x.float(), s, b)
    with pytest.raises(ValueError):
        fk.stem_pool(x[:, :7], s, b)              # odd height
    with pytest.raises(ValueError):
        fk.stem_pool(x, s.cpu(), b)


def test_keypoint_detect_graph_matches_cpu(device):
    """Keypoint R-CNN detect_graph on the card (K1-K3) against the CPU's
    plain path in float32, at tiny sizes: the same detections (IoU > 0.99,
    scores within 1e-4) and, for each, heatmaps within 1e-4 of max|ref|."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.configs_presets import keypoint_rcnn_r50_fpn
    from detectron_tpu_torch.models import bridge, init
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    config.reset_cfg()
    keypoint_rcnn_r50_fpn()
    config.merge_cfg_from_list([
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "64",
        "TEST.DETECTIONS_PER_IM", "20", "FAST_RCNN.MLP_HEAD_DIM", "32",
        "KRCNN.NUM_STACKED_CONVS", "2", "KRCNN.CONV_HEAD_DIM", "32"])
    config.assert_and_infer_cfg(make_immutable=False)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    tree["box_outs"]["cls_score"]["b"][1] += 3.0
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(2, 256, 320, 3).astype(np.float32)
                              * 0.3)
    im_info = torch.tensor([[250.0, 310.0, 1.0]] * 2)
    before = rk.roi_window_pool.launches
    outs = [{k: v.cpu() for k, v in det.detect_graph(
        bridge.to_torch(tree, dev), images.to(dev), im_info.to(dev)).items()}
        for dev in ("cpu", device)]
    assert rk.roi_window_pool.launches > before
    cpu, gpu = outs
    assert cpu["kps_heatmaps"].shape == (2, 20, 56, 56, 17)
    n = 0
    for b in range(2):
        cv, gv = cpu["valid"][b], gpu["valid"][b]
        assert int(cv.sum()) == int(gv.sum()) > 0
        for i in range(int(cv.sum())):
            d = (gpu["boxes"][b][gv] - cpu["boxes"][b][cv][i]).abs().amax(1)
            j = int(d.argmin())
            assert float(d[j]) < 1e-2
            assert abs(float(gpu["scores"][b][gv][j]
                             - cpu["scores"][b][cv][i])) < 1e-4
            ref = cpu["kps_heatmaps"][b][cv][i]
            err = float((gpu["kps_heatmaps"][b][gv][j] - ref).abs().max())
            assert err <= 1e-4 * float(ref.abs().max()), (b, i, err)
            n += 1
    assert n > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,n", [(52, 84, 1024, 300), (9, 300, 64, 40)])
def test_single_level_roi_align_on_the_card(device, H, W, C, n, dtype):
    """ops/roi_align.py's K2 (one window spanning the map: the C4 res4 map
    of an 832 x 1344 canvas, 52 x 84; on a 300-cell side each RoI's own
    reach) against the plain version on the same inputs, and its K4
    backward against the plain backward: forward to 1e-5 relative in
    float32 and 2 bf16 ulps, gradient within 1e-5 max|ref| + 1e-6 (and an
    ulp of each value in bfloat16)."""
    from detectron_tpu_torch.ops import roi_align as ra

    rng = np.random.RandomState(H + W)
    feat = torch.tensor(rng.randn(2, H, W, C), dtype=dtype, device=device)
    xy = rng.uniform(-8, 16 * np.array([W, H]) * 0.9, (2, n // 2, 2))
    wh = rng.lognormal(4.5, 0.8, (2, n // 2, 2)).clip(4, 800)
    if W > 128:
        wh = wh.clip(4, 1500)
    rois = torch.tensor(np.concatenate([xy, xy + wh], -1),
                        dtype=torch.float32, device=device)
    ct = torch.tensor(rng.randn(2, n // 2, 14, 14, C), dtype=torch.float32,
                      device=device)
    pool, accum = rk.roi_window_pool.launches, rk.roi_window_accum.launches
    x = feat.clone().requires_grad_(True)
    got = ra.roi_align_batched(x, rois, 1.0 / 16, 14, 0)
    g_got, = torch.autograd.grad(got, x, ct.to(dtype))
    assert rk.roi_window_pool.launches == pool + 1
    assert rk.roi_window_accum.launches == accum + 1
    saved = ra.roi_window_pool, ra.roi_window_accum
    ra.roi_window_pool = rk.roi_window_pool_plain
    ra.roi_window_accum = rk.roi_window_accum_plain
    try:
        x = feat.clone().requires_grad_(True)
        ref = ra.roi_align_batched(x, rois, 1.0 / 16, 14, 0)
        g_ref, = torch.autograd.grad(ref, x, ct.to(dtype))
    finally:
        ra.roi_window_pool, ra.roi_window_accum = saved
    got, ref = got.detach().float(), ref.detach().float()
    top = float(ref.abs().max())
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-5 * top
    else:
        assert bool(((got - ref).abs() <= ref.abs() / 64 + 1e-3 * top).all())
    # The map gradient sums in float32 in both, then takes the feature
    # dtype: in bfloat16 an ulp of the value on top.
    g_got, g_ref = g_got.float(), g_ref.float()
    ulp = 0.0 if dtype == torch.float32 else 1.0 / 128
    assert bool(((g_got - g_ref).abs() <= ulp * g_ref.abs() + 1e-5 * float(
        g_ref.abs().max()) + 1e-6).all())


@pytest.mark.parametrize("mask_on", [False, True])
def test_c4_detect_graph_matches_cpu(device, mask_on):
    """Faster / Mask R-CNN R-50-C4 detect_graph on the card (K1, K2 with
    whole-map windows) against the CPU's plain path in float32, at tiny
    sizes: the same detections (IoU > 0.99, scores within 1e-4) and their
    masks within 1e-4."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_c4_keys
    from detectron_tpu_torch.models import bridge, init
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    config.reset_cfg()
    config.merge_cfg_from_list(mask_rcnn_r50_c4_keys(mask_on) + [
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "64",
        "TEST.DETECTIONS_PER_IM", "20"])
    config.assert_and_infer_cfg(make_immutable=False)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    tree["box_outs"]["cls_score"]["b"][1:] += 5.0
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(2, 256, 320, 3).astype(np.float32)
                              * 0.3)
    im_info = torch.tensor([[250.0, 310.0, 1.0]] * 2)
    before = rk.roi_window_pool.launches
    outs = [{k: v.cpu() for k, v in det.detect_graph(
        bridge.to_torch(tree, dev), images.to(dev), im_info.to(dev)).items()}
        for dev in ("cpu", device)]
    assert rk.roi_window_pool.launches > before
    cpu, gpu = outs
    assert ("mask_probs" in gpu) == mask_on
    n = 0
    for b in range(2):
        cv, gv = cpu["valid"][b], gpu["valid"][b]
        assert int(cv.sum()) == int(gv.sum()) > 0
        for i in range(int(cv.sum())):
            d = (gpu["boxes"][b][gv] - cpu["boxes"][b][cv][i]).abs().amax(1)
            j = int(d.argmin())
            assert float(d[j]) < 1e-2
            assert abs(float(gpu["scores"][b][gv][j]
                             - cpu["scores"][b][cv][i])) < 1e-4
            if mask_on:
                assert float((gpu["mask_probs"][b][gv][j]
                              - cpu["mask_probs"][b][cv][i]).abs().max()) \
                    < 1e-4
            n += 1
    assert n > 0


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _det_inputs(case, device):
    """K4 inputs: the ladder's sparse weights at the base window (P = 7
    and 14) and at the (128, 128) rung with P = 16 and an active row range,
    64 RoIs on one spot, windows past the canvas edges with C = 35 (the
    scalar path), and whole-map windows of a 52 x 84 map (the C4 box
    head's K4, 1024 channels)."""
    if case in ("base7", "base14", "rung128"):
        P, window, C = {"base7": (7, None, 256), "base14": (14, None, 80),
                        "rung128": (16, (128, 128), 64)}[case]
        canvas, starts, vy, vx = _ladder_pool_inputs(P + C, 60, P, window,
                                                     torch.float32, device,
                                                     C=C)
    elif case == "one_spot":
        canvas, starts, vy, vx = _ladder_pool_inputs(80, 64, 7, None,
                                                     torch.float32, device,
                                                     C=80)
        k = int((vy.ne(0).any(1).sum(1) * vx.ne(0).any(1).sum(1)).argmax())
        starts[:], vy[:], vx[:] = starts[k].clone(), vy[k].clone(), \
            vx[k].clone()
    elif case == "edges":
        canvas, starts, vy, vx = _pool_inputs(35, 12, 16, 128, 128,
                                              torch.float32, device, C=35,
                                              Hc=140, Wc=150)
        starts[:, 1] = torch.arange(12, device=device) % 4 * 70 // 3
        starts[:, 2] = torch.arange(12, device=device) // 4 * 108 // 2
    else:
        from detectron_tpu_torch.ops import roi_align as ra

        rng = np.random.RandomState(4)
        canvas = torch.zeros((2, 52, 84, 1024), device=device)
        xy = rng.uniform(-8, 16 * np.array([84, 52]) * 0.9, (200, 2))
        wh = rng.lognormal(4.5, 0.8, (200, 2)).clip(4, 800)
        rois = torch.tensor(np.concatenate([xy, xy + wh], -1),
                            dtype=torch.float32, device=device)
        vy, vx = ra.roi_weights(rois, 1.0 / 16, 14, 0, 52, 84)
        starts = torch.zeros((200, 3), dtype=torch.int32, device=device)
        starts[:, 0] = torch.arange(200, device=device) % 2
    P = vy.shape[1]
    ct = torch.randn((vy.shape[0], P, P, canvas.shape[-1]), device=device,
                     generator=torch.Generator(device).manual_seed(P))
    rows = (5, 41) if case == "rung128" else None
    return canvas, starts, ct, vy.contiguous(), vx.contiguous(), rows


@pytest.mark.parametrize("case", ["base7", "base14", "rung128", "one_spot",
                                  "edges", "c4_map"])
def test_roi_window_accum_det_repeats_its_bits(device, case):
    """Under the deterministic switch K4 runs its atomic-free variant: two
    calls on the same inputs give equal bits, within K4's tolerance (1e-5
    max|ref| + 1e-6) of the plain version; with the switch off the wrapper
    launches the atomic kernel again."""
    canvas, starts, ct, vy, vx, rows = _det_inputs(case, device)
    base = torch.randn(canvas.shape, device=device,
                       generator=torch.Generator(device).manual_seed(1))
    runs = [base.clone(), base.clone()]
    det = rk.roi_window_accum_det.launches
    atomic = rk.roi_window_accum.launches
    with _deterministic():
        for got in runs:
            assert rk.roi_window_accum(got, starts, ct, vy, vx, rows) is got
    assert rk.roi_window_accum_det.launches == det + 2
    assert rk.roi_window_accum.launches == atomic
    ref = rk.roi_window_accum_plain(base.clone(), starts, ct, vy, vx, rows)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert bool(torch.isfinite(runs[0]).all())
    assert float((runs[0] - base).abs().max()) > 0
    bound = 1e-5 * float(ref.abs().max()) + 1e-6
    assert float((runs[0] - ref).abs().max()) <= bound
    rk.roi_window_accum(base.clone(), starts, ct, vy, vx, rows)
    assert rk.roi_window_accum.launches == atomic + 1
    assert rk.roi_window_accum_det.launches == det + 2


def test_train_step_gradients_repeat_under_the_switch(device):
    """Two identical Mask R-CNN R-50-FPN training steps (tiny float32
    configuration, 2 x 128 x 160, the same params, batch and sampling
    draws) under torch.use_deterministic_algorithms give bit-equal losses
    and gradients, through the deterministic K4 (the atomic one is not
    launched); torch raises for any op of the step that has no
    deterministic implementation on the card."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_fpn
    from detectron_tpu_torch.models import bridge, init, train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import (
        calibrate_detector_params, synthetic_train_batch)

    config.reset_cfg()
    mask_rcnn_r50_fpn()
    config.merge_cfg_from_list([
        "TRAIN.BATCH_SIZE_PER_IM", "64", "TRAIN.RPN_PRE_NMS_TOP_N", "256",
        "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.RPN_BATCH_SIZE_PER_IM",
        "64", "TPU.MAX_GT_BOXES", "8", "TPU.GT_MASK_SIZE", "84"])
    config.assert_and_infer_cfg(make_immutable=False)
    params = bridge.to_torch(calibrate_detector_params(
        init.init_model(1), np.random.RandomState(1)), device)
    batch = synthetic_train_batch(2, 128, 160, device,
                                  np.random.RandomState(2), 1.0)
    batch["images"] = batch["images"] / 20.0
    draws = train_graph.make_draws(torch.Generator().manual_seed(3), 2,
                                   (128, 160), 8, device)
    det = rk.roi_window_accum_det.launches
    atomic = rk.roi_window_accum.launches
    with _deterministic():
        runs = [ts.loss_and_grads(params, batch, draws) for _ in range(2)]
    torch.cuda.synchronize()
    assert rk.roi_window_accum_det.launches > det
    assert rk.roi_window_accum.launches == atomic
    (t0, parts0, g0), (t1, parts1, g1) = runs
    assert torch.equal(t0, t1) and bool(torch.isfinite(t0))
    assert all(torch.equal(parts0[k], parts1[k]) for k in parts0)
    flat0, flat1 = opt.flatten(g0), opt.flatten(g1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flat0, flat1))
    assert any(float(a.abs().max()) > 0 for _, a in flat0)


def test_cli_resume_follows_an_uninterrupted_run_under_the_switch(
        device, tmp_path):
    """train_net_step --deterministic on the card (tiny Mask R-CNN R-50-FPN
    on a synthetic coco_2017_train of 8 images at TRAIN.SCALES 128): two
    steps, then --resume to four, end in the checkpoint of four
    uninterrupted steps bit for bit (params, momentum and step) with the
    same stats, through K4's deterministic variant only; the switch is off
    again after each run."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_fpn
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import net as net_utils

    data = str(tmp_path / "data")
    make_valset(data, 8, "train2017")

    def cli(out, steps, *flags):
        config.reset_cfg()
        mask_rcnn_r50_fpn()
        config.merge_cfg_from_list([
            "DATA_DIR", data, "OUTPUT_DIR", str(tmp_path / out),
            "NUM_GPUS", "1", "TRAIN.IMS_PER_BATCH", "2",
            "SOLVER.MAX_ITER", str(steps), "SOLVER.BASE_LR", "0.0005",
            "SOLVER.CLIP_GRADIENTS", "10", "TRAIN.SCALES", "(128,)",
            "TRAIN.MAX_SIZE", "160", "TRAIN.BATCH_SIZE_PER_IM", "64",
            "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N",
            "64", "TRAIN.RPN_BATCH_SIZE_PER_IM", "64"])
        run = train_net_step.main([
            "--dataset", "coco2017", "--bs", "2", "--nw", "2", "--device",
            "cuda", "--deterministic", "--ckpt_num_per_epoch", "1",
            "--disp_interval", "1"] + list(flags))
        assert not torch.are_deterministic_algorithms_enabled()
        return run

    det = rk.roi_window_accum_det.launches
    atomic = rk.roi_window_accum.launches
    full = cli("full", 4)
    half = cli("half", 2)
    rest = cli("rest", 4, "--load_ckpt", half["ckpt"], "--resume")
    assert rk.roi_window_accum_det.launches > det
    assert rk.roi_window_accum.launches == atomic
    assert rest["start_step"] == 2 and len(rest["stats"]) == 2
    assert all(np.isfinite(list(s.values())).all() for s in full["stats"])
    assert rest["stats"] == full["stats"][2:]
    got = net_utils.load_ckpt(rest["ckpt"])
    ref = net_utils.load_ckpt(full["ckpt"])
    assert got[0] == ref[0] == 4
    flat_got, flat_ref = opt.flatten(got[1]), opt.flatten(ref[1])
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
