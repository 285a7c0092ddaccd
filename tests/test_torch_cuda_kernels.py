"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card: K1 keep masks exactly, K2/K3 to 1e-5 relative in float32 and 2
bf16 ulps in bfloat16 (both sum in f32, in different orders; also at the
narrow ladder's base window and whole-top-level rung), K4 within
1e-5 max|ref| + 1e-6 (its atomic adds sum overlapping windows in an order
that changes from run to run), K5 exactly, K6 to 1e-5 of max|ref| in
float32 and, in bfloat16, to 2^-7 |ref| + 2^-6 max|ref| (an ulp of the
value plus 2 to 4 at the top magnitude) with under 20% of the elements
differing: the kernel and cuDNN sum in other orders, so a bf16 rounding
may fall the other way, later convs carry that on, and a residual add
that cancels keeps its operands' ulps; a systematic rounding fault would
move about half the elements. K6's float32 route runs on TF32 tensor
cores (its SASS has HMMA.1688.F32.TF32 and no FFMA loop) and is held at
the full-width res2 input and at ragged single-image shapes. Under
torch.use_deterministic_algorithms,
K4's deterministic variant (roi_window_accum_det) gives equal bits in two
calls, and two identical training steps equal gradients. The parallel
step with its ranks sharing the card over gloo (parallel/dryrun) equals
the one-process step, and NCCL runs a world of 1. The conv epilogue
(channel_epilogue) is within 1 ulp of its plain version in each form and
bit-equal on 99.9% of the elements, writes in place nothing beside its
output, and launches once at each epilogue site of a Mask R-CNN
detect_graph (R-50-FPN and R-50-C4) and only in the frozen stem and res2
of a training step. Every test skips
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
from detectron_tpu_torch.ops.cuda import channel_epilogue as ce
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


def _narrow_inputs(seed, kind, dtype, device, C=64):
    """The narrow ladder's (TPU.ROI_LADDER_NARROW) kernel inputs at the
    832 x 1344 canvas: a 2-image canvas from a random P2-P5 pyramid in its
    geometry, and window_params at its (32, 40) base window of 300 RoIs of
    detector-like sizes ("base"), or at its whole-top-level (32, 48) rung
    of the top-level RoIs among 200 large ones that rung_route sends there
    ("top_rung")."""
    rng = np.random.RandomState(seed)
    dims = [(832 // s, 1344 // s) for s in (4, 8, 16, 32)]
    scales = (0.25, 0.125, 0.0625, 0.03125)
    pyramid = [torch.tensor(rng.randn(2, h, w, C), dtype=dtype,
                            device=device) for h, w in dims]
    geom = win.ladder_geom(dims, ((32, 40), (64, 48), (16, 96), (32, 96)),
                           narrow_base=True)
    assert (geom["wx_base"], geom["fix_rungs"][0]) == (40, (32, 48))
    canvas = win.build_canvas(pyramid, geom)
    if kind == "base":
        xy = rng.uniform(0, 1000, (300, 2))
        wh = rng.lognormal(4.5, 0.8, (300, 2)).clip(4, 800)
    else:
        xy = rng.uniform(0, 300, (200, 2)) * [1.0, 0.5]
        wh = np.stack([rng.uniform(900, 1340, 200),
                       rng.uniform(300, 680, 200)], -1)
    rois = torch.tensor(np.concatenate([xy, xy + wh], 1),
                        dtype=torch.float32, device=device)
    window = (geom["wy_base"], geom["wx_base"])
    if kind == "top_rung":
        ok = win.window_params(rois, geom, scales, 7, 2, 2, 5, 224, 4,
                               *window, torch.float32)[-1]
        covered, rid = win.rung_route(rois, geom, scales, 2, 5, 224, 4)
        rois = rois[~ok & covered & (rid == 0)]
        assert 20 <= rois.shape[0]
        window = geom["fix_rungs"][0]
    sy, sx, vy, vx, _ = win.window_params(rois, geom, scales, 7, 2, 2, 5,
                                          224, 4, *window, dtype)
    img = torch.tensor(rng.randint(0, 2, rois.shape[0]), dtype=torch.int32,
                       device=device)
    return canvas, torch.stack([img, sy, sx], -1).contiguous(), vy, vx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["base", "top_rung"])
def test_narrow_ladder_shapes_match_plain(device, kind, dtype):
    """K2 at the narrow ladder's (32, 40) base window and K3 at its (32, 48)
    whole-top-level rung, against the plain version; K4 (float32) at both,
    within 1e-5 max|ref| + 1e-6."""
    canvas, starts, vy, vx = _narrow_inputs(len(kind), kind, dtype, device)
    n = vy.shape[0]
    if kind == "base":
        got = rk.roi_window_pool(canvas, starts, vy, vx)
    else:
        got = rk.roi_window_pool_seg(canvas, starts, vy, vx, (0, n))
    _close(got, rk.roi_window_pool_plain(canvas, starts, vy, vx), dtype)
    assert got.any()
    if dtype == torch.float32:
        ct = torch.randn((n, 7, 7, canvas.shape[-1]), device=device,
                         generator=torch.Generator(device).manual_seed(n))
        assert float(_accum_check(canvas, starts, ct, vy, vx).abs().max()) \
            > 0


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


def res2_stage(seed, device):
    """A random res2 stage in the bridged (OIHW) layout, random affines
    (also the CPU tests' in tests/test_torch_fused_res2_tf32.py)."""
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
                                   (1, 13, 21, 64), (2, 52, 84, 64),
                                   (2, 208, 336, 64)])
def test_fused_res2_matches_plain(device, shape, dtype):
    """Whole tiles, one tile, ragged tiles at the bottom and right edges,
    many tiles, and the full-width res2 input of an 832 x 1344 canvas."""
    folded = fk.fold_res2_weights(res2_stage(shape[1], device), dtype)
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
    folded = fk.fold_res2_weights(res2_stage(shape[2], device),
                                  torch.bfloat16)
    x = torch.tensor(np.random.RandomState(shape[1]).randn(*shape),
                     dtype=torch.bfloat16, device=device).relu()
    got = fk.fused_res2(x, folded).float()
    ref = fk.fused_res2_plain(x, folded).float()
    d = (got - ref).abs()
    top = float(ref.abs().max())
    assert bool((d <= 2.0 ** -7 * ref.abs() + 2.0 ** -6 * top).all())
    assert float((d > 0).float().mean()) < 0.2


@pytest.mark.parametrize("shape", [(1, 9, 17, 64), (1, 37, 50, 64),
                                   (1, 211, 333, 64)])
def test_fused_res2_f32_ragged_single_image(device, shape):
    """float32, one image, H and W not multiples of the f32 route's tile:
    within 1e-5 max|ref|, one launch a call."""
    folded = fk.fold_res2_weights(res2_stage(shape[2], device),
                                  torch.float32)
    x = torch.tensor(np.random.RandomState(shape[1]).randn(*shape),
                     dtype=torch.float32, device=device).relu()
    before = fk.fused_res2.launches
    got = fk.fused_res2(x, folded)
    assert fk.fused_res2.launches == before + 1
    ref = fk.fused_res2_plain(x, folded)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_fused_res2_f32_runs_on_tf32_tensor_cores(device):
    """The f32 route's SASS issues m16n8k8 TF32 tensor-core products, not
    a loop of scalar FFMAs."""
    from detectron_tpu_torch.ops.cuda import build

    got = build.sass_counts("fused_res2.cu", "fused_res2_f32_kernel",
                            ("HMMA.1688.F32.TF32", "FFMA"))
    assert got["HMMA.1688.F32.TF32"] > 0 and \
        got["FFMA"] < got["HMMA.1688.F32.TF32"], got


def test_fused_wrappers_raise_instead_of_falling_back(device):
    folded = fk.fold_res2_weights(res2_stage(0, device), torch.bfloat16)
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
                      fk.fold_res2_weights(res2_stage(0, device),
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


def _c4_weights(n, device, seed=4):
    """Whole-map windows of n RoIs on a 2 x 52 x 84 map (the C4 box head's
    K4, 1024 channels): canvas, starts (image n % 2), vy, vx."""
    from detectron_tpu_torch.ops import roi_align as ra

    rng = np.random.RandomState(seed)
    canvas = torch.zeros((2, 52, 84, 1024), device=device)
    xy = rng.uniform(-8, 16 * np.array([84, 52]) * 0.9, (n, 2))
    wh = rng.lognormal(4.5, 0.8, (n, 2)).clip(4, 800)
    rois = torch.tensor(np.concatenate([xy, xy + wh], -1),
                        dtype=torch.float32, device=device)
    vy, vx = ra.roi_weights(rois, 1.0 / 16, 14, 0, 52, 84)
    starts = torch.zeros((n, 3), dtype=torch.int32, device=device)
    starts[:, 0] = torch.arange(n, device=device) % 2
    return canvas, starts, vy, vx


def _on_one_spot(starts, vy, vx):
    """Every row takes the origin and weights of the row whose weights
    reach the most cells, in place."""
    k = int((vy.ne(0).any(1).sum(1) * vx.ne(0).any(1).sum(1)).argmax())
    starts[:], vy[:], vx[:] = starts[k].clone(), vy[k].clone(), \
        vx[k].clone()


# Rows of the one-spot cases: every row lands in one tile's list, so a
# range of 64 rows ends on the second 32-row work item's end, one of 65
# (5, 70) one row into a third, and (31, 33) is two rows.
_SPOT_ROWS = {"spot_rows_0_64": (0, 64), "spot_rows_5_70": (5, 70),
              "spot_rows_31_33": (31, 33)}


def _det_inputs(case, device):
    """K4 inputs: the ladder's sparse weights at the base window (P = 7
    and 14, also at C = 35: the scalar copies and adds) and at the (128,
    128) rung with P = 16 and an active row range, 64 RoIs on one spot
    (100 with row ranges that end on and inside a work item), windows past
    the canvas edges with C = 35, and whole-map windows of a 52 x 84 map
    (the C4 box head's K4, 1024 channels): 200 RoIs, and all 1024 rows of
    the C4 box shape on one spot (a hot tile of 32 work items)."""
    if case in ("base7", "base14", "rung128", "c35_p7", "c35_p14"):
        P, window, C = {"base7": (7, None, 256), "base14": (14, None, 80),
                        "rung128": (16, (128, 128), 64),
                        "c35_p7": (7, None, 35),
                        "c35_p14": (14, None, 35)}[case]
        canvas, starts, vy, vx = _ladder_pool_inputs(P + C, 60, P, window,
                                                     torch.float32, device,
                                                     C=C)
    elif case == "one_spot" or case in _SPOT_ROWS:
        canvas, starts, vy, vx = _ladder_pool_inputs(
            80, 64 if case == "one_spot" else 100, 7, None, torch.float32,
            device, C=80)
        _on_one_spot(starts, vy, vx)
    elif case == "edges":
        canvas, starts, vy, vx = _pool_inputs(35, 12, 16, 128, 128,
                                              torch.float32, device, C=35,
                                              Hc=140, Wc=150)
        starts[:, 1] = torch.arange(12, device=device) % 4 * 70 // 3
        starts[:, 2] = torch.arange(12, device=device) // 4 * 108 // 2
    elif case == "hot_tile":
        canvas, starts, vy, vx = _c4_weights(1024, device)
        _on_one_spot(starts, vy, vx)
    else:
        canvas, starts, vy, vx = _c4_weights(200, device)
    P = vy.shape[1]
    ct = torch.randn((vy.shape[0], P, P, canvas.shape[-1]), device=device,
                     generator=torch.Generator(device).manual_seed(P))
    rows = (5, 41) if case == "rung128" else _SPOT_ROWS.get(case)
    return canvas, starts, ct, vy.contiguous(), vx.contiguous(), rows


_DET_CASES = ["base7", "base14", "rung128", "one_spot", "edges", "c4_map",
              "hot_tile", "spot_rows_0_64", "spot_rows_5_70",
              "spot_rows_31_33", "c35_p7", "c35_p14"]


@pytest.mark.parametrize("case", _DET_CASES)
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


@pytest.mark.parametrize("case", ["image_minus_one", "zero_weights"])
def test_roi_window_accum_det_rows_reaching_nothing(device, case):
    """Rows that reach no cell (image -1, or all-zero weights) list in no
    tile: two calls leave the canvas unchanged bit for bit (negative zeros
    included), and each still counts one launch."""
    canvas, starts, ct, vy, vx, _ = _det_inputs("base7", device)
    if case == "image_minus_one":
        starts[:, 0] = -1
    else:
        vy.zero_()
    base = torch.randn(canvas.shape, device=device,
                       generator=torch.Generator(device).manual_seed(1))
    base[0, ::3] = -0.0
    got = base.clone()
    det = rk.roi_window_accum_det.launches
    for _ in range(2):
        assert rk.roi_window_accum_det(got, starts, ct, vy, vx) is got
    torch.cuda.synchronize()
    assert rk.roi_window_accum_det.launches == det + 2
    assert torch.equal(got.view(torch.int32), base.view(torch.int32))
    counts, lists = rk.roi_tile_lists(starts, vy, vx, None, canvas.shape)
    assert int(counts.sum()) == 0 and lists.numel() == 0


@pytest.mark.parametrize("case", _DET_CASES)
def test_roi_tile_lists_match_plain(device, case):
    """The deterministic K4's pre-pass gives each DET_TILE tile exactly the
    rows whose nonzero weights reach it, in increasing order
    (roi_tile_lists_plain), and counts one launch."""
    canvas, starts, _, vy, vx, rows = _det_inputs(case, device)
    before = rk.roi_tile_lists.launches
    counts, lists = rk.roi_tile_lists(starts, vy, vx, rows, canvas.shape)
    want = rk.roi_tile_lists_plain(starts, vy, vx, rows, canvas.shape,
                                   rk.DET_TILE)
    assert rk.roi_tile_lists.launches == before + 1
    assert torch.equal(counts, want[0])
    assert torch.equal(lists, want[1])
    assert lists.numel() > 0


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


def _one_process_dryrun_step(spec):
    """The dryrun spec's step in this process on cuda, cuDNN off: (stats,
    params after it in the JAX layout)."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.parallel import dryrun
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts

    dryrun.set_cfg(spec["cfg"])
    torch.backends.cudnn.enabled = False
    try:
        params = bridge.to_torch(spec["tree"], "cuda")
        new, _, stats = ts.train_step(
            params, opt.init_opt_state(params),
            {k: torch.as_tensor(v).cuda() for k, v in spec["batch"].items()},
            {k: torch.as_tensor(v).cuda() for k, v in spec["draws"].items()})
        return ({k: float(v) for k, v in stats.items()},
                bridge.to_jax_layout(new))
    finally:
        torch.backends.cudnn.enabled = True


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_ranks_on_one_card_match_one_process(device, n):
    """dryrun_multichip(n) with its ranks sharing cuda:0 over gloo (1-D at
    2, 2 data x 2 model with the box-head split at 4), float32 without
    cuDNN, against the one-process step on the same images and draws:
    losses to 1e-4 relative, params within 1e-4 of each leaf's largest
    value (the order of float sums: the box head's matmul over one or two
    images of RoIs, the sum over ranks, K4's atomics)."""
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.parallel import dryrun
    from detectron_tpu_torch.parallel import optimizer as opt

    ranks = dryrun.dryrun_multichip(n, device="cuda:0", backend="gloo",
                                    cudnn=False)
    n_data, _ = dryrun.mesh_shape(n)
    dryrun.tiny_cfg(batch=n_data)
    batch = dryrun.dryrun_batch(n_data)
    stats, ref = _one_process_dryrun_step({
        "cfg": dryrun.cfg_snapshot(), "tree": init.init_model(0),
        "batch": batch, "draws": dryrun.global_draws(1, batch)})
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)
    for k, v in stats.items():
        np.testing.assert_allclose(ranks[0]["stats"][0][k], v, rtol=1e-4,
                                   err_msg=k)
    got = dict(opt.flatten(ranks[0]["params"]))
    for path, r in opt.flatten(ref):
        assert np.abs(got[path] - r).max() <= 1e-4 * np.abs(r).max() + 1e-7, \
            path
    for r in ranks:
        assert r["launches"]["nms_keep_mask"] > 0
        assert r["launches"]["roi_window_accum"] > 0


def test_nccl_world_of_one(device):
    """NCCL on the card at a world of 1: the process group and two steps,
    each with the bucketed all-reduce of its gradient tree over the data
    group."""
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.parallel import dryrun, launch

    dryrun.tiny_cfg(batch=1)
    batch = dryrun.dryrun_batch(1)
    (got,) = launch.spawn(
        "detectron_tpu_torch.parallel.dryrun:run_rank", ["cuda:0"],
        ({"cfg": dryrun.cfg_snapshot(), "tree": init.init_model(0),
          "batch": batch, "draws": dryrun.global_draws(1, batch),
          "mesh": (1, 1), "steps": 2},), timeout_s=600)
    assert len(got["stats"]) == 2 and np.isfinite(got["stats"][1]["loss"])
    assert got["launches"]["nms_keep_mask"] > 0


# ---------------------------------------------------------------------------
# The conv epilogue (ops/cuda/channel_epilogue.py)
# ---------------------------------------------------------------------------

# Each form: (scale, shortcut (None, "identity" or "affine"), ReLU).
EPILOGUE_FORMS = {"affine": (True, None, False),
                  "affine_relu": (True, None, True),
                  "identity_shortcut": (True, "identity", True),
                  "branch1_shortcut": (True, "affine", True),
                  "bias_relu": (False, None, True)}


def _ordered(t):
    """t's bits as integers in the order of its values (bfloat16 or
    float32), so that two such integers differ by the values' distance
    in ulps (+0 and -0 both 0)."""
    if t.dtype == torch.bfloat16:
        bits, mask = t.view(torch.int16).int(), 0x7fff
    else:
        bits, mask = t.view(torch.int32).long(), 0x7fffffff
    mag = bits & mask
    return torch.where(bits < 0, -mag, mag)


def _epilogue_args(form, y, r, s, b, s_r, b_r):
    scale, shortcut, relu = EPILOGUE_FORMS[form]
    return (y, s if scale else None, b, r if shortcut else None,
            *((s_r, b_r) if shortcut == "affine" else (None, None))), relu


def _assert_within_an_ulp(got, ref, what):
    d = (_ordered(got) - _ordered(ref)).abs()
    share = float((d == 0).float().mean())
    assert int(d.max()) <= 1 and share >= 0.999, (what, int(d.max()), share)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 256, 1024, 2048, 1000])
def test_channel_epilogue_matches_plain(device, C, dtype):
    """Every form against the plain version, at a ragged shape (element
    counts no multiple of the block) and at one of more vectors than the
    grid holds threads, so the grid-stride loop turns (at C = 1000 its
    channel step is not 0): within 1 ulp, and bit-equal on 99.9% of the
    elements. In place, the result lands in y and nothing beside it, nor
    any input, changes."""
    gen = torch.Generator(device).manual_seed(C)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    s, b, s_r, b_r = randn(C, scale=0.5) + 1, randn(C), randn(C, scale=0.5) \
        + 1, randn(C)
    # The (C,) vectors in float32, in y's dtype (read as they are), and in
    # two dtypes at once (read as float32 copies).
    vector_sets = {"f32": (s, b, s_r, b_r),
                   "y's": tuple(t.to(dtype) for t in (s, b, s_r, b_r)),
                   "mixed": (s.bfloat16(), b, s_r, b_r.bfloat16())}
    for shape in ((1, 3, 5, C), (5, 37, 41, C)):
        y, r = randn(*shape, scale=4).to(dtype), randn(*shape,
                                                       scale=4).to(dtype)
        for form in EPILOGUE_FORMS:
            for vectors, vecs in vector_sets.items():
                args, relu = _epilogue_args(form, y, r, *vecs)
                before = ce.channel_epilogue.launches
                got = ce.channel_epilogue(*args, relu=relu)
                assert ce.channel_epilogue.launches == before + 1
                _assert_within_an_ulp(got, ce.channel_epilogue_plain(
                    *args, relu=relu), (form, vectors, shape))

    n = 3 * 5 * 7 * C
    buf = randn(n + 16, scale=4).to(dtype)  # 8 guard elements a side
    y = buf[8:8 + n].view(3, 5, 7, C)
    r = randn(3, 5, 7, C, scale=4).to(dtype)
    kept = [t.clone() for t in (buf, r, s, b, s_r, b_r)]
    want = ce.channel_epilogue_plain(y, s, b, r, s_r, b_r, relu=True)
    got = ce.channel_epilogue(y, s, b, r, s_r, b_r, relu=True, inplace=True)
    assert got.data_ptr() == y.data_ptr()
    _assert_within_an_ulp(y, want, "in place")
    assert torch.equal(buf[:8], kept[0][:8])
    assert torch.equal(buf[8 + n:], kept[0][8 + n:])
    for t, k in zip((r, s, b, s_r, b_r), kept[1:]):
        assert torch.equal(t, k)


def test_channel_epilogue_raises_instead_of_falling_back(device):
    y = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16, device=device)
    s = torch.ones(64, device=device)
    with pytest.raises(TypeError):
        ce.channel_epilogue(y.half(), s, s)
    with pytest.raises(ValueError):
        ce.channel_epilogue(y[..., :60].contiguous(), s[:60], s[:60])
    with pytest.raises(ValueError):
        ce.channel_epilogue(y.transpose(1, 2), s, s)
    with pytest.raises(ValueError):
        ce.channel_epilogue(y, s, s, y.float())
    with pytest.raises(ValueError):
        ce.channel_epilogue(y, s, s.cpu())
    with pytest.raises(ValueError):
        ce.channel_epilogue(y.float().requires_grad_(), s, s)
    with pytest.raises(ValueError):
        ce.channel_epilogue(y, None, s, y)


# Epilogue sites of R-50's stem and bottlenecks: the stem's affine + ReLU,
# then each block's branch2a, branch2b and branch2c (with its shortcut).
R50_BLOCKS = (3, 4, 6, 3)


def _r50_sites(stages):
    return 1 + 3 * sum(R50_BLOCKS[:stages])


@pytest.mark.parametrize("model", ["fpn", "c4"])
def test_channel_epilogue_sites(device, model):
    """A tiny seeded Mask R-CNN's detect_graph (bf16) launches the epilogue
    once at each site: R-50-FPN's body (49), its 4 lateral and 4 posthoc
    conv biases, the RPN conv at each of its 5 levels, the mask head's 4
    convs and deconv; R-50-C4's res2-res4 body (40), res5 once for the
    boxes and once for the masks (9 each), the RPN conv, the RPN's box
    deltas (4 x 12 anchors: 48 channels) and the deconv. Convs whose
    channels are no multiple of 8 (the FPN RPN's 3 logits and 12 deltas,
    C4's 12 logits, the 81 mask logits) keep the torch ops. A training
    step launches it only in the frozen stem and res2 (RESNETS.FREEZE_AT
    2): never in a stage or head that trains."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.configs_presets import (
        mask_rcnn_r50_c4_keys, mask_rcnn_r50_fpn)
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.tools import measure
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    config.reset_cfg()
    if model == "fpn":
        mask_rcnn_r50_fpn()
        sites = _r50_sites(4) + 4 + 4 + 5 + 4 + 1
    else:
        config.merge_cfg_from_list(mask_rcnn_r50_c4_keys(True))
        sites = _r50_sites(3) + 2 * 3 * R50_BLOCKS[3] + 1 + 1 + 1
    config.merge_cfg_from_list([
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "64",
        "TEST.DETECTIONS_PER_IM", "20"])
    config.assert_and_infer_cfg(make_immutable=False)
    assert config.cfg.RESNETS.FREEZE_AT == 2
    rng = np.random.RandomState(0)
    params = measure.seeded_params(device, torch.bfloat16, True, rng)
    images = torch.tensor(rng.randn(2, 256, 320, 3) * 20.0,
                          dtype=torch.bfloat16, device=device)
    im_info = torch.tensor([[250.0, 310.0, 1.0]] * 2, device=device)
    before = ce.channel_epilogue.launches
    det.detect_graph(params, images, im_info)
    assert ce.channel_epilogue.launches - before == sites

    params = measure.seeded_params(device, torch.bfloat16, False, rng)
    batch = synthetic_train_batch(1, 128, 160, device, rng)
    draws = train_graph.make_draws(torch.Generator().manual_seed(1), 1,
                                   (128, 160), config.cfg.TPU.MAX_GT_BOXES,
                                   device)
    before = ce.channel_epilogue.launches
    ts.train_step(params, opt.init_opt_state(params), batch, draws)
    assert ce.channel_epilogue.launches - before == _r50_sites(1)
