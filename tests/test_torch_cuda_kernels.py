"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card: K1 keep masks exactly, K2/K3 to 1e-5 relative in float32 and 2
bf16 ulps in bfloat16 (both sum in f32, in different orders), K4 within
1e-5 max|ref| + 1e-6 (its atomic adds sum overlapping windows in an order
that changes from run to run). Every test skips where no CUDA device is
present. On a machine with an NVIDIA GPU (no
JAX needed, so without the suite's conftest):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from detectron_tpu_torch.ops.cuda import nms_kernel
from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
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
                                     (4, 2048, 0.3)])
def test_nms_keep_mask_matches_plain(device, L, N, thr):
    boxes, valid = _lanes(L + N, L, N, device)
    before = nms_kernel.nms_keep_mask.launches
    got = nms_kernel.nms_keep_mask(boxes, valid, thr)
    assert nms_kernel.nms_keep_mask.launches == before + 1
    ref = nms_kernel.nms_keep_mask_plain(boxes, valid, thr)
    assert torch.equal(got, ref)


def _pool_inputs(seed, N, P, WY, WX, dtype, device, C=80):
    rng = np.random.RandomState(seed)
    B, Hc, Wc = 2, 120, 200
    canvas = torch.tensor(rng.randn(B, Hc, Wc, C), dtype=dtype,
                          device=device)
    starts = torch.tensor(np.stack(
        [rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
         rng.randint(0, Wc - WX + 1, N)], -1), dtype=torch.int32,
        device=device)
    vy = torch.tensor(rng.rand(N, P, WY), dtype=dtype, device=device)
    vx = torch.tensor(rng.rand(N, P, WX), dtype=dtype, device=device)
    return canvas, starts, vy, vx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,WY,WX,rows", [(7, 32, 48, None),
                                          (14, 32, 48, None),
                                          (7, 64, 48, (3, 17)),
                                          (14, 16, 96, (0, 5))])
def test_roi_window_pool_matches_plain(device, P, WY, WX, rows, dtype):
    args = _pool_inputs(P + WY, 24, P, WY, WX, dtype, device)
    if rows is None:
        got = rk.roi_window_pool(*args)
        ref = rk.roi_window_pool_plain(*args)
        rows = (0, 24)
    else:
        got = rk.roi_window_pool_seg(*args, rows)
        ref = rk.roi_window_pool_plain(*args, rows=rows)
    got = got[rows[0]:rows[1]].float()
    ref = ref[rows[0]:rows[1]].float()
    rtol = 1e-5 if dtype == torch.float32 else 1.0 / 64
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max()))


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
        nms_kernel.nms_keep_mask(boxes, valid, 0.5)
    with pytest.raises(TypeError):
        nms_kernel.nms_keep_mask(boxes.double(), valid, 0.5)
