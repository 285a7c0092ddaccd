"""Kernel K1 (batched greedy NMS keep mask) of the PyTorch port against the
JAX package: the port's plain version vs the Pallas nms_keep_mask run in
interpret mode, and the port's two NMS forms vs detectron_tpu/ops/nms.py.
Keep masks must agree exactly: both sides evaluate the IoU op by op in f32
in the same order. The CUDA kernel itself is checked against the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import nms as jax_nms
from detectron_tpu.ops.pallas import nms_kernel as jax_nms_kernel
from detectron_tpu_torch.ops import nms as port_nms
from detectron_tpu_torch.ops.cuda import nms_kernel as port_nms_kernel

torch.set_num_threads(2)


def _lanes(seed, L, N, hole_frac=0.0, dup_frac=0.0, size=200.0):
    """L lanes of N score-descending boxes: valid (L, N) with -inf holes
    mid-lane and a tail of invalid slots; some lanes repeat boxes
    exactly."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, size, (L, N))
    y1 = rng.uniform(0, size, (L, N))
    w = rng.uniform(4, 60, (L, N))
    h = rng.uniform(4, 60, (L, N))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    if dup_frac:
        dup = rng.rand(L, N) < dup_frac
        src = np.maximum(np.arange(N)[None, :] - 1, 0)
        prev = np.take_along_axis(boxes, np.broadcast_to(
            src[..., None], (L, N, 4)), axis=1)
        boxes = np.where(dup[..., None], prev, boxes)
    scores = -np.sort(-rng.rand(L, N), axis=1).astype(np.float32)
    holes = rng.rand(L, N) < hole_frac
    scores[holes] = -np.inf
    n_valid = rng.randint(N // 2, N + 1, L)
    scores[np.arange(N)[None, :] >= n_valid[:, None]] = -np.inf
    return boxes, scores


CASES = [
    # (L, N, hole_frac, dup_frac, thr)
    (8, 64, 0.0, 0.0, 0.5),
    (5, 64, 0.2, 0.0, 0.7),     # L not a multiple of 8, -inf holes
    (3, 400, 0.1, 0.3, 0.5),    # equal boxes
    (13, 400, 0.0, 0.0, 0.3),
    (2, 1000, 0.05, 0.1, 0.7),  # RPN level lane shape
]


@pytest.mark.parametrize("L,N,hole,dup,thr", CASES)
def test_keep_mask_plain_matches_pallas(L, N, hole, dup, thr):
    boxes, scores = _lanes(L * 1000 + N, L, N, hole, dup)
    valid = np.isfinite(scores)
    lanes = 8 if N >= 512 else 16
    pad = (-L) % lanes
    ref = np.asarray(jax_nms_kernel.nms_keep_mask(
        jnp.asarray(np.pad(boxes, ((0, pad), (0, 0), (0, 0)))),
        jnp.asarray(np.pad(valid, ((0, pad), (0, 0)))), thr,
        lanes_per_step=lanes, interpret=True))[:L]
    got = port_nms_kernel.nms_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got[~valid].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,N,hole,dup,thr", CASES[:4])
def test_nms_forms_match_jax(L, N, hole, dup, thr, dtype):
    """Keep-mask form and compacted form (max_output_size < N) vs
    detectron_tpu/ops/nms.py on its Pallas route. bf16 boxes and scores:
    both sides cast boxes to f32 before the IoU, so keep masks stay exact
    (bf16-rounded inputs make equal boxes and scores more frequent)."""
    boxes, scores = _lanes(L * 7 + N, L, N, hole, dup)
    jb = jnp.asarray(boxes, getattr(jnp, dtype))
    js = jnp.asarray(scores, getattr(jnp, dtype))
    tb = torch.from_numpy(boxes).to(getattr(torch, dtype))
    ts = torch.from_numpy(scores).to(getattr(torch, dtype))

    ref_keep = np.asarray(jax_nms.nms_batched_sorted_mask(jb, js, thr))
    np.testing.assert_array_equal(
        port_nms.nms_batched_sorted_mask(tb, ts, thr).numpy(), ref_keep)

    K = N // 4
    ref_idx, ref_valid = jax_nms.nms_batched_sorted(jb, js, thr, K)
    idx, valid = port_nms.nms_batched_sorted(tb, ts, thr, K)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_keep_mask_edge_cases():
    """Empty lanes, a lane of one valid box, and a lane whose only valid
    boxes sit after a run of holes."""
    boxes, scores = _lanes(3, 4, 32)
    scores[0] = -np.inf
    scores[1, 1:] = -np.inf
    scores[2, :20] = -np.inf
    valid = np.isfinite(scores)
    ref = np.asarray(jax_nms_kernel.nms_keep_mask(
        jnp.asarray(np.pad(boxes, ((0, 12), (0, 0), (0, 0)))),
        jnp.asarray(np.pad(valid, ((0, 12), (0, 0)))), 0.5,
        lanes_per_step=16, interpret=True))[:4]
    got = port_nms_kernel.nms_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[0].any() and got[1, 0] and got[2, 20:].any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """On a non-CPU device the wrapper never falls back to the plain
    version: mixed devices raise before any launch."""
    boxes = torch.zeros((2, 8, 4))
    valid = torch.ones((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        port_nms_kernel.nms_keep_mask(boxes, valid, 0.5)
