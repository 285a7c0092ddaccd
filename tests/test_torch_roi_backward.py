"""The RoIAlign backward of the PyTorch port against the JAX package.

- Kernel K4's plain version (roi_window_accum_plain, behind the wrapper
  for CPU tensors) vs the Pallas roi_window_accum_seg in interpret mode, on
  the inputs of tests/test_roi_ladder.py::test_accum_kernel_is_window_pool_
  transpose (overlapping windows, an active row range, the empty range).
  Both sum in f32 in different orders: 1e-5 relative.
- The ladder's autograd gradient (windowed_roi.
  multilevel_roi_align_ladder_trainable) vs jax.vjp of the JAX ladder's
  custom_vjp (Pallas interpret mode), on RoIs that take the base window,
  each fix-up rung and the exact-gather slivers, at pooled 7 and 14 and in
  a ladder with no fix-up rungs: per level, max|diff| <= 1e-4 max|ref|.
- torch.autograd.gradcheck in float64: the backward is the transpose of
  the forward (fully on a tiny pyramid, by random projections on one that
  drives every route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import windowed_roi as jax_win
from detectron_tpu.ops.pallas import roi_align_kernel as jax_rk
from detectron_tpu_torch.ops import windowed_roi as port_win
from detectron_tpu_torch.ops.cuda import roi_align_kernel as port_rk
from test_torch_roi_align import DIMS, RUNGS, SCALES, _rois

torch.set_num_threads(2)


def _accum_inputs(seed):
    rng = np.random.RandomState(seed)
    B, Hc, Wc, C = 2, 32, 40, 8
    WY, WX, P, N = 8, 16, 7, 16
    starts = np.stack([rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
                       rng.randint(0, (Wc - WX) // 8 + 1, N) * 8],
                      1).astype(np.int32)
    vy = rng.randn(N, P, WY).astype(np.float32)
    vx = rng.randn(N, P, WX).astype(np.float32)
    ct = rng.randn(N, P, P, C).astype(np.float32)
    base = rng.randn(B, Hc, Wc, C).astype(np.float32)
    return base, starts, ct, vy, vx


@pytest.mark.parametrize("steps", [(0, 2), (1, 2), (0, 0)])
def test_accum_plain_matches_pallas(steps):
    """J = 8 rows per Pallas step; steps [lo, hi) are rows [8 lo, 8 hi)."""
    base, starts, ct, vy, vx = _accum_inputs(0)
    WY, WX, P = vy.shape[2], vx.shape[2], vy.shape[1]
    ref = np.asarray(jax_rk.roi_window_accum_seg(
        jnp.asarray(base), jnp.asarray(steps, jnp.int32), jnp.asarray(starts),
        jnp.asarray(ct), jnp.asarray(vy), jnp.asarray(vx), WY, WX, P,
        rois_per_step=8, interpret=True))
    got = torch.from_numpy(base.copy())
    out = port_rk.roi_window_accum(
        got, torch.from_numpy(starts), torch.from_numpy(ct),
        torch.from_numpy(vy), torch.from_numpy(vx),
        rows=(8 * steps[0], 8 * steps[1]))
    assert out is got
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    if steps == (0, 0):
        np.testing.assert_array_equal(got.numpy(), base)


def test_accum_plain_drops_cells_past_the_canvas():
    """A window hanging over the canvas edge adds only its inside cells."""
    base, starts, ct, vy, vx = _accum_inputs(1)
    starts[:, 1] = 30   # 8-row windows from row 30 of 32
    got = port_rk.roi_window_accum_plain(
        torch.zeros(base.shape), torch.from_numpy(starts),
        torch.from_numpy(ct), torch.from_numpy(vy), torch.from_numpy(vx))
    full = port_rk.roi_window_accum_plain(
        torch.zeros((2, 40, 40, 8)), torch.from_numpy(starts),
        torch.from_numpy(ct), torch.from_numpy(vy), torch.from_numpy(vx))
    torch.testing.assert_close(got, full[:, :32], rtol=0, atol=0)


def _jax_grads(pyr, rois, ct, pooled, rungs):
    def f(p):
        return jax_win.multilevel_roi_align_ladder_trainable(
            p, SCALES, jnp.asarray(rois), pooled, 2, 2, 5, 224, 4, rungs, 8,
            True, False, False)

    _, vjp = jax.vjp(f, [jnp.asarray(x) for x in pyr])
    return [np.asarray(g) for g in vjp(jnp.asarray(ct))[0]]


def _port_grads(pyr, rois, ct, pooled, rungs, dtype=torch.float32):
    tp = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in pyr]
    out = port_win.multilevel_roi_align_ladder_trainable(
        tp, SCALES, torch.from_numpy(rois), pooled, 2, 2, 5, 224, 4, rungs)
    return torch.autograd.grad(out, tp, torch.from_numpy(ct).to(dtype))


@pytest.mark.parametrize("pooled,rungs", [(7, RUNGS), (14, RUNGS),
                                          (7, RUNGS[:1])])
def test_ladder_gradient_matches_jax_vjp(pooled, rungs):
    rng = np.random.RandomState(pooled + len(rungs))
    B, C = 2, 4
    pyr = [rng.randn(B, h, w, C).astype(np.float32) for h, w in DIMS]
    rois = _rois(B)
    ct = rng.randn(B, rois.shape[1], pooled, pooled, C).astype(np.float32)
    if len(rungs) > 1:
        # Every route is taken: base, two or more fix-up rungs, slivers.
        geom = port_win.ladder_geom(list(DIMS), rungs)
        flat = torch.from_numpy(rois).reshape(-1, 4)
        *_, ok = port_win.window_params(
            flat, geom, SCALES, pooled, 2, 2, 5, 224, 4, geom["wy_base"],
            geom["wx_base"], torch.float32)
        covered, rid = port_win.rung_route(flat, geom, SCALES, 2, 5, 224, 4)
        assert ok.any() and (~ok & ~covered).any()
        assert len(set(rid[~ok & covered].tolist())) >= 2
    ref = _jax_grads(pyr, rois, ct, pooled, rungs)
    got = _port_grads(pyr, rois, ct, pooled, rungs)
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and g.shape == r.shape, lvl
        scale = np.abs(r).max()
        assert scale > 0, lvl
        np.testing.assert_array_less(np.abs(g.numpy() - r).max(),
                                     1e-4 * scale, err_msg=str(lvl))


def test_ladder_gradient_bf16_pyramid():
    """A bf16 pyramid gets a bf16 gradient, computed in f32 with f32
    weights and rounded once: within 1 bf16 ulp of the f32 gradient of the
    same cotangent."""
    rng = np.random.RandomState(5)
    pyr = [rng.randn(2, h, w, 4).astype(np.float32) for h, w in DIMS]
    rois = _rois(2)
    # A bf16 output takes a bf16 cotangent: both runs get the same values.
    ct = torch.randn((2, rois.shape[1], 7, 7, 4), generator=torch.Generator(
        ).manual_seed(0)).to(torch.bfloat16).float().numpy()
    ref = _port_grads(pyr, rois, ct, 7, RUNGS)
    got = _port_grads(pyr, rois, ct, 7, RUNGS, torch.bfloat16)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r, rtol=1.0 / 128,
                                   atol=1e-6 * float(r.abs().max()))


def _gradcheck(pyr, rois, pooled, rungs, fast):
    tp = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in pyr]
    trois = torch.from_numpy(rois)

    def f(*p):
        return port_win.multilevel_roi_align_ladder_trainable(
            list(p), SCALES, trois, pooled, 2, 2, 5, 224, 4, rungs)

    assert torch.autograd.gradcheck(f, tp, fast_mode=fast, atol=1e-9,
                                    rtol=1e-7)


def test_ladder_gradcheck_float64():
    rng = np.random.RandomState(7)
    tiny = [rng.randn(1, h // 8, w // 8, 1) for h, w in DIMS]
    rois = np.array([[[4.0, 6.0, 60.0, 40.0], [10.0, 3.0, 200.0, 90.0],
                      [0.0, 0.0, 150.0, 120.0]]], np.float32)
    _gradcheck(tiny, rois, 2, RUNGS, fast=False)
    full = [rng.randn(1, h, w, 2) for h, w in DIMS]
    _gradcheck(full, _rois(2)[:1], 3, RUNGS, fast=True)
