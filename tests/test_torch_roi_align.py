"""Kernels K2/K3 (windowed RoIAlign pooling) and the window-rung ladder of
the PyTorch port against the JAX package.

- The plain version behind K2/K3 vs the Pallas roi_window_pool and
  roi_window_pool_seg (interpret mode) on the same canvas, origins and
  weights, at pooled 7 and 14. Both sum in f32 in different orders:
  f32 agrees to 1e-5 relative; bf16 to 2 bf16 ulps (1/64 relative).
- The port's ladder vs JAX's ladder (multilevel_roi_align_pallas_ladder and
  model_builder.roi_feature_transform) and vs the exact gather RoIAlign,
  on moderate, elongated (fix-up rung) and sliver (exact gather) RoIs.
The CUDA kernels are checked against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import multilevel_roi as jax_ml
from detectron_tpu.ops import windowed_roi as jax_win
from detectron_tpu.ops.pallas import roi_align_kernel as jax_rk
from detectron_tpu_torch.ops import multilevel_roi as port_ml
from detectron_tpu_torch.ops import windowed_roi as port_win
from detectron_tpu_torch.ops.cuda import roi_align_kernel as port_rk

torch.set_num_threads(2)

RUNGS = ((32, 40), (64, 48), (16, 96), (32, 96))
# Level shapes and scales of an 832 x 1344 canvas at strides 8..64, with
# few channels: wide enough that slivers escape every rung.
DIMS = ((104, 168), (52, 84), (26, 42), (13, 21))
SCALES = (0.125, 0.0625, 0.03125, 0.015625)


def _tol(dtype):
    return (1e-5, 1e-5) if dtype == "float32" else (1.0 / 64, 1e-3)


def _window_inputs(seed, N, P, WY, WX, dtype, C=16, B=2):
    rng = np.random.RandomState(seed)
    Hc, Wc = 96, 160
    canvas = rng.randn(B, Hc, Wc, C).astype(np.float32)
    starts = np.stack([rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
                       rng.randint(0, (Wc - WX) // 8 + 1, N) * 8],
                      -1).astype(np.int32)
    vy = rng.rand(N, P, WY).astype(np.float32)
    vx = rng.rand(N, P, WX).astype(np.float32)
    vy[vy < 0.6] = 0.0
    vx[vx < 0.6] = 0.0
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    jax_in = [jnp.asarray(a, jd) for a in (canvas, vy, vx)]
    port_in = [torch.from_numpy(a).to(td) for a in (canvas, vy, vx)]
    return jax_in, port_in, starts


def _close(got, ref, dtype):
    rtol, atol = _tol(dtype)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,WY,WX", [(7, 32, 48), (14, 32, 48)])
def test_window_pool_plain_matches_pallas(P, WY, WX, dtype):
    (jc, jvy, jvx), (tc, tvy, tvx), starts = _window_inputs(
        P * 10 + len(dtype), 16, P, WY, WX, dtype)
    ref = jax_rk.roi_window_pool(jc, jnp.asarray(starts), jvy, jvx, WY, WX,
                                 P, rois_per_step=8, interpret=True)
    got = port_rk.roi_window_pool(tc, torch.from_numpy(starts), tvy, tvx)
    assert got.dtype == tc.dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,WY,WX,count", [(7, 64, 48, 11), (7, 16, 96, 5),
                                           (14, 32, 96, 9)])
def test_window_pool_seg_plain_matches_pallas(P, WY, WX, count, dtype):
    """Fix-up rung shapes: only the first `count` rows of a 16-row
    capacity are active."""
    (jc, jvy, jvx), (tc, tvy, tvx), starts = _window_inputs(
        WY + WX + count, 16, P, WY, WX, dtype)
    J = 8
    seg = jnp.asarray([0, -(-count // J)], jnp.int32)
    ref = jax_rk.roi_window_pool_seg(jc, seg, jnp.asarray(starts), jvy, jvx,
                                     WY, WX, P, rois_per_step=J,
                                     interpret=True)
    got = port_rk.roi_window_pool_seg(tc, torch.from_numpy(starts), tvy,
                                      tvx, (0, count))
    _close(got[:count], np.asarray(jnp.asarray(ref[:count], jnp.float32)),
           dtype)


def _box(s, aspect, x, y):
    w = s * np.sqrt(aspect)
    return [x, y, x + w, y + s / np.sqrt(aspect)]


def _rois(B):
    rows = [_box(s, a, 30.0, 20.0) for s in (120.0, 300.0, 440.0)
            for a in (1.0, 0.5, 2.0)]
    rows += [_box(400.0, 4.0, 40.0, 60.0), _box(400.0, 0.25, 200.0, 10.0),
             _box(900.0, 1.0, 0.0, 0.0), _box(360.0, 8.0, 10.0, 300.0),
             _box(250.0, 1.0, 200.0, 300.0), [50.0, 100.0, 650.0, 140.0],
             [300.0, 50.0, 340.0, 650.0], [60.0, 600.0, 760.0, 650.0],
             [8.0, 500.0, 1100.0, 509.0],
             [100.0, 40.0, 110.0, 800.0], [600.0, 700.0, 1300.0, 706.0]]
    rois = np.array([rows] * B, np.float32)
    rois[1] = rois[1][::-1]
    return rois


def _pyramid(rng, B, dtype, C=4):
    return [rng.randn(B, h, w, C).astype(np.float32) for h, w in DIMS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooled", [7, 14])
def test_ladder_matches_jax_and_exact_gather(pooled, dtype):
    rng = np.random.RandomState(pooled)
    B = 2
    pyr = _pyramid(rng, B, dtype)
    rois = _rois(B)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    tpyr = [torch.from_numpy(f).to(td) for f in pyr]
    trois = torch.from_numpy(rois)

    # The rois exercise every route: base, each kind of fix-up, slivers.
    geom = port_win.ladder_geom(list(DIMS), RUNGS)
    flat = trois.reshape(-1, 4)
    *_, ok = port_win.window_params(flat, geom, SCALES, pooled, 2, 2, 5,
                                    224, 4, geom["wy_base"], geom["wx_base"],
                                    td)
    covered, rid = port_win.rung_route(flat, geom, SCALES, 2, 5, 224, 4)
    assert ok.any() and (~ok & covered).any() and (~ok & ~covered).any()
    assert len(set(rid[~ok & covered].tolist())) >= 2

    got = port_win.multilevel_roi_align_ladder(
        tpyr, SCALES, trois, pooled, 2, 2, 5, 224, 4, RUNGS)
    assert got.shape == (B, rois.shape[1], pooled, pooled, 4)
    ref = jax_win.multilevel_roi_align_pallas_ladder(
        [jnp.asarray(f, jd) for f in pyr], SCALES, jnp.asarray(rois), pooled,
        2, 2, 5, canonical_scale=224, canonical_level=4, rungs=RUNGS,
        interpret=True)
    _close(got, ref, dtype)

    if dtype == "float32":
        exact = np.stack([np.asarray(jax_ml.multilevel_roi_align(
            [jnp.asarray(f[b]) for f in pyr], SCALES, jnp.asarray(rois[b]),
            pooled, 2, 2, 5, chunk=8)) for b in range(B)])
        _close(got, exact, dtype)
        port_exact = torch.stack([port_ml.multilevel_roi_align(
            [f[b] for f in tpyr], SCALES, trois[b], pooled, 2, 2, 5)
            for b in range(B)])
        _close(port_exact, exact, dtype)


def test_roi_feature_transform_matches_jax():
    """model_builder.roi_feature_transform (FPN, pallas ladder default) of
    both packages on the tiny cfg's pyramid geometry."""
    from detectron_tpu.models import model_builder as jax_mb
    from detectron_tpu_torch.models import model_builder as port_mb
    from test_torch_util import set_cfgs

    set_cfgs()
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 256 // s, 320 // s, 8).astype(np.float32)
             for s in (4, 8, 16, 32, 64)]
    scales = [1.0 / s for s in (4, 8, 16, 32, 64)]
    xy = rng.uniform(0, 250, (2, 24, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 200, (2, 24, 2))],
                          -1).astype(np.float32)
    ref = jax_mb.roi_feature_transform(
        None, [jnp.asarray(f) for f in feats], scales, jnp.asarray(rois), 7,
        2)
    got = port_mb.roi_feature_transform(
        [torch.from_numpy(f) for f in feats], scales, torch.from_numpy(rois),
        7, 2)
    _close(got, ref, "float32")


# The levels of an 832 x 1344 canvas at strides 4..32 (P2-P5): P4 is 84
# wide, and its windows are 48 wide, so 84 - 48 is not a multiple of
# ALIGN_X.
CANVAS_DIMS = ((208, 336), (104, 168), (52, 84), (26, 42))
CANVAS_SCALES = (0.25, 0.125, 0.0625, 0.03125)


def test_ladder_right_edge_of_p4_matches_exact_gather():
    """RoIs at P4's right edge, one routed to the base window and one to
    the (64, 48) fix-up rung, against the JAX package's exact gather
    RoIAlign (the JAX ladder rounds the window bound down and misses
    P4's last columns, so it is no reference here)."""
    pooled, B = 7, 1
    rng = np.random.RandomState(3)
    pyr = [rng.randn(B, h, w, 4).astype(np.float32) for h, w in CANVAS_DIMS]
    # 300 x 300 fits the base window (32, 48) at P4; 180 x 700 (level 4 by
    # its area) is too tall for it and fits the (64, 48) rung.
    rois = np.array([[[1043.0, 100.0, 1343.0, 400.0],
                      [1163.0, 50.0, 1343.0, 750.0],
                      [1050.0, 500.0, 1339.5, 790.0]]], np.float32)
    tpyr = [torch.from_numpy(f) for f in pyr]
    trois = torch.from_numpy(rois)

    geom = port_win.ladder_geom(list(CANVAS_DIMS), RUNGS)
    assert (geom["wy_base"], geom["wx_base"]) == (32, 48)
    flat = trois.reshape(-1, 4)
    lvl = port_ml.roi_levels(flat, 2, 5, 224, 4)
    assert lvl.tolist() == [4, 4, 4]
    *_, ok = port_win.window_params(flat, geom, CANVAS_SCALES, pooled, 2, 2,
                                    5, 224, 4, geom["wy_base"],
                                    geom["wx_base"], torch.float32)
    covered, rid = port_win.rung_route(flat, geom, CANVAS_SCALES, 2, 5, 224,
                                       4)
    assert ok.tolist() == [True, False, True]
    assert bool(covered[1]) and geom["fix_rungs"][int(rid[1])] == (64, 48)

    got = port_win.multilevel_roi_align_ladder(
        tpyr, CANVAS_SCALES, trois, pooled, 2, 2, 5, 224, 4, RUNGS)
    exact = np.asarray(jax_ml.multilevel_roi_align(
        [jnp.asarray(f[0]) for f in pyr], CANVAS_SCALES,
        jnp.asarray(rois[0]), pooled, 2, 2, 5, chunk=8))[None]
    _close(got, exact, "float32")
