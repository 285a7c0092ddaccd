"""The contract of the deterministic K4's pre-pass, on the CPU.

roi_window_accum_det (csrc/roi_window_accum_det.cu) lists, for every
(image, canvas tile), the RoI rows whose nonzero weights reach the tile, in
increasing order, and adds each tile's list in that order.
roi_tile_lists_plain states that contract in plain PyTorch (the card tests
hold the kernel's lists to it); here it is held against a brute-force loop
over the nonzero cells of vy x vx: windows past the canvas edge, rows that
reach nothing (image -1, a negative origin, all-zero weights), an active
row range, the ladder's sparse weights, at the kernel's tile (DET_TILE) and
at two other tile shapes. The lists are exact (integers). Then the plain
accumulate, row by row, adds nothing to a tile outside the rows listed for
it, and the variant's CPU route (its plain version) matches the Pallas
roi_window_accum_seg in interpret mode within 1e-5 relative, as K4's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops.pallas import roi_align_kernel as jax_rk
from detectron_tpu_torch.ops import windowed_roi as win
from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

torch.set_num_threads(2)

CANVAS = (2, 37, 53, 4)   # B, Hc, Wc, C: neither side a multiple of a tile
TILES = [rk.DET_TILE, (8, 8), (4, 32)]


def _brute(starts, vy, vx, rows, canvas_shape, tile):
    """Each (image, tile) with the sorted rows of [lo, hi) that reach it,
    from a loop over the nonzero (vy, vx) cell pairs of each row."""
    B, Hc, Wc = canvas_shape[:3]
    th, tw = tile
    lo, hi = rows if rows is not None else (0, len(starts))
    tiles = {}
    for n in range(lo, hi):
        b, y0, x0 = (int(v) for v in starts[n])
        if not (0 <= b < B and y0 >= 0 and x0 >= 0):
            continue
        for _, h in zip(*np.nonzero(vy[n])):
            for _, w in zip(*np.nonzero(vx[n])):
                y, x = y0 + h, x0 + w
                if y < Hc and x < Wc:
                    tiles.setdefault((b, y // th, x // tw), set()).add(n)
    counts = np.zeros((B, -(-Hc // th), -(-Wc // tw)), np.int32)
    lists = []
    for key in sorted(tiles):
        counts[key] = len(tiles[key])
        lists += sorted(tiles[key])
    return counts, np.asarray(lists, np.int64)


def _inputs(case, seed=0):
    """(starts, vy, vx, rows) of 24 rows, P = 5, window (12, 20)."""
    rng = np.random.RandomState(seed)
    B, Hc, Wc, _ = CANVAS
    N, P, WY, WX = 24, 5, 12, 20
    starts = np.stack([rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
                       rng.randint(0, Wc - WX + 1, N)], 1)
    vy = rng.rand(N, P, WY) * (rng.rand(N, P, WY) < 0.15)
    vx = rng.rand(N, P, WX) * (rng.rand(N, P, WX) < 0.15)
    rows = None
    if case == "past_edge":
        # Origins up to the last cell: windows hang over both far edges.
        starts[:, 1] = rng.randint(Hc - WY, Hc, N)
        starts[:, 2] = rng.randint(Wc - WX, Wc, N)
        vy[:, :, -2:] = 0.5
        vx[:, :, -2:] = 0.5
    elif case == "empty_rows":
        starts[0::6, 0] = -1
        starts[1::6, 0] = B            # past the last image
        starts[2::12, 1] = -3          # a negative origin
        vy[3::6] = 0.0                 # no weight reaches a row
        vx[4::12] = 0.0
    elif case == "row_range":
        rows = (3, 17)
    elif case == "dense":
        vy = rng.rand(N, P, WY)
        vx = rng.rand(N, P, WX)
    return (torch.tensor(starts, dtype=torch.int32),
            torch.tensor(vy, dtype=torch.float32),
            torch.tensor(vx, dtype=torch.float32), rows)


def _ladder_inputs(seed=3, n=40):
    """The ladder's sparse weights at the base window (P = 7) on a 2-image
    canvas of a 128 x 160 image's pyramid, as the main path makes them."""
    rng = np.random.RandomState(seed)
    dims = [(128 // s, 160 // s) for s in (4, 8, 16, 32)]
    geom = win.ladder_geom(dims, ((32, 40), (64, 48), (16, 96), (32, 96)))
    pyramid = [torch.zeros((2, h, w, 4)) for h, w in dims]
    canvas = win.build_canvas(pyramid, geom)
    xy = rng.uniform(0, 140, (n, 2))
    wh = rng.lognormal(3.0, 0.8, (n, 2)).clip(2, 150)
    rois = torch.tensor(np.concatenate([xy, xy + wh], 1),
                        dtype=torch.float32)
    sy, sx, vy, vx, _ = win.window_params(
        rois, geom, (0.25, 0.125, 0.0625, 0.03125), 7, 2, 2, 5, 224, 4,
        geom["wy_base"], geom["wx_base"], torch.float32)
    img = torch.tensor(rng.randint(0, 2, n), dtype=torch.int32)
    return (tuple(canvas.shape), torch.stack([img, sy, sx], -1).contiguous(),
            vy.contiguous(), vx.contiguous())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", ["past_edge", "empty_rows", "row_range",
                                  "dense"])
def test_plain_lists_match_brute_force(case, tile):
    starts, vy, vx, rows = _inputs(case)
    counts, lists = rk.roi_tile_lists_plain(starts, vy, vx, rows, CANVAS,
                                            tile)
    want_counts, want_lists = _brute(starts.numpy(), vy.numpy(), vx.numpy(),
                                     rows, CANVAS, tile)
    assert counts.dtype == torch.int32 and lists.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(lists.numpy(), want_lists)
    assert int(counts.sum()) == lists.numel() > 0
    # Each tile's segment is increasing.
    ends = np.cumsum(counts.numpy().ravel())
    for s, e in zip(np.concatenate([[0], ends[:-1]]), ends):
        assert np.all(np.diff(lists.numpy()[s:e]) > 0)


@pytest.mark.parametrize("tile", TILES)
def test_plain_lists_on_ladder_weights(tile):
    canvas_shape, starts, vy, vx = _ladder_inputs()
    for rows in (None, (7, 29)):
        counts, lists = rk.roi_tile_lists_plain(starts, vy, vx, rows,
                                                canvas_shape, tile)
        want = _brute(starts.numpy(), vy.numpy(), vx.numpy(), rows,
                      canvas_shape, tile)
        np.testing.assert_array_equal(counts.numpy(), want[0])
        np.testing.assert_array_equal(lists.numpy(), want[1])


def test_empty_range_lists_nothing():
    starts, vy, vx, _ = _inputs("dense")
    counts, lists = rk.roi_tile_lists_plain(starts, vy, vx, (9, 9), CANVAS,
                                            rk.DET_TILE)
    assert counts.shape == (2, 5, 4) and int(counts.sum()) == 0
    assert lists.numel() == 0


def test_cpu_lists_take_the_plain_version_at_the_kernel_tile():
    starts, vy, vx, rows = _inputs("row_range")
    got = rk.roi_tile_lists(starts, vy, vx, rows, CANVAS)
    want = rk.roi_tile_lists_plain(starts, vy, vx, rows, CANVAS, rk.DET_TILE)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["ladder", "past_edge", "empty_rows"])
def test_rows_left_off_a_list_add_nothing_there(case):
    """The plain accumulate of each row alone changes canvas cells only in
    the tiles whose lists hold the row: the lists miss no term. (Rows with
    an image outside the canvas or a negative origin, which the kernels
    skip, would index the plain version's canvas from its end.)"""
    if case == "ladder":
        canvas_shape, starts, vy, vx = _ladder_inputs()
        rows = (0, 40)
    else:
        starts, vy, vx, rows = _inputs(case)
        canvas_shape = CANVAS
        rows = rows or (0, len(starts))
    P = vy.shape[1]
    th, tw = rk.DET_TILE
    counts, lists = rk.roi_tile_lists_plain(starts, vy, vx, rows,
                                            canvas_shape, rk.DET_TILE)
    keys = torch.nonzero(counts).tolist()
    listed = set()
    for key, seg in zip(keys, torch.split(lists, counts[counts > 0].tolist())):
        listed.update((tuple(key), int(n)) for n in seg)
    ct = torch.randn((len(starts), P, P, canvas_shape[-1]),
                     generator=torch.Generator().manual_seed(0))
    B = canvas_shape[0]
    for n in range(*rows):
        b, y0, x0 = starts[n].tolist()
        if not (0 <= b < B and y0 >= 0 and x0 >= 0):
            continue
        d = rk.roi_window_accum_plain(torch.zeros(canvas_shape), starts, ct,
                                      vy, vx, (n, n + 1))
        for b, y, x in torch.nonzero(d.abs().sum(-1)).tolist():
            assert ((b, y // th, x // tw), n) in listed


@pytest.mark.parametrize("steps", [(0, 2), (1, 2)])
def test_det_cpu_route_matches_pallas(steps):
    """roi_window_accum_det on CPU tensors (its plain version) against the
    Pallas roi_window_accum_seg in interpret mode on sparse weights, J = 8
    rows per Pallas step: 1e-5 relative, as K4's plain version."""
    rng = np.random.RandomState(5)
    B, Hc, Wc, C = 2, 32, 40, 8
    WY, WX, P, N = 8, 16, 7, 16
    starts = np.stack([rng.randint(0, B, N), rng.randint(0, Hc - WY + 1, N),
                       rng.randint(0, (Wc - WX) // 8 + 1, N) * 8],
                      1).astype(np.int32)
    vy = (rng.randn(N, P, WY) * (rng.rand(N, P, WY) < 0.3)).astype(np.float32)
    vx = (rng.randn(N, P, WX) * (rng.rand(N, P, WX) < 0.3)).astype(np.float32)
    ct = rng.randn(N, P, P, C).astype(np.float32)
    base = rng.randn(B, Hc, Wc, C).astype(np.float32)
    ref = np.asarray(jax_rk.roi_window_accum_seg(
        jnp.asarray(base), jnp.asarray(steps, jnp.int32), jnp.asarray(starts),
        jnp.asarray(ct), jnp.asarray(vy), jnp.asarray(vx), WY, WX, P,
        rois_per_step=8, interpret=True))
    got = torch.from_numpy(base.copy())
    before = rk.roi_window_accum_det.launches
    out = rk.roi_window_accum_det(
        got, torch.from_numpy(starts), torch.from_numpy(ct),
        torch.from_numpy(vy), torch.from_numpy(vx),
        rows=(8 * steps[0], 8 * steps[1]))
    assert out is got
    assert rk.roi_window_accum_det.launches == before   # no kernel on CPU
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
