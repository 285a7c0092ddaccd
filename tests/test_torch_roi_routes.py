"""The FPN RoIAlign routes of the port besides the default ladder
(ops/windowed_roi.py, dispatched by models/model_builder.py::
roi_feature_transform) against the JAX package, on the same numpy inputs:

- TPU.ROI_IMPL 'windowed': window_params at align_x 1 and the windowed
  canvas, multilevel_roi_align_windowed (values and ok) and
  multilevel_roi_align_hybrid, forward and jax.grad, at windows 32 and 16
  (16 is below min_exact_window: the exact gather takes the short RoIs);
- 'gather' (ops/multilevel_roi.py per image), forward and jax.grad;
- 'pallas' with TPU.ROI_LADDER off (multilevel_roi_align_pallas_hybrid):
  forward and jax.grad in both branches (the top level inside the window
  at 832 x 1344 with window 32; below it, pooled densely, with window
  16), with the JAX package's clamped values for elongated mid-level RoIs;
- TPU.ROI_LADDER_NARROW: the narrow ladder's geometry, forward and
  gradient against JAX's narrow_base=True and against the port's default
  ladder;
- roi_feature_transform's dispatch: every (ROI_IMPL, ROI_LADDER,
  ROI_LADDER_NARROW) reaches the route JAX's reaches;
- the tiny detect_graph under TPU.ROI_IMPL windowed and TPU.ROI_WINDOW 16
  (tests/test_e2e_inference.py:83-84's keys), and the tiny training step's
  losses and gradients under TPU.ROI_LADDER False.

The RoIs mix ordinary, top-level, elongated mid-level and sliver boxes
(tests/test_multilevel_roi.py::test_windowed_hybrid_exact_elongated and
tests/test_roi_ladder.py:486-505) on the P2-P5 levels of an 832 x 1344
canvas. Tolerances: float32 within 1e-5 of max|ref| (and 1e-5 of each
value); bfloat16 2 bf16 ulps of each value plus 1e-3 of max|ref|
(test_torch_roi_align's rule); gradients per level within 1e-5 of max|ref|.
The JAX references of the op-level tests run with jax.disable_jit(), the
Pallas kernels in interpret mode (on every other RoI of the mix, which
keeps each kind): jitted, XLA contracts the sample coordinates'
multiply-adds and rounds a coordinate of ~90 cells to the next float32
(1.5e-5 off), which moves a bilinear value by up to ~3e-5 of max|ref|
(the two packages' formulas are the same). The two model-level tests run
the JAX package's NMS as tiled XLA (TPU.NMS_IMPL 'xla', the values of its
Pallas kernel) and its RoIAlign route under test as configured.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import config as jax_config
from detectron_tpu.core import test as jax_test
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.ops import multilevel_roi as jax_ml
from detectron_tpu.ops import windowed_roi as jax_win
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.ops import multilevel_roi as port_ml
from detectron_tpu_torch.ops import windowed_roi as port_win
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_detect import IM_INFO, _assert_detections_match, _images
from test_torch_roi_align import _close
from test_torch_train_step import (G, H, W, _batch, _close_tree, _jax_step,
                                   _replay_draws)
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(2)

# P2-P5 of an 832 x 1344 canvas, and the default rungs.
DIMS = ((208, 336), (104, 168), (52, 84), (26, 42))
SCALES = (0.25, 0.125, 0.0625, 0.03125)
RUNGS = ((32, 40), (64, 48), (16, 96), (32, 96))
B, C = 2, 4
# 'windowed' with TPU.ROI_WINDOW 16, as the JAX package's own end-to-end
# tests run it (tests/test_e2e_inference.py:83-84).
WINDOWED_KEYS = ["TPU.ROI_IMPL", "windowed", "TPU.ROI_WINDOW", "16"]


def _build(s, aspect, x=30.0, y=20.0):
    w = s * np.sqrt(aspect)
    return [x, y, x + w, y + s / np.sqrt(aspect)]


def _rois():
    """(B, 22, 4): small, elongated band-top (aspect 2-6), top-level
    (up to the canvas's width) and sliver RoIs; image 1 in reverse order."""
    rows = ([_build(s, r) for s in (60.0, 150.0) for r in (1.0, 0.5)]
            + [_build(220.0, 1.0), _build(150.0, 2.0), _build(200.0, 4.0),
               _build(200.0, 0.25), _build(180.0, 16.0),
               _build(180.0, 1.0 / 16.0), [5.0, 300.0, 1200.0, 340.0],
               [500.0, 5.0, 540.0, 790.0]]
            + [_build(400.0, 4.0), _build(900.0, 1.0), _build(200.0, 0.33),
               _build(500.0, 6.0), _build(120.0, 1.0),
               _build(600.0, 2.0, 100.0, 200.0),
               _build(120.0, 1.0, 500.0, 400.0), _build(700.0, 1.0),
               [10.0, 100.0, 1330.0, 700.0],
               _build(32.0, 1.0, 200.0, 100.0)])
    rois = np.array([rows] * B, np.float32)
    rois[1] = rois[1][::-1]
    return rois


def _rois_half():
    """Every other RoI of _rois(), each kind still among them: for the
    references whose Pallas kernels run in interpret mode, eagerly, whose
    time grows with the RoIs."""
    return _rois()[:, ::2].copy()


def _pyramid(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, w, C).astype(dtype) for h, w in DIMS]


def _jax_grads(fn, pyr, ct):
    """fn(list of jnp levels) -> output; returns (output, the vjp of ct
    per level), all numpy, evaluated eagerly."""
    with jax.disable_jit():
        out, vjp = jax.vjp(fn, [jnp.asarray(f) for f in pyr])
        grads = vjp(jnp.asarray(ct))[0]
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(fn, pyr, ct):
    tp = [torch.tensor(f, requires_grad=True) for f in pyr]
    out = fn(tp)
    grads = torch.autograd.grad(out, tp, torch.from_numpy(ct))
    return out.detach(), [g.numpy() for g in grads]


def _close_grads(got, ref):
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, lvl
        scale = np.abs(r).max()
        assert scale > 0, lvl
        assert np.abs(g - r).max() <= 1e-5 * scale, (
            lvl, np.abs(g - r).max(), scale)


def _per_image(fn, pyr, rois):
    return [fn([f[b] for f in pyr], rois[b]) for b in range(B)]


# ---------------------------------------------------------------------------
# TPU.ROI_IMPL 'windowed'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [32, 16])
def test_windowed_canvas_and_window_params_match_jax(window):
    """build_canvas_windowed / canvas_meta against JAX build_canvas /
    _canvas_meta, and window_params at align_x 1 against JAX's
    window_params (the 'windowed' route's origins, weights and ok)."""
    pyr = [f[0] for f in _pyramid(0)]
    canvas, geom = port_win.build_canvas_windowed(
        [torch.from_numpy(f) for f in pyr], window)
    ref_canvas, ref_off, ref_dims = jax_win.build_canvas(
        [jnp.asarray(f) for f in pyr], window)
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(ref_canvas))
    assert geom["row_off_l"] == ref_off and ref_dims == list(DIMS)
    meta = jax_win._canvas_meta([jnp.asarray(f) for f in pyr], window)
    for got, ref in zip([geom[k] for k in ("heights", "widths", "row_off",
                                           "pad_rows")], meta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rois = _rois()[0]
    sub = port_win.canvas_meta(list(DIMS[:-1]), window)
    got = port_win.window_params(torch.from_numpy(rois), sub, SCALES[:-1],
                                 7, 2, 2, 4, 224, 4, window, window,
                                 torch.float32, align_x=1)
    jmeta = jax_win._canvas_meta([jnp.asarray(f) for f in pyr[:-1]], window)
    ref = jax_win.window_params(jnp.asarray(rois), SCALES[:-1], *jmeta,
                                sub["Wc"], 7, 2, 2, 4, 224, 4, window,
                                window, jnp.float32, align_x=1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(r, np.float32), rtol=0,
                                   atol=1e-6)
    # Short windows for some RoIs; at 16 (< min_exact_window) for all but
    # the smallest.
    assert bool((~got[-1]).any()) and bool(got[-1].any())
    if window == 16:
        assert int(got[-1].sum()) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [32, 16])
def test_windowed_matches_jax(window, dtype):
    """multilevel_roi_align_windowed below the top level (P2-P4), one
    image: values and the ok flags."""
    pyr = [f[0] for f in _pyramid(1)][:-1]
    rois = _rois()[0]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.disable_jit():
        ref, ref_ok = jax_win.multilevel_roi_align_windowed(
            [jnp.asarray(f, jd) for f in pyr], SCALES[:-1],
            jnp.asarray(rois), 7, 2, 2, 4, window=window, chunk=8,
            return_ok=True)
    got, ok = port_win.multilevel_roi_align_windowed(
        [torch.from_numpy(f).to(getattr(torch, dtype)) for f in pyr],
        SCALES[:-1], torch.from_numpy(rois), 7, 2, 2, 4, window=window,
        chunk=8)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    _close(got, ref, dtype)


def test_windowed_chunks_change_no_value():
    pyr = [torch.from_numpy(f[0]) for f in _pyramid(2)][:-1]
    rois = torch.from_numpy(_rois()[0])
    whole, _ = port_win.multilevel_roi_align_windowed(
        pyr, SCALES[:-1], rois, 7, 2, 2, 4, window=32, chunk=256)
    parts, _ = port_win.multilevel_roi_align_windowed(
        pyr, SCALES[:-1], rois, 7, 2, 2, 4, window=32, chunk=3)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


@pytest.fixture(scope="module", params=[32, 16])
def hybrid(request):
    """The 'windowed' route, both packages, per image: forward and the
    gradient of a random cotangent."""
    window = request.param
    pyr = _pyramid(3)
    rois = _rois()
    ct = np.random.RandomState(4).randn(B, rois.shape[1], 7, 7, C).astype(
        np.float32)

    def jax_fn(p):
        return jnp.stack(_per_image(
            lambda f, r: jax_win.multilevel_roi_align_hybrid(
                f, SCALES, jnp.asarray(r), 7, 2, 2, 5, window=window,
                chunk=8), p, rois))

    def port_fn(p):
        return torch.stack(_per_image(
            lambda f, r: port_win.multilevel_roi_align_hybrid(
                f, SCALES, torch.from_numpy(r), 7, 2, 2, 5, window=window,
                chunk=8), p, rois))

    ref, ref_g = _jax_grads(jax_fn, pyr, ct)
    got, got_g = _port_grads(port_fn, pyr, ct)
    return dict(window=window, pyr=pyr, rois=rois, ref=ref, ref_g=ref_g,
                got=got, got_g=got_g)


def _exact(pyr, rois):
    """The exact gather RoIAlign of the JAX package, eagerly."""
    with jax.disable_jit():
        return np.stack(_per_image(
            lambda f, r: np.asarray(jax_ml.multilevel_roi_align(
                [jnp.asarray(x) for x in f], SCALES, jnp.asarray(r), 7, 2, 2,
                5, chunk=8)), pyr, rois))


def test_hybrid_forward_matches_jax(hybrid):
    _close(hybrid["got"], hybrid["ref"], "float32")


def test_hybrid_gradient_matches_jax(hybrid):
    _close_grads(hybrid["got_g"], hybrid["ref_g"])


def test_hybrid_is_exact_roialign(hybrid):
    """Every RoI equals the exact gather, the ones whose window was short
    included (a window of 16 is short for most below the top level)."""
    rois = torch.from_numpy(hybrid["rois"][0])
    geom = port_win.canvas_meta(list(DIMS[:-1]), hybrid["window"])
    ok = port_win.window_params(rois, geom, SCALES[:-1], 7, 2, 2, 4, 224, 4,
                                hybrid["window"], hybrid["window"],
                                torch.float32, align_x=1)[-1]
    top = port_ml.roi_levels(rois, 2, 5, 224, 4) == 5
    assert bool(top.any()) and bool((~ok & ~top).any())
    _close(hybrid["got"], _exact(hybrid["pyr"], hybrid["rois"]), "float32")


# ---------------------------------------------------------------------------
# TPU.ROI_IMPL 'gather'
# ---------------------------------------------------------------------------

def test_gather_route_forward_and_gradient_match_jax():
    pyr = _pyramid(5)
    rois = _rois()
    ct = np.random.RandomState(6).randn(B, rois.shape[1], 7, 7, C).astype(
        np.float32)
    ref, ref_g = _jax_grads(lambda p: jnp.stack(_per_image(
        lambda f, r: jax_ml.multilevel_roi_align(
            f, SCALES, jnp.asarray(r), 7, 2, 2, 5, chunk=8), p, rois)),
        pyr, ct)
    got, got_g = _port_grads(lambda p: torch.stack(_per_image(
        lambda f, r: port_ml.multilevel_roi_align(
            f, SCALES, torch.from_numpy(r), 7, 2, 2, 5), p, rois)), pyr, ct)
    _close(got, ref, "float32")
    _close_grads(got_g, ref_g)


# ---------------------------------------------------------------------------
# TPU.ROI_IMPL 'pallas' with TPU.ROI_LADDER off: the single window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[32, 16],
                ids=["full_canvas", "below_top"])
def single(request):
    """The single-window route, both packages (JAX: Pallas in interpret
    mode, trainable): forward and the gradient of a random cotangent."""
    window = request.param
    pyr = _pyramid(7)
    rois = _rois_half()
    ct = np.random.RandomState(8).randn(B, rois.shape[1], 7, 7, C).astype(
        np.float32)
    ref, ref_g = _jax_grads(
        lambda p: jax_win.multilevel_roi_align_pallas_hybrid(
            p, SCALES, jnp.asarray(rois), 7, 2, 2, 5, window=window,
            interpret=True, trainable=True), pyr, ct)
    got, got_g = _port_grads(
        lambda p: port_win.multilevel_roi_align_single_window_hybrid(
            p, SCALES, torch.from_numpy(rois), 7, 2, 2, 5, window=window),
        pyr, ct)
    return dict(window=window, pyr=pyr, rois=rois, ref=ref, ref_g=ref_g,
                got=got, got_g=got_g)


def test_single_window_forward_matches_jax(single):
    """Both branches: the top level (26 x 42) fits a window of 32 rows, so
    its RoIs take whole-level windows; at 16 it is pooled densely."""
    assert (DIMS[-1][0] <= single["window"]) == (single["window"] == 32)
    _close(single["got"], single["ref"], "float32")


def test_single_window_gradient_matches_jax(single):
    _close_grads(single["got_g"], single["ref_g"])


def test_single_window_clamps_elongated_mid_level_rois(single):
    """The values JAX gives are the clamped ones: RoIs below the top level
    that the window does not cover differ from the exact RoIAlign by whole
    feature values; the RoIs it covers and the top-level RoIs do not."""
    exact = _exact(single["pyr"], single["rois"])
    diff = np.abs(single["got"].numpy() - exact).reshape(-1, 7 * 7 * C).max(
        -1)
    flat = torch.from_numpy(single["rois"]).reshape(-1, 4)
    full = single["window"] == 32
    dims = list(DIMS) if full else list(DIMS[:-1])
    geom = port_win.single_window_geom(dims, single["window"],
                                       DIMS[-1][1] if full else 0)
    ok = port_win.window_params(
        flat, geom, SCALES[:len(dims)], 7, 2, 2, 1 + len(dims), 224, 4,
        geom["wy_base"], geom["wx_base"], torch.float32)[-1].numpy()
    top = (port_ml.roi_levels(flat, 2, 5, 224, 4) == 5).numpy()
    assert ok.any() and top.any() and (~ok & ~top).any()
    assert (diff[ok | top] < 1e-4).all()
    assert (diff[~ok & ~top] > 0.1).all()


# The levels' widths less the single window's 48 columns: P4's 36 is not a
# multiple of 8.
def test_single_window_reaches_the_right_edge_of_p4():
    """A RoI at P4's right edge: the port's window bound, rounded up to 8
    (ROADMAP Queue C), covers it, so it pools exactly; the JAX package's,
    rounded down, leaves P4's last 4 columns outside every window and
    clamps it. A divergence kept on purpose."""
    pyr = _pyramid(9)
    rois = np.array([[[1043.0, 100.0, 1343.0, 400.0]]] * B, np.float32)
    assert int(port_ml.roi_levels(torch.from_numpy(rois), 2, 5, 224,
                                  4)[0, 0]) == 4
    got = port_win.multilevel_roi_align_single_window_hybrid(
        [torch.from_numpy(f) for f in pyr], SCALES, torch.from_numpy(rois),
        7, 2, 2, 5, window=32)
    exact = _exact(pyr, rois)
    _close(got, exact, "float32")
    ref = np.asarray(jax_win.multilevel_roi_align_pallas_hybrid(
        [jnp.asarray(f) for f in pyr], SCALES, jnp.asarray(rois), 7, 2, 2, 5,
        window=32, interpret=True))
    assert np.abs(ref - exact).max() > 1e-2


# ---------------------------------------------------------------------------
# TPU.ROI_LADDER_NARROW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("narrow", [False, True])
def test_ladder_geometry_matches_jax(narrow):
    """The base window and the fix-up rungs of JAX's _ladder_geom (which
    fits no rung narrower at these channels): under narrow_base the base
    stays (32, 40) and a whole-top-level (32, 48) rung comes first."""
    g = port_win.ladder_geom(list(DIMS), RUNGS, narrow)
    ref = jax_win._ladder_geom(list(DIMS), C, 4, 7, RUNGS, 8, narrow,
                               jax_win.LADDER_TOP_FRAC,
                               jax_win.LADDER_FIX_FRAC)
    assert (g["wy_base"], g["wx_base"]) == (ref["wy_base"], ref["wx_base"])
    assert g["fix_rungs"] == ref["fix_rungs"]
    assert (g["wx_base"], g["fix_rungs"][0]) == (
        (40, (32, 48)) if narrow else (48, (64, 48)))


@pytest.fixture(scope="module")
def narrow():
    pyr = _pyramid(10)
    rois = _rois_half()
    ct = np.random.RandomState(11).randn(B, rois.shape[1], 7, 7, C).astype(
        np.float32)
    ref, ref_g = _jax_grads(
        lambda p: jax_win.multilevel_roi_align_ladder_trainable(
            p, SCALES, jnp.asarray(rois), 7, 2, 2, 5, 224, 4, RUNGS, 8, True,
            False, True), pyr, ct)
    out = {}
    for nb in (True, False):
        out[nb] = _port_grads(
            lambda p: port_win.multilevel_roi_align_ladder_trainable(
                p, SCALES, torch.from_numpy(rois), 7, 2, 2, 5, 224, 4, RUNGS,
                nb), pyr, ct)
    return dict(pyr=pyr, rois=rois, ref=ref, ref_g=ref_g, ports=out)


def test_narrow_routes_top_level_rois_to_the_top_rung(narrow):
    flat = torch.from_numpy(narrow["rois"]).reshape(-1, 4)
    geom = port_win.ladder_geom(list(DIMS), RUNGS, True)
    ok = port_win.window_params(flat, geom, SCALES, 7, 2, 2, 5, 224, 4,
                                geom["wy_base"], geom["wx_base"],
                                torch.float32)[-1]
    covered, rid = port_win.rung_route(flat, geom, SCALES, 2, 5, 224, 4)
    top = port_ml.roi_levels(flat, 2, 5, 224, 4) == 5
    assert bool((~ok & top).any())
    assert bool((rid[~ok & top] == 0).all() and covered[~ok & top].all())
    assert bool((~ok & ~covered).any())    # slivers: the exact gather


def test_narrow_forward_matches_jax(narrow):
    _close(narrow["ports"][True][0], narrow["ref"], "float32")


def test_narrow_gradient_matches_jax(narrow):
    _close_grads(narrow["ports"][True][1], narrow["ref_g"])


def test_narrow_equals_the_default_ladder(narrow):
    """The same values and gradients on other kernel shapes."""
    (got, got_g), (ref, ref_g) = narrow["ports"][True], \
        narrow["ports"][False]
    _close(got, ref.numpy(), "float32")
    _close_grads(got_g, ref_g)


def test_narrow_ladder_gradcheck_float64():
    """The narrow ladder's backward is the transpose of its forward."""
    rng = np.random.RandomState(12)
    tp = [torch.tensor(rng.randn(1, h, w, 1), requires_grad=True)
          for h, w in DIMS]
    rois = torch.from_numpy(_rois()[:1, ::3].copy())

    def f(*p):
        return port_win.multilevel_roi_align_ladder_trainable(
            list(p), SCALES, rois, 2, 2, 2, 5, 224, 4, RUNGS, True)

    assert torch.autograd.gradcheck(f, tp, fast_mode=True, atol=1e-9,
                                    rtol=1e-7)


def test_min_exact_window_and_the_warning(caplog):
    for scale, level in ((224, 4), (224, 3), (112, 4)):
        assert port_win.min_exact_window(scale, level, 2) == \
            jax_win.min_exact_window(scale, level, 2)
    port_win._warned_small_window.discard(8)
    with caplog.at_level(logging.WARNING, logger=port_win.__name__):
        for _ in range(2):
            port_win._warn_if_window_small(8, 224, 4, 2)
            port_win._warn_if_window_small(32, 224, 4, 2)
    assert [r.getMessage() for r in caplog.records
            if r.name == port_win.__name__] == [
        "ROI window 8 < 32: sub-top-level RoIAlign may clamp samples for "
        "mid-range RoIs (exact at window >= 32)"]


# ---------------------------------------------------------------------------
# roi_feature_transform's dispatch
# ---------------------------------------------------------------------------

def _recorders(monkeypatch, pkg_win, pkg_ml, names, zeros):
    """Replace each route function of a package with a stub that records
    (route, narrow, window) and returns zeros of the right shape."""
    calls = []

    def stub(route, narrow_at=None):
        def fn(*args, **kwargs):
            narrow = None
            if narrow_at is not None:
                narrow = bool(args[narrow_at] if len(args) > narrow_at
                              else kwargs.get("narrow_base", False))
            calls.append((route, narrow, kwargs.get("window")))
            return zeros(args[2], args[3])
        return fn

    for route, (name, narrow_at) in names.items():
        monkeypatch.setattr(pkg_ml if route == "gather" else pkg_win, name,
                            stub(route, narrow_at))
    return calls


ROUTE_CASES = [(impl, ladder, narrow_)
               for impl in ("pallas", "windowed", "gather")
               for ladder in (True, False) for narrow_ in (False, True)]


@pytest.mark.parametrize("impl,ladder,narrow_", ROUTE_CASES + [
    ("xla", True, False), ("pallas", True, "one_level")])
def test_dispatch_reaches_the_route_jax_reaches(monkeypatch, impl, ladder,
                                                narrow_):
    one_level = narrow_ == "one_level"
    extra = ["TPU.ROI_IMPL", impl, "TPU.ROI_LADDER", str(ladder),
             "TPU.ROI_LADDER_NARROW", str(bool(narrow_) and not one_level),
             "TPU.ROI_WINDOW", "24"]
    if one_level:
        extra += ["FPN.ROI_MAX_LEVEL", "2"]
    set_cfgs(extra=extra)
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 64 // s, 80 // s, 8).astype(np.float32)
             for s in (4, 8, 16, 32, 64)]
    scales = [1.0 / s for s in (4, 8, 16, 32, 64)]
    rois = np.tile(np.array([[[4.0, 6.0, 40.0, 30.0]]], np.float32),
                   (2, 3, 1))
    jax_calls = _recorders(
        monkeypatch, jax_win, jax_ml,
        {"ladder": ("multilevel_roi_align_ladder_trainable", 13),
         "single": ("multilevel_roi_align_pallas_hybrid", None),
         "windowed": ("multilevel_roi_align_hybrid", None),
         "gather": ("multilevel_roi_align", None)},
        lambda r, P: jnp.zeros(r.shape[:-1] + (P, P, 8)))
    port_calls = _recorders(
        monkeypatch, port_win, port_ml,
        {"ladder": ("multilevel_roi_align_ladder_trainable", 10),
         "single": ("multilevel_roi_align_single_window_hybrid", None),
         "windowed": ("multilevel_roi_align_hybrid", None),
         "gather": ("multilevel_roi_align", None)},
        lambda r, P: torch.zeros(tuple(r.shape[:-1]) + (P, P, 8)))
    ref = jax_mb.roi_feature_transform(
        None, [jnp.asarray(f) for f in feats], scales, jnp.asarray(rois), 7,
        2)
    got = port_mb.roi_feature_transform(
        [torch.from_numpy(f) for f in feats], scales, torch.from_numpy(rois),
        7, 2)
    assert tuple(got.shape) == ref.shape == (2, 3, 7, 7, 8)
    # JAX calls a per-image route once under vmap, the port once an image.
    routes = {c[0] for c in port_calls}
    assert len(routes) == 1 and {c[0] for c in jax_calls} == routes
    assert set(port_calls) == set(jax_calls)
    want = ("gather" if impl not in ("pallas", "windowed") else
            "windowed" if impl == "windowed" else
            "ladder" if ladder and not one_level else "single")
    assert port_calls[0][0] == want
    if want in ("single", "windowed"):
        assert port_calls[0][2] == 24


# ---------------------------------------------------------------------------
# The model: detect_graph under 'windowed', a training step without the
# ladder
# ---------------------------------------------------------------------------

def test_detect_graph_under_windowed_matches_jax():
    """tests/test_e2e_inference.py's cfg keys (TPU.ROI_IMPL windowed,
    TPU.ROI_WINDOW 16) in both packages, the tiny cfg, calibrated weights,
    images x0.3: detections as sets, masks within 1e-3."""
    set_cfgs(extra=WINDOWED_KEYS)
    # NMS by tiled XLA on the JAX side, not its Pallas kernel in interpret
    # mode: the same values (the JAX suite holds the two equal), traced in
    # a fraction of the time; its RoIAlign stays 'windowed'.
    jax_config.cfg.TPU.NMS_IMPL = "xla"
    tree = calibrate_detector_params(
        jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(0))),
        np.random.RandomState(0))
    images = _images(0.3)
    ref = jax.jit(lambda p, x, i: jax_test.detect_graph(p, x, i))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(IM_INFO))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    routes = []
    real = port_win.multilevel_roi_align_hybrid

    def spy(*args, **kwargs):
        routes.append(kwargs["window"])
        return real(*args, **kwargs)

    port_win.multilevel_roi_align_hybrid = spy
    try:
        got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                     torch.from_numpy(images),
                                     torch.from_numpy(IM_INFO))
    finally:
        port_win.multilevel_roi_align_hybrid = real
    # Box and mask transforms, each image by image.
    assert routes == [16] * 4
    assert ref["valid"].sum() > 0
    _assert_detections_match(got, ref)


def test_train_step_without_the_ladder_matches_jax():
    """tests/test_torch_train_step.py's tiny mask step (2 x 64 x 64) under
    TPU.ROI_LADDER False: every loss to 1e-4, every gradient leaf within
    1e-3 of its max|g_jax| (that file's bounds), through the single window
    (the top level 2 x 2 fits the window: whole-level windows)."""
    keys = TRAIN_KEYS + ["TPU.ROI_LADDER", "False"]
    set_cfgs(mask_on=True, extra=keys)
    jax_config.cfg.TPU.NMS_IMPL = "xla"    # as in the test above
    tree = jax.tree.map(np.asarray, jax_mb.init_model(jax.random.PRNGKey(0)))
    batch = _batch(True)
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    total, parts, grads, _, _ = jax.jit(
        lambda *a: _jax_step(*a))(jp, jax_opt.init_opt_state(jp),
                                  jax.tree.map(jnp.asarray, batch), key)
    assert jax_config.cfg.TPU.ROI_LADDER is False
    n_anchors, n_rois = port_tg.draw_sizes((H, W), G)
    calls = []
    real = port_win.multilevel_roi_align_single_window

    def spy(*args, **kwargs):
        calls.append(kwargs.get("x_cover"))
        return real(*args, **kwargs)

    port_win.multilevel_roi_align_single_window = spy
    try:
        got_total, got_parts, got_grads = port_ts.loss_and_grads(
            bridge.to_torch(tree, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            _replay_draws(key, n_anchors, n_rois))
    finally:
        port_win.multilevel_roi_align_single_window = real
    assert calls == [2, 2]    # box and mask RoIs, x_cover = W_top
    assert set(got_parts) == set(parts) and "loss_mask" in parts
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    _close_tree(bridge.to_jax_layout(got_grads), grads, 1e-3, "grad")
