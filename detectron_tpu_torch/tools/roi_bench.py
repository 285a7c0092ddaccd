"""The FPN RoIAlign paths on their own, at Mask R-CNN shapes (the port's
twin of tools/roi_bench.py).

    python -m detectron_tpu_torch.tools.roi_bench [--batch 32] \\
        [--rois 1000] [--pooled 7] [--iters 8] [--dtype bfloat16] \\
        [--canvas 832 1344] [--device cuda|cpu]

The inputs are the JAX tool's: the P2-P5 pyramid of the canvas, 256
channels, made on the device from a seeded torch.Generator, and RoIs with
areas log-uniform in [32^2, 800^2] and aspect ratios in [0.5, 2]. Of the
JAX tool's variants, rois_per_step is a TPU layout, and the single-window
hybrid and the XLA windowed route are cfg routes of the port
(TPU.ROI_LADDER False, TPU.ROI_IMPL 'windowed'; chip_smoke phase 20 runs
them in the model); it times instead:

  (a) ladder: ops/windowed_roi.py::multilevel_roi_align_ladder, the
      production path (K2 over the base windows, K3 per fix-up rung, the
      exact gather for slivers; the fix-up loop syncs the host);
  (b) level sweep: one K2 sweep per level over the whole level map,
      ops/roi_align.py::roi_align_batched on the RoIs that
      ops/multilevel_roi.py::roi_levels assigns to that level (each
      image's list padded to the level's longest with a 1-pixel RoI);
  (c) dense top P5: every RoI on P5 (another function: no agreement);
  (d) gather: the exact gather alone, ops/multilevel_roi.py::
      multilevel_roi_align_canvas_flat on the ladder's canvas, the plain
      yardstick.

(a), (b) and (d) compute the same values: the tool prints their max abs
difference against (d). Each time is the median over --iters runs of the
span between CUDA events around the whole call (each run ended by a
synchronize), with the host wall beside it. P = 14 at 100 RoIs is the
mask head's shape.
"""

import argparse
import functools

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.tools import measure
from detectron_tpu_torch.utils.device import check_device

print = functools.partial(print, flush=True)

SCALES = (0.25, 0.125, 0.0625, 0.03125)
K_MIN, K_MAX = 2, 5
SAMPLING_RATIO = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--rois", type=int, default=1000)
    p.add_argument("--pooled", type=int, default=7)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    measure.add_common_args(p)
    return p.parse_args(argv)


def make_inputs(B, R, canvas, C, dtype, device, seed=0):
    """(pyramid [P2..P5] (B, H/s, W/s, C), rois (B, R, 4)): the pyramid
    drawn on the device from a seeded torch.Generator, the RoIs from a
    seeded numpy RandomState in the image of the canvas."""
    H, W = canvas
    ih, iw = measure.im_info_for(canvas)[:2]
    gen = torch.Generator(device=device).manual_seed(seed)
    pyr = [torch.randn((B, H // int(1 / s), W // int(1 / s), C),
                       generator=gen, device=device, dtype=torch.float32)
           .to(dtype) for s in SCALES]
    rng = np.random.RandomState(seed)
    s = np.exp(rng.uniform(np.log(32.0), np.log(800.0), (B, R)))
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (B, R)))
    w = s * np.sqrt(ar)
    h = s / np.sqrt(ar)
    x1 = rng.uniform(0, iw - 1, (B, R)) * (1 - w / iw)
    y1 = rng.uniform(0, ih - 1, (B, R)) * (1 - h / ih)
    rois = np.stack([x1, y1, np.minimum(x1 + w, iw - 1),
                     np.minimum(y1 + h, ih - 1)], -1).astype(np.float32)
    return pyr, torch.from_numpy(rois).to(device)


def ladder(pyr, rois, P):
    from detectron_tpu_torch.ops import windowed_roi as wr

    return wr.multilevel_roi_align_ladder(
        pyr, SCALES, rois, P, SAMPLING_RATIO, K_MIN, K_MAX,
        cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
        tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS))


def level_plan(rois):
    """Per level: (rois (B, R_l, 4) padded with a 1-pixel RoI, the flat
    output slots of the real ones (B*R)-indexed, their mask in the
    padded (B, R_l))."""
    from detectron_tpu_torch.ops import multilevel_roi as ml

    B, R = rois.shape[:2]
    lvl = ml.roi_levels(rois, K_MIN, K_MAX, cfg.FPN.ROI_CANONICAL_SCALE,
                        cfg.FPN.ROI_CANONICAL_LEVEL)
    plan = []
    for k in range(K_MIN, K_MAX + 1):
        sel = lvl == k
        n = sel.sum(1)
        R_l = max(int(n.max()), 1)
        order = torch.argsort((~sel).to(torch.int8), dim=1, stable=True)
        idx = order[:, :R_l]
        real = torch.arange(R_l, device=rois.device)[None] < n[:, None]
        padded = torch.gather(rois, 1, idx[..., None].expand(-1, -1, 4))
        padded = torch.where(real[..., None], padded,
                             padded.new_tensor([0.0, 0.0, 1.0, 1.0]))
        slots = (torch.arange(B, device=rois.device)[:, None] * R + idx)[real]
        plan.append((padded, slots, real))
    return plan


def level_sweep(pyr, rois, P, plan):
    """(b): `plan` is level_plan(rois)."""
    from detectron_tpu_torch.ops import roi_align as ra

    B, R = rois.shape[:2]
    C = pyr[0].shape[-1]
    out = pyr[0].new_zeros((B * R, P, P, C))
    for f, s, (padded, slots, real) in zip(pyr, SCALES, plan):
        got = ra.roi_align_batched(f, padded, s, P, SAMPLING_RATIO)
        out[slots] = got[real]
    return out.reshape(B, R, P, P, C)


def dense_top(pyr, rois, P):
    from detectron_tpu_torch.ops import roi_align as ra

    return ra.roi_align_batched(pyr[-1], rois, SCALES[-1], P,
                                SAMPLING_RATIO)


def gather(pyr, rois, P):
    from detectron_tpu_torch.ops import multilevel_roi as ml
    from detectron_tpu_torch.ops import windowed_roi as wr

    B, R = rois.shape[:2]
    dims = [(f.shape[1], f.shape[2]) for f in pyr]
    geom = wr.ladder_geom(dims, tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS))
    canvas = wr.build_canvas(pyr, geom)
    img = torch.arange(B, dtype=torch.int32,
                       device=rois.device).repeat_interleave(R)
    out = ml.multilevel_roi_align_canvas_flat(
        canvas, dims, geom["row_off_l"], [0] * len(dims), SCALES,
        rois.reshape(B * R, 4), img, P, SAMPLING_RATIO, K_MIN, K_MAX,
        cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
    return out.reshape(B, R, P, P, -1)


@torch.no_grad()
def main(argv=None):
    """Print the lines; returns {variant: {"ms", "wall_ms", "max_abs_diff"
    (against the gather; None for dense top P5), "out"}}."""
    args = parse_args(argv)
    device = check_device(args.device)
    measure.merge_cfg(None, args.set_cfgs)
    print(measure.card_line(device))
    B, R, P = args.batch, args.rois, args.pooled
    dtype = getattr(torch, args.dtype)
    pyr, rois = make_inputs(B, R, tuple(args.canvas), args.channels, dtype,
                            device)
    print("{} images x {} RoIs, P={}, {} x {} canvas, {} channels, {}; "
          "RoIs a level {}".format(
              B, R, P, *args.canvas, args.channels, args.dtype,
              [int(real.sum()) for _, _, real in level_plan(rois)]))
    tiny = torch.zeros(8, device=device)
    floor = measure.median_ms(lambda: tiny + 1.0, args.iters, device)[0]
    print("floor {:.3f} ms".format(floor))

    variants = (("ladder (K2 + K3 rungs + gather)",
                 lambda: ladder(pyr, rois, P)),
                ("level sweep (K2 a level)",
                 lambda: level_sweep(pyr, rois, P, level_plan(rois))),
                ("dense top P5 (K2)", lambda: dense_top(pyr, rois, P)),
                ("gather (exact, plain)", lambda: gather(pyr, rois, P)))
    ref = gather(pyr, rois, P).float()
    results = {}
    for name, fn in variants:
        ms, wall = measure.median_ms(fn, args.iters, device)
        got = fn()
        diff = None if name.startswith("dense") else \
            float((got.float() - ref).abs().max())
        results[name] = {"ms": ms, "wall_ms": wall, "max_abs_diff": diff,
                         "out": got}
        print("{:<32} {:9.3f} ms (host wall {:9.3f} ms){}".format(
            name, ms - floor, wall,
            "" if diff is None else
            ", max abs diff against the gather {:.3e}".format(diff)))
    return results


if __name__ == "__main__":
    main()
