"""X-152-32x8d multi-scale training cost on the card (the port's twin of
tools/multiscale_bench.py).

    python -m detectron_tpu_torch.tools.multiscale_bench \\
        [--scales 640 800] [--bs 2] [--iters 4] [--cfg YAML] \\
        [--device cuda|cpu] [--set KEY VALUE ...]

Runs the training step of the X-152-32x8d-FPN-IN5k yaml (bf16 compute,
TPU.REMAT_BODY) at several of its TRAIN.SCALES canvases
(utils/blob.py::static_canvas, landscape), each scale's batch from
utils/synthetic.synthetic_train_batch(..., im_scale=s / 500). It prints
one JSON row a scale, then an interleave line that re-runs each scale
once. The keys are the JAX tool's, except compile_s: an eager step has
no compile, so its row gives first_step_s, the first step's wall time at
that canvas (cuDNN's algorithm search and the allocator's first blocks
for the new shapes, the eager counterpart of a compile). s_per_step is
the mean of --iters further steps, each read back before the next, with
the previous step's loss read while the next one runs (as the trainers
defer their readback).
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from detectron_tpu_torch.core import config
from detectron_tpu_torch.tools import measure
from detectron_tpu_torch.utils.device import check_device

X152_YAML = str(Path(__file__).resolve().parents[2] / "configs" /
                "baselines" / "e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x.yaml")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", type=int, nargs="+", default=[640, 800])
    ap.add_argument("--bs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cfg", default=X152_YAML)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """Print the rows; returns them (the interleave line last). `params`:
    a numpy params tree of the cfg's model to start from instead of
    init_model(0) (a caller that has built one already)."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils import blob as blob_utils
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    args = parse_args(argv)
    device = check_device(args.device)
    measure.merge_cfg(args.cfg, ["TPU.REMAT_BODY", "True"] + args.set_cfgs)
    cfg = config.cfg
    for s in args.scales:
        assert s in cfg.TRAIN.SCALES, (s, cfg.TRAIN.SCALES)
    print(measure.card_line(device), flush=True)

    state = {"params": bridge.to_torch(
        init_mod.init_model(0) if params is None else params, device,
        torch.float32)}
    state["opt"] = opt.init_opt_state(state["params"])
    gen = torch.Generator().manual_seed(1)

    def step(batch, hw):
        draws = train_graph.make_draws(gen, args.bs, hw, cfg.TPU.MAX_GT_BOXES,
                                       device)
        state["params"], state["opt"], stats = ts.train_step(
            state["params"], state["opt"], batch, draws)
        return stats

    def batch_at(s, seed):
        H, W = blob_utils.static_canvas(s, cfg.TRAIN.MAX_SIZE,
                                        landscape=True)
        return (H, W), synthetic_train_batch(
            args.bs, H, W, device, np.random.RandomState(seed),
            im_scale=s / 500.0)

    rows = []
    for s in args.scales:
        (H, W), batch = batch_at(s, 0)
        t0 = time.perf_counter()
        loss0 = float(step(batch, (H, W))["loss"])
        first_step_s = time.perf_counter() - t0
        prev = None
        t0 = time.perf_counter()
        for _ in range(args.iters):
            stats = step(batch, (H, W))
            if prev is not None:
                float(prev["loss"])
            prev = stats
        float(prev["loss"])
        dt = (time.perf_counter() - t0) / args.iters
        rows.append({"scale": s, "canvas": [H, W],
                     "first_step_s": round(first_step_s, 3),
                     "s_per_step": round(dt, 4),
                     "img_per_s": round(args.bs / dt, 3),
                     "loss0": round(loss0, 2)})
        print(json.dumps(rows[-1]), flush=True)

    # Interleave: each scale once more, one after another.
    t0 = time.perf_counter()
    for s in args.scales:
        hw, batch = batch_at(s, 1)
        float(step(batch, hw)["loss"])
    rows.append({"interleave_total_s": round(time.perf_counter() - t0, 3),
                 "scales": args.scales})
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
