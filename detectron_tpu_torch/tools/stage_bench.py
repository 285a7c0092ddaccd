"""Per-stage times of the inference pipeline on the card (the port's twin
of tools/stage_bench.py).

    python -m detectron_tpu_torch.tools.stage_bench [--batch_size 32] \\
        [--iters 8] [--skip_cumulative] [--calibrate] [--canvas 832 1344] \\
        [--device cuda|cpu] [--set KEY VALUE ...]

Times cumulative sub-graphs (body only, features, + RPN heads, +
proposals, + box head, + decode/NMS without masks, full detect) and
isolated ops (RPN NMS of 1000 boxes an image, the per-class tail NMS of
(B x 80) lanes of 400 boxes, both through kernel K1, and the chunked
top-k of a P2-sized score map), so each lever of PERF.md can be measured
on its own. Each time is the median over --iters runs, after a warm-up
run, of the span between two CUDA events recorded around the call, each
run ended by torch.cuda.synchronize (the JAX tool's scalar readback is not
needed: the port's outputs are on the device already). The dispatch floor
is one trivial kernel launch and a synchronize, timed the same way; every
stage prints its time less the floor, and its increment over the stage
before.
"""

import argparse
import functools

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.tools import measure
from detectron_tpu_torch.utils.device import check_device

print = functools.partial(print, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--skip_cumulative", action="store_true")
    p.add_argument("--calibrate", action="store_true",
                   help="calibrate the seeded weights (utils/synthetic.py) "
                        "for the production work mix")
    measure.add_common_args(p)
    return p.parse_args(argv)


def stages(params, images, im_info):
    """[(name, fn)]: the cumulative sub-graphs, each returning a tensor."""
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.models import resnet

    def body_only():
        _, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
        return resnet.apply_body(params["body"],
                                 images.to(mb.compute_dtype()),
                                 num_stages)[-1]

    def feats():
        return mb.forward_features(params, images)[0]

    def rpn():
        f, _ = mb.forward_features(params, images)
        return mb.forward_rpn(params, f)

    def props():
        f, _ = mb.forward_features(params, images)
        return mb.generate_proposals(mb.forward_rpn(params, f), f, im_info,
                                     False)

    def boxes():
        f, s = mb.forward_features(params, images)
        rois, _, _ = mb.generate_proposals(mb.forward_rpn(params, f), f,
                                           im_info, False)
        return mb.forward_box_outputs(params, f, s, rois)

    def detect_nomask():
        # The same graph with MASK_ON off for this call only.
        prev = cfg.MODEL.MASK_ON
        cfg.MODEL.MASK_ON = False
        try:
            return test_ops.detect_graph(params, images, im_info)
        finally:
            cfg.MODEL.MASK_ON = prev

    def full():
        return test_ops.detect_graph(params, images, im_info)

    return [("body only (s2d={})".format(cfg.TPU.S2D_STEM), body_only),
            ("features (body+FPN)", feats),
            ("+ rpn heads", rpn),
            ("+ proposals", props),
            ("+ box head", boxes),
            ("+ decode/NMS (no mask)", detect_nomask),
            ("full detect", full)]


def sorted_lanes(rng, L, N, scale, device):
    """L lanes of N random boxes and score-descending scores."""
    bx = np.abs(rng.randn(L, N, 4)).astype(np.float32) * scale
    bx = np.concatenate([bx[..., :2], bx[..., :2] + bx[..., 2:]], -1)
    sc = -np.sort(-rng.rand(L, N).astype(np.float32), 1)
    return torch.from_numpy(bx).to(device), torch.from_numpy(sc).to(device)


@torch.no_grad()
def main(argv=None):
    """Print the lines; returns {line name: ms less the floor}."""
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.ops import nms as nms_ops
    from detectron_tpu_torch.ops.topk import topk_chunked

    args = parse_args(argv)
    device = check_device(args.device)
    measure.merge_cfg(None, args.set_cfgs)
    print(measure.card_line(device))

    def timeit(fn):
        return measure.median_ms(fn, args.iters, device)[0]

    B = args.batch_size
    H, W = args.canvas
    rng = np.random.RandomState(0)
    params = measure.seeded_params(device, mb.compute_dtype(),
                                   args.calibrate)
    images = torch.from_numpy(
        rng.randn(B, H, W, 3).astype(np.float32) * 20).to(device)
    im_info = torch.tensor([measure.im_info_for((H, W))] * B, device=device)
    out = {}

    tiny = torch.zeros(8, device=device)
    floor = timeit(lambda: tiny + 1.0)
    print("dispatch floor: {:.3f} ms".format(floor))
    out["dispatch floor"] = floor
    if not args.skip_cumulative:
        prev = floor
        for name, fn in stages(params, images, im_info):
            ms = timeit(fn)
            print("{:<22} {:8.3f} ms  (+{:.3f})".format(name, ms - floor,
                                                        ms - prev))
            out[name] = ms - floor
            prev = ms

    # Isolated: RPN-level NMS (1000 presorted boxes an image).
    bx, sc = sorted_lanes(rng, B, 1000, 100.0, device)
    t = timeit(lambda: nms_ops.nms_batched_sorted(bx, sc, 0.7, 1000))
    print("RPN NMS 1000->1000 x{} (K1): {:.3f} ms".format(B, t - floor))
    out["RPN NMS"] = t - floor

    # Isolated: the detection tail's per-class NMS (B * (C-1) lanes of 400).
    C1, K = 80, 400
    bx2, sc2 = sorted_lanes(rng, B * C1, K, 50.0, device)
    t = timeit(lambda: nms_ops.nms_batched_sorted(bx2, sc2, 0.5, 100))
    print("tail NMS {}x{}->100 (K1): {:.3f} ms".format(B * C1, K,
                                                        t - floor))
    out["tail NMS"] = t - floor

    # Isolated: top-k over a P2-sized score map (3 anchors a cell).
    n = (H // 4) * (W // 4) * 3
    s = torch.from_numpy(rng.randn(B, n).astype(np.float32)).to(device)
    t = timeit(lambda: topk_chunked(s, 1000))
    print("topk {}k->1000 x{}: topk_chunked {:.3f} ms".format(
        n // 1000, B, t - floor))
    out["topk"] = t - floor
    return out


if __name__ == "__main__":
    main()
