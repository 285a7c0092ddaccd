"""Benchmark: Mask R-CNN R-50-FPN inference (or training) images a second on
one card (the port's twin of the repository's bench.py).

    python -m detectron_tpu_torch.tools.bench [--device cuda|cpu] \\
        [--canvas 832 1344] [--iters N]

Runs core/test.py::detect_graph on the mask_rcnn_r50_fpn preset in bf16 at
the 832 x 1344 canvas (an 800 x 1333 image, TEST.SCALE 800 / MAX_SIZE
1333) on seeded, calibrated weights and N(0, 20) images, as bench.py runs
the JAX package's graph: a warm-up call on each of two image sets (the
first builds the kernels, ops/cuda/build.py, and picks the cuDNN plans),
then BENCH_WINDOWS windows of --iters batches with two in flight (issue
batch i + 1, then read back batch i's scores). The rate of each window is
B / ((its wall) / iters) (bench.py divides by iters + 1: _window_inflight
says why not here); `value` is the best window, `median` the median one.
With BENCH_MODE=train it times parallel/train_step.py::train_step
instead: BENCH_TRAIN_BS images of utils/synthetic.synthetic_train_batch a
step on init_model(0)'s uncalibrated weights, reading step i - 1's loss
while step i runs, best and median of BENCH_WINDOWS windows of --iters
steps after TRAIN_WARMUP untimed steps. Trained over its one batch,
the model's steps get cheaper for its first ~50 steps (PERF.md §5), so
the warm-up is 50 steps (bench.py's is 2), and the windows time the
steps after it.

stdout carries one JSON line and nothing else:
{"metric": ..., "value": img/s, "unit": "images/sec/chip", "median": img/s,
"mfu": ..., "tflops_per_image": ..., "device": card name or "cpu"}, with
bench.py's metric names. stderr carries the card's name and power limit,
the kernel build, the warm-up, the FLOP count's note and, last, one
"# run {json}" line (parse_stderr reads it): the card, each window's
rate, the peak device memory, and the kernels' launches over the timed
calls and in one call. bench.py's `vs_baseline` is left out: its 150 and
22.3 img/s are targets set for a TPU v5e (BASELINE.json), not for this
card.

The environment hooks are bench.py's:
  BENCH_MODE       "train" times the training step
  BENCH_SET        "KEY VALUE ..." cfg overrides, merged after the preset
                   and bf16 (e.g. "TPU.FUSED_RES2 True" runs K5 and K6)
  BENCH_BS         inference batch (default DEFAULT_BS, from the card's
                   sweep in PERF.md)
  BENCH_CALIB      "0" leaves the inference weights uncalibrated
  BENCH_WINDOWS    timed windows (default 3; the training's too, which
                   bench.py fixes at 3)
  BENCH_TRAIN_BS   training batch (default DEFAULT_TRAIN_BS)
  BENCH_PEAK_FLOPS the MFU denominator (default the card's dense peak for
                   TPU.COMPUTE_DTYPE, PEAK_FLOPS; on the CPU none, and
                   mfu is null)
BENCH_AUTO_LAYOUT has no counterpart: it asked XLA to choose the compiled
graph's input layouts, and eager PyTorch compiles no graph. The twin
raises if it is set.

FLOPs come from torch.utils.flop_counter.FlopCounterMode over one untimed
call: the aten operations only. It does not see the port's CUDA kernels
(K1-K4 on this path, K5 and K6 with TPU.FUSED_RES2, whose res2 stage it
then misses), so `mfu` counts their work as none. On the CPU the plain
versions that stand in for the kernels run aten operations, and those
are counted.

The training step clips gradients at SOLVER.CLIP_GRADIENTS 10 unless
BENCH_SET says otherwise: from random weights without trained BN
statistics the first unclipped update sends the next step's proposals to
NaN, which stops the port on the card with a device-side index assert
(chip_smoke.py's CLIP_GRADIENTS). --device cpu is for tests at a tiny
--canvas; the default cuda raises without a GPU (utils/device.
check_device), and nothing falls back to the CPU or to a kernel's plain
version.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from detectron_tpu_torch.core import config
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.ops import cuda as cuda_ops
from detectron_tpu_torch.tools import measure
from detectron_tpu_torch.utils.device import check_device

# H100 SXM dense peaks (NVIDIA data sheet, 700 W) by compute dtype.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DEFAULT_BS = 64
DEFAULT_TRAIN_BS = 8
INFER_ITERS = 12
TRAIN_ITERS = 10
TRAIN_WARMUP = 50
TRAIN_CLIP_GRADIENTS = "10"
INFER_METRIC = "mask_rcnn_r50_fpn_inference_images_per_sec_per_chip"
TRAIN_METRIC = "mask_rcnn_r50_fpn_train_images_per_sec_per_chip"
RUN_PREFIX = "# run "


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def peak_flops(device):
    """BENCH_PEAK_FLOPS, else on a card its peak for TPU.COMPUTE_DTYPE;
    None on the CPU (no peak of its own: no mfu)."""
    if os.environ.get("BENCH_PEAK_FLOPS"):
        return float(os.environ["BENCH_PEAK_FLOPS"])
    return PEAK_FLOPS[cfg.TPU.COMPUTE_DTYPE] if device.type == "cuda" \
        else None


def step_flops(fn):
    """(FLOPs of one call of fn() from FlopCounterMode, or None where it
    counts none; the kernels' launches during that call)."""
    from torch.utils.flop_counter import FlopCounterMode

    before = cuda_ops.launch_counts()
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    after = cuda_ops.launch_counts()
    flops = float(counter.get_total_flops())
    return (flops if flops > 0 else None,
            {k: after[k] - before[k] for k in after})


def inference_arrays(B, canvas, calibrate=True):
    """bench.py's inputs as numpy: init_model(0)'s tree (calibrated from
    RandomState(0) unless not `calibrate`), then from that same rng B
    N(0, 20) images of `canvas` (their space_to_depth blocks with
    TPU.S2D_INPUT)."""
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.utils import blob as blob_utils
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    tree = init_mod.init_model(0)
    rng = np.random.RandomState(0)
    if calibrate:
        tree = calibrate_detector_params(tree, rng)
    images = rng.randn(B, *canvas, 3).astype(np.float32) * 20.0
    if cfg.TPU.S2D_INPUT:
        images = blob_utils.space_to_depth(images)
    return tree, images


def inference_inputs(B, canvas, device, calibrate=True):
    """(params, images, images + 1, im_info) on `device`: the params in
    the compute dtype, the images in bf16 whatever it is, as bench.py
    feeds them (the graph casts them to the compute dtype)."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import model_builder as mb

    tree, images_np = inference_arrays(B, canvas, calibrate)
    params = bridge.to_torch(tree, device, mb.compute_dtype())
    images = torch.from_numpy(images_np).to(device, torch.bfloat16)
    im_info = torch.tensor([measure.im_info_for(canvas)] * B, device=device)
    return params, images, images + 1.0, im_info


def _readback(out):
    return out["scores"].cpu()


def _window(fn, images, images2, n_iters, timed):
    """bench.py's window: two batches in flight. Returns seconds a batch:
    the window holds the n_iters calls issued in it, whose kernel launches
    it adds to `timed`. (bench.py divides by n_iters + 1, for the second
    batch issued before its window, which an asynchronous XLA dispatch
    leaves queued; the port's calls block the host inside, so that batch
    is read back before the window opens.)"""
    outs = [fn(images), fn(images2)]
    _readback(outs[0])
    _readback(outs[1])
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(n_iters):
        _readback(outs[i % 2])                  # consume the oldest
        outs[i % 2] = fn(images if i % 2 == 0 else images2)
    _readback(outs[0])
    _readback(outs[1])
    dt = time.perf_counter() - t0
    for name, n in cuda_ops.launch_counts().items():
        timed[name] += n
    return dt / n_iters


def _diffs_ms(marks):
    return " ".join("%.3f" % ((b - a) * 1e3) for a, b in zip(marks,
                                                              marks[1:]))


def _peak_gib(device):
    """(allocated, reserved) peak device memory in GiB; None on the CPU."""
    if device.type != "cuda":
        return None, None
    return (torch.cuda.max_memory_allocated(device) / 2**30,
            torch.cuda.max_memory_reserved(device) / 2**30)


def _record(metric, B, rates, flops, device):
    best = max(rates)
    rec = {"metric": metric, "value": round(best, 2),
           "unit": "images/sec/chip", "median": round(statistics.median(
               rates), 2)}
    if flops:
        peak = peak_flops(device)
        rec["mfu"] = round(flops * (best / B) / peak, 4) if peak else None
        rec["tflops_per_image"] = round(flops / B / 1e12, 3)
    rec["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    return rec


def _report(B, rates, flops, per_call, timed, calls, device):
    log("# flops: {} a batch of {} (torch.utils.flop_counter.FlopCounterMode "
        "over one untimed call, aten operations only); it does not see the "
        "port's CUDA kernels, launched per call: {}; peak {} FLOP/s "
        "({})".format("%.6g" % flops if flops else "none", B, per_call,
                      peak_flops(device), cfg.TPU.COMPUTE_DTYPE))
    allocated, reserved = _peak_gib(device)
    log(RUN_PREFIX + json.dumps({
        "card": measure.card_line(device), "windows": rates,
        "peak_gib": allocated, "peak_reserved_gib": reserved,
        "timed": timed, "calls": calls, "per_call": per_call}))


def parse_stderr(text):
    """The "# run" line's dict from the twin's stderr: card, windows
    (img/s), peak_gib and peak_reserved_gib (None on the CPU), timed
    (launches over the timed calls), calls and per_call. Raises unless
    there is exactly one such line."""
    runs = [json.loads(line[len(RUN_PREFIX):]) for line in text.splitlines()
            if line.startswith(RUN_PREFIX)]
    if len(runs) != 1:
        raise ValueError("{} '{}' lines in the twin's stderr".format(
            len(runs), RUN_PREFIX.strip()))
    return runs[0]


def inference_bench(device, B, canvas, iters=INFER_ITERS, n_windows=3,
                    calibrate=True):
    """bench.py's inference measurement on the cfg as it stands. Returns
    the record."""
    from detectron_tpu_torch.core import test as test_ops

    params, images, images2, im_info = inference_inputs(B, canvas, device,
                                                        calibrate)

    def fn(ims):
        return test_ops.detect_graph(params, ims, im_info)

    t0 = time.perf_counter()
    _readback(fn(images))
    _readback(fn(images2))
    log("# warm-up (2 calls): {:.3f} s".format(time.perf_counter() - t0))
    timed = dict.fromkeys(cuda_ops.wrappers(), 0)
    rates = [B / _window(fn, images, images2, iters, timed)
             for _ in range(n_windows)]
    flops, per_call = step_flops(lambda: _readback(fn(images)))
    _report(B, rates, flops, per_call, timed, n_windows * iters, device)
    return _record(INFER_METRIC, B, rates, flops, device)


def train_inputs(B, canvas, device):
    """(params, opt_state, batch): init_model(0)'s float32 params, their
    optimizer state and synthetic_train_batch(B, H, W) from RandomState(0),
    as bench.py's train mode builds them."""
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    params = measure.seeded_params(device, torch.float32)
    return (params, opt.init_opt_state(params),
            synthetic_train_batch(B, *canvas, device,
                                  np.random.RandomState(0)))


def train_bench(device, B, canvas, iters=TRAIN_ITERS, n_windows=3):
    """bench.py's training measurement on the cfg as it stands. Returns
    the record."""
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import train_step as ts

    state = {}
    state["params"], state["opt"], batch = train_inputs(B, canvas, device)
    gen = torch.Generator().manual_seed(1)

    def step():
        draws = train_graph.make_draws(gen, B, tuple(canvas),
                                       cfg.TPU.MAX_GT_BOXES, device)
        state["params"], state["opt"], state["stats"] = ts.train_step(
            state["params"], state["opt"], batch, draws)
        return state["stats"]

    marks = [time.perf_counter()]
    for _ in range(TRAIN_WARMUP):
        float(step()["loss"])
        marks.append(time.perf_counter())
    log("# warm-up steps ms: {}".format(_diffs_ms(marks)))
    cuda_ops.reset_launches()

    def window():
        prev = state["stats"]
        marks = [time.perf_counter()]
        for _ in range(iters):
            stats = step()
            float(prev["loss"])                 # step i - 1's, deferred
            prev = stats
            marks.append(time.perf_counter())
        state["loss"] = float(prev["loss"])
        log("# train window steps ms: {}".format(_diffs_ms(marks)))
        return B * iters / (time.perf_counter() - marks[0])

    rates = [window() for _ in range(n_windows)]
    timed = cuda_ops.launch_counts()
    if not math.isfinite(state["loss"]):
        raise RuntimeError("the training loss is {} after {} steps".format(
            state["loss"], TRAIN_WARMUP + n_windows * iters))
    log("# last loss {:.6g}".format(state["loss"]))
    flops, per_call = step_flops(lambda: float(step()["loss"]))
    _report(B, rates, flops, per_call, timed, n_windows * iters, device)
    return _record(TRAIN_METRIC, B, rates, flops, device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--canvas", type=int, nargs=2, default=list(
        measure.CANVAS), metavar=("H", "W"),
        help="image canvas (default 832 1344, an 800 x 1333 image)")
    p.add_argument("--iters", type=int, default=None,
                   help="batches (steps) a window (default {} inference, "
                   "{} training, as bench.py)".format(INFER_ITERS,
                                                      TRAIN_ITERS))
    return p.parse_args(argv)


def main(argv=None):
    """Prints the record's JSON line on stdout and returns the record."""
    args = parse_args(argv)
    env = os.environ
    if "BENCH_AUTO_LAYOUT" in env:
        raise RuntimeError(
            "BENCH_AUTO_LAYOUT is set, but it has no counterpart here: it "
            "let XLA choose the compiled graph's input layouts, and the "
            "port runs eager PyTorch, which compiles no graph; unset it")
    device = check_device(args.device)
    config.reset_cfg()
    train = env.get("BENCH_MODE") == "train"
    extra = ["SOLVER.CLIP_GRADIENTS", TRAIN_CLIP_GRADIENTS] if train else []
    measure.merge_cfg(set_cfgs=extra + env.get("BENCH_SET", "").split())
    log("# " + measure.card_line(device))
    n_windows = int(env.get("BENCH_WINDOWS", "3"))
    if device.type == "cuda":
        from detectron_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        libs = build.build_all()
        log("# build: {} kernel libraries ready in {:.1f} s".format(
            len(libs), time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats(device)
    if train:
        B = int(env.get("BENCH_TRAIN_BS", str(DEFAULT_TRAIN_BS)))
        rec = train_bench(device, B, args.canvas,
                          args.iters or TRAIN_ITERS, n_windows)
    else:
        B = int(env.get("BENCH_BS", str(DEFAULT_BS)))
        rec = inference_bench(device, B, args.canvas,
                              args.iters or INFER_ITERS, n_windows,
                              env.get("BENCH_CALIB", "1") != "0")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
