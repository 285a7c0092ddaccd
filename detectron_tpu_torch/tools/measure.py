"""What the measuring tools (profile_net, stage_bench, roi_bench,
multiscale_bench) share: their common flags, the cfg they run, the card's
name and power limit, and a median timer.

Every tool runs on --device cuda unless asked for the CPU (--device cpu,
for tests at a tiny --canvas); a CUDA device without a GPU raises
(utils/device.check_device). Each prints the card line once per run, so
every number it prints stands beside the card's name and power limit.
"""

import statistics
import subprocess
import time

import numpy as np
import torch

from detectron_tpu_torch.core import config
from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_fpn

# The JAX tools' canvas: an 800 x 1333 image padded to strides of 32.
CANVAS = (832, 1344)


def add_common_args(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--canvas", type=int, nargs=2, default=list(CANVAS),
                   metavar=("H", "W"), help="image canvas (default 832 "
                   "1344, an 800 x 1333 image)")
    p.add_argument("--set", dest="set_cfgs", nargs="+", default=[],
                   help="cfg KEY VALUE pairs, merged last")


def merge_cfg(cfg_file=None, set_cfgs=()):
    """The yaml `cfg_file` (else the mask_rcnn_r50_fpn preset), bf16
    compute, then `set_cfgs`, over the cfg as it stands."""
    if cfg_file:
        config.merge_cfg_from_file(cfg_file)
    else:
        mask_rcnn_r50_fpn()
    config.merge_cfg_from_list(["TPU.COMPUTE_DTYPE", "bfloat16"]
                               + list(set_cfgs))
    config.assert_and_infer_cfg(make_immutable=False)


def im_info_for(canvas):
    """[h, w, scale] of an image filling `canvas` as 800 x 1333 fills
    832 x 1344 (the JAX tools' im_info), clipped to the canvas."""
    H, W = canvas
    return [float(min(800, H)), float(min(1333, W)), 1.6]


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them, or what
    stands in for them on the CPU."""
    if device.type != "cuda":
        return "device: cpu (no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True, timeout=60)
        return "card: " + out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "card: {}, power limit not read (no nvidia-smi)".format(
            torch.cuda.get_device_name(device))


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, iters, device, warmup=1):
    """(median device-stream ms, median host wall ms) of fn() over `iters`
    runs after `warmup` runs. On a card the first is the span between two
    CUDA events recorded around the call, each run ended by a synchronize;
    on the CPU both are the host wall."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    ev, wall = [], []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            end.record()
        synchronize(device)
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end) if device.type == "cuda"
                  else wall[-1])
    return statistics.median(ev), statistics.median(wall)


def seeded_params(device, dtype, calibrate=False, rng=None):
    """init_model(0) (calibrated from `rng` where asked), bridged."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    tree = init_mod.init_model(0)
    if calibrate:
        tree = calibrate_detector_params(
            tree, np.random.RandomState(0) if rng is None else rng)
    return bridge.to_torch(tree, device, dtype)
