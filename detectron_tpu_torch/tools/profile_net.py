"""Profile the detection or training graph with torch.profiler (the port's
twin of tools/profile_net.py).

    python -m detectron_tpu_torch.tools.profile_net [--cfg YAML] \\
        [--mode infer|train] [--batch_size 8] [--steps 3] [--calibrate] \\
        [--out DIR] [--canvas 832 1344] [--device cuda|cpu] [--no_stack] \\
        [--set KEY VALUE ...]

Runs core/test.py::detect_graph (or, with --mode train, parallel/
train_step.py::train_step on utils/synthetic.synthetic_train_batch) on the
mask_rcnn_r50_fpn preset (or --cfg) in bf16 at the 832 x 1344 canvas, a
warm-up step, --steps unprofiled steps, then --steps steps under
torch.profiler with CPU and CUDA activities, stacks, shapes and FLOPs
(--no_stack: no stacks, so the host runs as fast as unprofiled but for
the profiler's own cost; tools/trace_summary.py then ties the kernels to
the program's spans alone). Each profiled step is a "profile_net step"
span in the trace. The trace
is Chrome-trace JSON, gzipped, at <out>/profile_net_<mode>.trace.json.gz
(view it in chrome://tracing or Perfetto; summarize it with
tools/trace_summary.py); <out>/profile_net_<mode>.walls.json keeps both
walls (stacks slow the host a lot, so the profiled steps' idle share
describes a profiled step, not an unprofiled one) and the session's own
device total from key_averages(), which trace_summary's device total of
the same trace should equal. --set works as in the
JAX tool: `--set TPU.FUSED_RES2 True` profiles kernels K5 and K6; a
training profile of the seeded weights wants `--set
SOLVER.CLIP_GRADIENTS 10`, as chip_smoke.py's steps take it (unclipped,
the warm-up step's update can send the next step's proposals to NaN).
The default --out is build/profile_net under the repository root.
"""

import argparse
import gzip
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.tools import measure
from detectron_tpu_torch.utils.device import check_device

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "profile_net"
STEP_SPAN = "profile_net step"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", dest="cfg_file")
    p.add_argument("--mode", choices=["infer", "train"], default="infer")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--no_stack", action="store_true",
                   help="record no Python stacks (trace_summary's table "
                        "by span needs none; its table by stage does)")
    p.add_argument("--calibrate", action="store_true",
                   help="apply the trained-detector weight calibration "
                        "(utils/synthetic.py) so the profile sees the "
                        "production work mix")
    measure.add_common_args(p)
    return p.parse_args(argv)


def make_step(args, device):
    """The step to profile (a no-argument callable) on the cfg as set."""
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.models import resnet

    B = args.batch_size
    H, W = args.canvas
    rng = np.random.RandomState(0)
    if args.mode == "infer":
        params = measure.seeded_params(device, mb.compute_dtype(),
                                       args.calibrate, rng)
        images = torch.from_numpy(
            rng.randn(B, H, W, 3).astype(np.float32) * 20).to(
                device, mb.compute_dtype())
        if cfg.TPU.S2D_INPUT:
            images = resnet.space_to_depth(images)
        im_info = torch.tensor([measure.im_info_for((H, W))] * B,
                               device=device)
        return lambda: test_ops.detect_graph(params, images, im_info)

    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    state = {"params": measure.seeded_params(device, torch.float32,
                                             args.calibrate, rng)}
    state["opt"] = opt.init_opt_state(state["params"])
    batch = synthetic_train_batch(B, H, W, device, rng)
    gen = torch.Generator().manual_seed(1)

    def step():
        draws = train_graph.make_draws(gen, B, (H, W), cfg.TPU.MAX_GT_BOXES,
                                       device)
        state["params"], state["opt"], stats = ts.train_step(
            state["params"], state["opt"], batch, draws)
        return stats

    return step


def _walls(step, steps, device):
    """Host ms of `steps` steps, each a STEP_SPAN span ended by a
    synchronize."""
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        with torch.profiler.record_function(STEP_SPAN):
            step()
            measure.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def session_device_time(prof):
    """The profiler session's own device time: (ms summed over its device
    events' self time, as key_averages() gives it, {event name: (calls,
    ms)}). (0.0, {}) where the session saw no device. The step spans'
    device-side annotations are left out: they span the step's kernels."""
    from torch.autograd import DeviceType

    by_name = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key != STEP_SPAN
               and not getattr(e, "is_user_annotation", False)}
    return sum(ms for _, ms in by_name.values()), by_name


def main(argv=None):
    """Writes the trace; returns {"trace", "walls", "step", "device_ms",
    "device_by_name"}: the trace's path, the walls dict written beside
    it, the profiled step, and the session's own device time over the
    profiled steps (session_device_time; trace_summary's device total of
    the same trace should equal it)."""
    from torch.profiler import ProfilerActivity, profile

    args = parse_args(argv)
    device = check_device(args.device)
    measure.merge_cfg(args.cfg_file, args.set_cfgs)
    card = measure.card_line(device)
    print(card)
    step = make_step(args, device)
    step()                                          # warm-up
    measure.synchronize(device)
    plain = _walls(step, args.steps, device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True,
                 with_stack=not args.no_stack, with_flops=True) as prof:
        profiled = _walls(step, args.steps, device)
    device_ms, by_name = session_device_time(prof)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, "profile_net_" + args.mode)
    prof.export_chrome_trace(stem + ".trace.json")
    with open(stem + ".trace.json", "rb") as f, \
            gzip.open(stem + ".trace.json.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(stem + ".trace.json")
    walls = {"mode": args.mode, "batch_size": args.batch_size,
             "canvas": list(args.canvas), "steps": args.steps,
             "card": card, "unprofiled_ms": plain, "profiled_ms": profiled,
             "stacks": not args.no_stack, "session_device_ms": device_ms}
    with open(stem + ".walls.json", "w") as f:
        json.dump(walls, f)
    print("{} x {}, batch {}: unprofiled step wall {} ms, profiled (stacks "
          "{}) {} ms".format(args.mode, "x".join(map(str, args.canvas)),
                             args.batch_size, [round(w, 3) for w in plain],
                             "off" if args.no_stack else "on",
                             [round(w, 3) for w in profiled]))
    print("profiler session's device self time (key_averages): {:.3f} ms "
          "over {} steps".format(device_ms, args.steps))
    print("Trace written to", stem + ".trace.json.gz")
    return {"trace": stem + ".trace.json.gz", "walls": walls, "step": step,
            "device_ms": device_ms, "device_by_name": by_name}


if __name__ == "__main__":
    main()
