"""An inference cell: batches of detect_graph, closed loop, one caller.

Set-up makes the configuration's weights and a pool of distinct image
batches on the device (the traffic's images, in an order drawn from the
seed), configures the program and warms up on the pool (the first call builds the CUDA kernels in the checkout's
build directory and lets cuDNN pick its plans). The window then issues
the pool's batches in turn, each one ending when its boxes, scores,
classes, validity and mask probabilities are on the host, until
--seconds have passed; the rate is all images over all the window's
time, the tail the batches' own latencies. The outputs of a sample of
images drawn from the seed are kept (the last time each was served) for
the check after the window.
"""

import random
import statistics
import sys
import time
import types

import torch

from benchmark import check as check_mod
from benchmark import flops as flops_mod
from benchmark import spec as spec_mod
from benchmark import trace as trace_mod
from benchmark.weights import make_weights

OUT_KEYS = ("boxes", "scores", "classes", "valid", "mask_probs")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def configure_program(cfg):
    from detectron_tpu_torch.core import config

    config.reset_cfg()
    flat = []
    for k, v in cfg.items():
        flat += [k, v]
    config.merge_cfg_from_list(flat)
    config.assert_and_infer_cfg(make_immutable=False)


def make_pool(traffic, seed, device, dtype):
    """traffic["pool_batches"] batches of N(0, pixel_std) images, (B, H, W,
    3) each: the same images in every run, drawn by a generator on the
    device seeded with traffic["image_seed"], in an order drawn from
    `seed` (the batches' order and the images' order in each batch), so
    that every seed serves the same work."""
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic["image_seed"])
    B, P = traffic["batch"], traffic["pool_batches"]
    H, W = traffic["canvas"]
    pool = [(torch.randn(B, H, W, 3, generator=gen, device=device)
             * traffic["pixel_std"]).to(dtype) for _ in range(P)]
    rng = random.Random(seed)
    return [pool[p][torch.tensor(rng.sample(range(B), B), device=device)]
            for p in rng.sample(range(P), P)]


class Readback:
    """Copies a batch's outputs to host buffers (pinned on a card) and
    waits for them."""

    def __init__(self, device):
        self.device = device
        self.host = None

    def __call__(self, out):
        if self.host is None:
            self.host = {k: torch.empty(out[k].shape, dtype=out[k].dtype,
                                        pin_memory=self.device.type == "cuda")
                         for k in OUT_KEYS}
        for k in OUT_KEYS:
            self.host[k].copy_(out[k], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.host


def p90(values):
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def run(cell, args, t_start, device):
    """Returns (metrics {name: value}, extra) for the result line."""
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.ops import cuda as cuda_ops

    tr, cfg = cell.traffic, cell.config["cfg"]
    dtype = DTYPES[cell.compute_dtype]
    configure_program(cfg)
    t0 = time.perf_counter()
    pool = make_pool(tr, args.seed, device, dtype)
    params = make_weights(cell.config, tr, device, dtype)
    B, P = tr["batch"], len(pool)
    im_info = torch.tensor([tr["im_info"]] * B, device=device)
    t1 = time.perf_counter()
    log("# set-up: weights and {} image batches of {} in {:.3f} s".format(
        P, B, t1 - t0))
    readback = Readback(device)

    def batch(i):
        return readback(test_ops.detect_graph(params, pool[i % P], im_info))

    marks = [time.perf_counter()]
    for i in range(tr["warmup_calls"]):
        batch(i)
        marks.append(time.perf_counter())
    log("# warm-up calls s: " + " ".join(
        "%.3f" % (b - a) for a, b in zip(marks, marks[1:])))

    rng = random.Random(args.seed)
    sample = sorted(rng.sample(range(P * B), tr["check_images"]))
    sample = [(x // B, x % B) for x in sample]
    kept = {}
    cuda_ops.reset_launches()
    lat, served, i = [], 0, 0
    t_open = time.perf_counter()
    deadline = t_open + args.seconds
    while True:
        b0 = time.perf_counter()
        host = batch(i)
        b1 = time.perf_counter()
        lat.append(b1 - b0)
        served += B
        for pb, j in sample:
            if pb == i % P:
                kept[(pb, j)] = {k: host[k][j].clone() for k in OUT_KEYS}
        i += 1
        if b1 >= deadline:
            break
    window_s = b1 - t_open
    n_batches = i
    launches = {k: v / n_batches for k, v in cuda_ops.launch_counts().items()
                if v}
    log("# kernel launches a batch: " + " ".join(
        "{} {:g}".format(k, v) for k, v in sorted(launches.items())))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rate = served / window_s
    log("# window: {} batches of {} in {:.3f} s; batch ms median {:.3f} "
        "p90 {:.3f} max {:.3f}".format(
            n_batches, B, window_s, statistics.median(lat) * 1e3,
            p90(lat) * 1e3, max(lat) * 1e3))
    metrics = {"setup_s": t_open - t_start, "infer_img_per_s": rate,
               "infer_batch_p90_ms": p90(lat) * 1e3,
               "peak_gib": peak / 2 ** 30}
    extra = {"attempted": served, "memory_peak_bytes": peak}
    if args.trace:
        extra.update(traced(cell, batch, n_batches, device, rate))

    if len(kept) < len(sample):
        raise RuntimeError("the window served {} of the pool's {} batches; "
                           "the sample needs them all".format(n_batches, P))
    samples = [(pool[pb][j].clone(), tr["im_info"], kept[(pb, j)])
               for pb, j in sample]
    del pool, readback, host
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_mod.check(cell.config, params, samples, device)
    log("# check: {} images in {:.3f} s; {}".format(
        len(samples), time.perf_counter() - t_check, " ".join(
            "{} {:.6g}".format(k, v) for k, v in sorted(numbers.items()))))
    extra["correct"], extra["checks"] = check_mod.verdict(
        numbers, cell.data["limits"])
    return metrics, extra


def traced(cell, batch, start, device, rate):
    """The traced stretch after the window and the per-layer metrics read
    from it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = cell.traffic
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def profiled(n, stack, offset):
        with profile(activities=acts, with_stack=stack) as prof:
            for k in range(n):
                with record_function(trace_mod.BATCH_SPAN):
                    batch(offset + k)
        return trace_mod.load_trace(prof)

    t0 = time.perf_counter()
    dev = trace_mod.summarize_device(profiled(tr["trace_batches"], False,
                                              start))
    stage_s, n_stack = trace_mod.stage_device_s(
        profiled(tr["trace_stack_batches"], True, start))
    log("# trace: {:.3f} s; busy {:.6f} s of {:.6f} s over {} batches; "
        "device s by stage over {} batch(es): {}".format(
            time.perf_counter() - t0, dev["busy_s"], dev["window_s"],
            dev["batches"], n_stack, " ".join(
                "{} {:.6f}".format(k, v) for k, v in sorted(stage_s.items()))))
    ctx = types.SimpleNamespace(
        batch=tr["batch"], busy_s=dev["busy_s"], window_s=dev["window_s"],
        stage_s=stage_s, stage_images=n_stack * tr["batch"],
        img_per_s=rate,
        peak_flops=flops_mod.PEAK_FLOPS[cell.compute_dtype],
        flops_per_image=flops_mod.inference_per_image(
            cell.config["cfg"], tr["canvas"]))
    per_layer = {}
    for m in cell.per_layer:
        value = spec_mod.metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            per_layer[m["name"]] = value
    return {"per_layer": per_layer, "busy_s": dev["busy_s"],
            "window_s": dev["window_s"],
            "breakdown": {"device_ops": dev["device_ops"],
                          "idle_gaps": dev["idle_gaps"]}}
