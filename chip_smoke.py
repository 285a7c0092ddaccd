#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detectron_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. Device and build: the card's name and power limit from nvidia-smi,
     then every CUDA kernel of the inference path built from csrc/.
  2. Per-kernel check at the main path's shapes: each kernel's wrapper on
     CUDA tensors against its plain PyTorch version on the same inputs
     (K1 exactly; K2/K3 within 2 bf16 ulps), with median CUDA-event times
     of both.
  3. A small-input check: the port's detect_graph on the GPU (kernels)
     against the same function on the CPU (plain versions), in float32 on
     the tiny 256 x 320 configuration.
  4. The main path: Mask R-CNN R-50-FPN inference (detect_graph) at full
     width in bfloat16, 2 images of 800 x 1333 in an 832 x 1344 canvas,
     1000 RPN proposals and 100 detections per image, random numpy-init
     weights calibrated toward a trained detector's output statistics. The
     launch counters are zeroed just before and read just after; every
     kernel must have launched.
Prints a {"kernels": [...]} line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

TF32 is off for both cuDNN convolutions and matmuls
(torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 =
False), so the float32 check of phase 3 runs in full float32.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 2
CANVAS = (832, 1344)
IM_INFO = (800.0, 1333.0, 1.6)
MAIN_RUNS = 3


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def set_cfg(tiny, dtype):
    from detectron_tpu.core.configs_presets import mask_rcnn_r50_fpn
    from detectron_tpu_torch.core import config

    config.reset_cfg()
    mask_rcnn_r50_fpn()
    extra = ["TPU.COMPUTE_DTYPE", dtype]
    if tiny:
        extra += ["TEST.RPN_PRE_NMS_TOP_N", "256",
                  "TEST.RPN_POST_NMS_TOP_N", "64",
                  "TEST.DETECTIONS_PER_IM", "20"]
    config.merge_cfg_from_list(extra)
    config.assert_and_infer_cfg(make_immutable=False)


def make_params(device, dtype, seed=0):
    from detectron_tpu_torch.models import bridge, init
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    params = calibrate_detector_params(init.init_model(seed),
                                       np.random.RandomState(seed))
    return bridge.to_torch(params, device, dtype)


# ---------------------------------------------------------------------------
# Phase 2 inputs at the main path's shapes
# ---------------------------------------------------------------------------

def nms_lanes(rng, L, N, device):
    import torch

    x1 = rng.uniform(0, 1300, (L, N))
    y1 = rng.uniform(0, 780, (L, N))
    wh = rng.uniform(8, 300, (L, N, 2))
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
    valid = rng.rand(L, N) < 0.97
    valid[:, rng.randint(N // 2, N):] = False
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def ladder_inputs(rng, n, pooled, window, device, dtype):
    """A real-size canvas (B, 428, 432, 256) from a random pyramid of an
    832 x 1344 image, and window origins/weights of n RoIs of detector-like
    sizes at the given window shape (None: the ladder's base window)."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.ops import windowed_roi as win

    dims = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    pyramid = [torch.randn((BATCH, h, w, 256), generator=torch.Generator(
        device).manual_seed(i), device=device, dtype=dtype)
        for i, (h, w) in enumerate(dims)]
    geom = win.ladder_geom(dims, tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS))
    canvas = win.build_canvas(pyramid, geom)
    window = window or (geom["wy_base"], geom["wx_base"])
    xy = rng.uniform(0, 1000, (n, 2))
    wh = rng.lognormal(4.5, 0.8, (n, 2)).clip(4, 800)
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
        np.float32)).to(device)
    sy, sx, vy, vx, _ = win.window_params(
        rois, geom, (0.25, 0.125, 0.0625, 0.03125), pooled, 2, 2, 5, 224, 4,
        window[0], window[1], dtype)
    img = torch.from_numpy(rng.randint(0, BATCH, n).astype(np.int32)).to(
        device)
    return canvas, torch.stack([img, sy, sx], -1).contiguous(), vy, vx, \
        window


def check_kernels(device):
    """Phase 2. Returns {kernel name: entry} with max_abs_err, ms, plain_ms
    at the primary shape, and prints one line per checked shape."""
    import torch

    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    rng = np.random.RandomState(0)
    entries = {}

    def record(name, shape, err, ms, plain_ms, primary):
        print("check {} {}: max_abs_err={} kernel_ms={:.4f} plain_ms={:.4f}"
              .format(name, shape, err, ms, plain_ms))
        e = entries.setdefault(name, {"max_abs_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], float(err))
        if primary:
            e.update(shape=shape, ms=ms, plain_ms=plain_ms)

    # K1: RPN levels (L = B lanes; N = 1000, and 819 at P6) and the
    # detection tail (L = B * 80 classes, N = K = 400). Exact.
    for (L, N), thr in (((BATCH, 1000), 0.7), ((BATCH, 819), 0.7),
                        ((BATCH * 80, 400), 0.5)):
        boxes, valid = nms_lanes(rng, L, N, device)
        got = nms_kernel.nms_keep_mask(boxes, valid, thr)
        ref = nms_kernel.nms_keep_mask_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got != ref).sum())
        if err:
            raise AssertionError("K1 nms_keep_mask disagrees with its plain "
                                 "version at L={} N={}: {} keep bits"
                                 .format(L, N, err))
        record("nms_keep_mask", "L={} N={}".format(L, N), err,
               cuda_ms(lambda: nms_kernel.nms_keep_mask(boxes, valid, thr),
                       20),
               cuda_ms(lambda: nms_kernel.nms_keep_mask_plain(
                   boxes, valid, thr), 3), primary=(N == 1000))

    def pool_check(name, fn, plain, args, rows, shape, primary):
        got = fn(*args)[rows[0]:rows[1]].float()
        ref = plain(*args)[rows[0]:rows[1]].float()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        # 2 bf16 ulps of each value plus a floor for cancelling sums.
        bound = ref.abs() * (1.0 / 64) + 1e-3 * float(ref.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError("{} disagrees with its plain version at {}:"
                                 " max_abs_err {}".format(
                                     name, shape, float(diff.max())))
        record(name, shape, float(diff.max()), cuda_ms(lambda: fn(*args), 20),
               cuda_ms(lambda: plain(*args), 3), primary)

    # K2: base sweep, box head (P = 7, N = B * 1000) and mask head (P = 14,
    # N = B * 100), bf16 on a full-size canvas.
    for pooled, n in ((7, BATCH * 1000), (14, BATCH * 100)):
        canvas, starts, vy, vx, window = ladder_inputs(
            rng, n, pooled, None, device, torch.bfloat16)
        pool_check("roi_window_pool", roi_align_kernel.roi_window_pool,
                   roi_align_kernel.roi_window_pool_plain,
                   (canvas, starts, vy, vx), (0, n),
                   "P={} N={} window={} canvas={}".format(
                       pooled, n, window, tuple(canvas.shape)), pooled == 7)

    # K3: each fix-up rung, 12% of the box RoIs active in a 256-row capacity.
    for wy, wx in ((64, 48), (16, 96), (32, 96)):
        canvas, starts, vy, vx, _ = ladder_inputs(rng, 256, 7, (wy, wx),
                                                  device, torch.bfloat16)
        rows = (0, 240)
        pool_check("roi_window_pool_seg",
                   lambda *a: roi_align_kernel.roi_window_pool_seg(*a, rows),
                   lambda *a: roi_align_kernel.roi_window_pool_plain(
                       *a, rows=rows),
                   (canvas, starts, vy, vx), rows,
                   "P=7 rows={} of 256 window=({}, {})".format(rows, wy, wx),
                   (wy, wx) == (64, 48))
    return entries


# ---------------------------------------------------------------------------
# Phases 3 and 4
# ---------------------------------------------------------------------------

def match_detections(a, b):
    """Fraction of b's valid detections (per image) that a has with the
    same class, IoU > 0.99 and |score diff| < 1e-3."""
    import torch

    matched = total = 0
    for i in range(b["valid"].shape[0]):
        vb = b["valid"][i]
        va = a["valid"][i]
        ba, bb = a["boxes"][i][va], b["boxes"][i][vb]
        sa, sb = a["scores"][i][va], b["scores"][i][vb]
        ca, cb = a["classes"][i][va], b["classes"][i][vb]
        total += int(vb.sum())
        if len(ba) == 0 or len(bb) == 0:
            continue
        lt = torch.maximum(bb[:, None, :2], ba[None, :, :2])
        rb = torch.minimum(bb[:, None, 2:], ba[None, :, 2:])
        inter = (rb - lt + 1).clamp(min=0).prod(-1)
        area = lambda x: (x[:, 2:] - x[:, :2] + 1).prod(-1)  # noqa: E731
        iou = inter / (area(bb)[:, None] + area(ba)[None, :] - inter)
        ok = (iou > 0.99) & ((sb[:, None] - sa[None, :]).abs() < 1e-3) & \
            (cb[:, None] == ca[None, :])
        matched += int(ok.any(1).sum())
    return matched / max(total, 1)


def check_small_input(device):
    """Phase 3: GPU kernels vs CPU plain versions, tiny float32 config."""
    import torch

    from detectron_tpu_torch.core import test as det

    set_cfg(tiny=True, dtype="float32")
    rng = np.random.RandomState(1)
    # x0.3, not the main path's x20: random weights without trained BN
    # statistics grow activations through the body, and larger inputs
    # saturate every score at 1.0, which would hide a mis-ordering.
    images = rng.randn(BATCH, 256, 320, 3).astype(np.float32) * 0.3
    im_info = np.array([[250.0, 310.0, 1.0]] * BATCH, np.float32)
    outs = {}
    for dev in ("cpu", device):
        params = make_params(dev, torch.float32)
        outs[dev] = {k: v.cpu() for k, v in det.detect_graph(
            params, torch.from_numpy(images).to(dev),
            torch.from_numpy(im_info).to(dev)).items()}
    cpu, gpu = outs["cpu"], outs[device]
    frac = match_detections(gpu, cpu)
    n_cpu, n_gpu = int(cpu["valid"].sum()), int(gpu["valid"].sum())
    print("small-input check (float32, 2 x 256 x 320): valid cpu={} gpu={} "
          "matched={:.4f}".format(n_cpu, n_gpu, frac))
    if n_cpu == 0 or frac < 0.95 or abs(n_cpu - n_gpu) > 0.05 * n_cpu:
        raise AssertionError("GPU detect_graph disagrees with the CPU plain "
                             "path on the small input")


def run_main_path(device):
    """Phase 4. Returns the kernels' launch counts over MAIN_RUNS batches."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    set_cfg(tiny=False, dtype="bfloat16")
    params = make_params(device, torch.bfloat16)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(BATCH, *CANVAS, 3).astype(np.float32) * 20.0).to(
            device, torch.bfloat16)
    im_info = torch.tensor([IM_INFO] * BATCH, device=device)
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(MAIN_RUNS):
        out = det.detect_graph(params, images, im_info)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    D = cfg.TEST.DETECTIONS_PER_IM
    M = cfg.MRCNN.RESOLUTION
    shapes = {"boxes": (BATCH, D, 4), "scores": (BATCH, D),
              "classes": (BATCH, D), "valid": (BATCH, D),
              "mask_probs": (BATCH, D, M, M)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError("{} has shape {}, expected {}".format(
                k, tuple(out[k].shape), shape))
        if out[k].is_floating_point() and not bool(
                torch.isfinite(out[k]).all()):
            raise AssertionError(k + " has non-finite values")
    per_image = out["valid"].sum(1).tolist()
    print("main path (Mask R-CNN R-50-FPN, bf16, {} x {} x {}, RPN {} "
          "proposals, D={}): {:.3f} img/s over {} batches, valid detections "
          "per image {}, launches {}".format(
              BATCH, *CANVAS, cfg.TEST.RPN_POST_NMS_TOP_N, D,
              BATCH * MAIN_RUNS / dt, MAIN_RUNS, per_image, launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    if sum(per_image) == 0:
        raise AssertionError("the main path produced no detections")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is false")
    from detectron_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print("env: python {} torch {} cuda {}".format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    t0 = time.perf_counter()
    libs = build.build_all()
    print("build: {} kernels in {:.1f} s ({})".format(
        len(libs), time.perf_counter() - t0,
        ", ".join(p.name for p in libs.values())))

    set_cfg(tiny=False, dtype="bfloat16")
    entries = check_kernels(device)
    check_small_input(device)
    launches = run_main_path(device)

    meta = {
        "nms_keep_mask": ("detectron_tpu_torch/csrc/nms_keep_mask.cu",
                          "detectron_tpu/ops/pallas/nms_kernel.py:92"),
        "roi_window_pool": ("detectron_tpu_torch/csrc/roi_window_pool.cu",
                            "detectron_tpu/ops/pallas/roi_align_kernel.py:546"),
        "roi_window_pool_seg": (
            "detectron_tpu_torch/csrc/roi_window_pool.cu",
            "detectron_tpu/ops/pallas/roi_align_kernel.py:304"),
    }
    kernels = [{"name": name, "route": "cuda", "status": "ok", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": entries[name]["max_abs_err"],
                "ms": entries[name]["ms"],
                "plain_ms": entries[name]["plain_ms"],
                "shape": entries[name]["shape"]}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
