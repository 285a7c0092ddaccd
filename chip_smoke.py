#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detectron_tpu_torch) on one GPU.

Run from the repository root:
    python3 chip_smoke.py [--profile-train] [--clip-gradients X]

Phases, each of which raises on failure (exit code != 0, no result line):
  1. Device and build: the card's name and power limit from nvidia-smi,
     then every CUDA kernel (K1-K6) built from csrc/.
  2. Per-kernel check at the main paths' shapes: each kernel's wrapper on
     CUDA tensors against its plain PyTorch version on the same inputs
     (K1, the IoU bitmask then a one-warp scan per lane, at the RPN's
     five levels stacked into one call as both paths launch it, one level
     alone, the per-class tail, and the default cfg's long lanes (12000
     boxes, stacked and one level alone); K2/K3, which pool only the
     canvas cells their weights reach, at the box and mask heads' base
     windows and each fix-up rung; K4, their transpose over the same
     reach, at the training path's box, mask and rung shapes. K1 and K5
     exactly; K2/K3 within 2 bf16 ulps; K4, whose vector reductions sum
     overlapping windows in an order that changes from run to run,
     within 1e-5 max|ref| + 1e-6; K6 in bf16 within 2^-7 |ref| + 2^-6
     max|ref| with under 20% of the elements differing, in f32 within
     1e-5 max|ref|), with median CUDA-event times of both (one call
     between two events, so a small kernel's time includes its wrapper's
     host time), the kernel's device time alone (device_ms, torch.profiler
     over 10 calls), and the least time the card could take for the same
     work (bound_ms:
     bytes over 3.35 TB/s or operations over the peak rate of the inputs'
     type, 989 TFLOP/s bf16 and 67 TFLOP/s f32, whichever is larger). A
     yardstick line times the port's unfused stem post-ops + res2 stage
     (cuDNN) beside K5 + K6 on the same input.
  3. Checks of whole functions, GPU (kernels) against CPU (plain
     versions): the RoIAlign ladder's backward (K4 over the base window
     and each fix-up rung, autograd of the exact gather for slivers) at
     the training path's box shapes, GPU float32 against CPU float64,
     each level within 1e-4 of its largest gradient; and in
     float32: detect_graph on the tiny 256 x 320 configuration, with
     TPU.FUSED_RES2 off and on (on: the "auto" mode, K6 in f32), and one
     Mask R-CNN train_step on 2 x 128 x 160 images with the same sampling
     draws (a CPU torch.Generator), with cuDNN off and on: losses within
     1e-3 relative of the CPU float32 step; gradients and the SGD update
     within 1e-4 of each leaf's largest, against the CPU plain path in
     float64 run with the float32 step's ReLU signs (a ReLU input within
     float32 rounding of 0 may take the other side on another device,
     which moves a gradient by a whole term), and every ReLU input within
     ACT_REL of the float64 step's.
  4. The inference main path: Mask R-CNN R-50-FPN detect_graph at full
     width in bfloat16, 2 images of 800 x 1333 in an 832 x 1344 canvas,
     1000 RPN proposals and 100 detections per image, random numpy-init
     weights calibrated toward a trained detector's output statistics.
  5. The training main path: Mask R-CNN R-50-FPN train_step at full width,
     bfloat16 compute with float32 master params, 2 synthetic images in an
     832 x 1344 canvas (utils/synthetic.synthetic_train_batch), Detectron's
     settings (RPN 2000/2000, 512 RoIs and 256 anchors per image): one
     warm-up step, then TRAIN_STEPS timed SGD steps, gradients clipped to
     a global norm of CLIP_GRADIENTS. The weights are
     calibrated as in phase 4: uncalibrated RPN deltas decode almost every
     proposal to a sliver, which the ladder pools by the exact gather, so
     the fix-up rungs (K3 and their K4 sweeps) would see no traffic.
  6. The TPU.FUSED_RES2 inference path: phase 4 with TPU.FUSED_RES2 on,
     so the stem post-ops and res2 run as K5 then K6 (the "packed" mode);
     then phase 4's path and this one in turns on the same inputs, and a
     torch.profiler batch of each (device busy time, idle share, the top
     kernels and the port's own kernels by device time).
  7. The dataset inference engine (core/test_engine.py), as
     `python -m detectron_tpu_torch.tools.test_net` runs it: a synthetic
     COCO val set of ENGINE_IMAGES PPM images at COCO-typical sizes (both
     orientation buckets; tools/make_synthetic_valset.py), 80 categories,
     polygon ground truth; phase 4's calibrated weights written with
     utils/net.save_ckpt and loaded by initialize_model_from_cfg; then
     run_inference at full width in bfloat16, batch ENGINE_BATCH,
     TEST.SCALE 800 / MAX_SIZE 1333, to detections.pkl and COCO box and
     mask AP (printed, not judged: the weights are random). Every image
     must have finite (n, 5) boxes inside it per class, with as many RLEs;
     the first batch must equal detect_graph called directly on the batch
     the engine prepared (boxes and RLE strings exactly); TEST.SOFT_NMS
     and TEST.BBOX_VOTE must route 4 images through the host path, and
     without them im_detect_all must match the batched path on the same
     single-image batches (scores rtol 1e-4 / atol 1e-5, boxes rtol 1e-3
     / atol 0.05, as tests/test_e2e_inference.py), in float32, on
     low-contrast copies of the 4 images at scale 1 (the host NMS works in
     image coordinates, the device NMS in scaled ones, and with the +1 box
     convention IoUs near the threshold differ between the two). The engine logs its
     end-to-end and steady img/s, per-batch load, device-wait and post
     seconds, and the evaluation's seconds; a torch.profiler run of one
     engine batch gives the device's busy time and idle share.
  8. The trainer, as `python -m detectron_tpu_torch.tools.train_net_step`
     runs it: a synthetic COCO training set (coco_2017_train) of
     TRAIN_NET_IMAGES PPM images written by make_synthetic_valset (both
     orientation buckets, polygon ground truth, 80 categories); phase 4's
     calibrated weights written as a Detectron .pkl in Caffe2 layouts,
     which load_detectron_weight must read back to the same tree exactly,
     and from which initialize_model_from_cfg must give the same tensors as
     from a checkpoint of that tree; then train_net_step.main with
     --dataset coco2017 --bs 2 --nw 4 --load_detectron, TRAIN.USE_FLIPPED,
     TRAIN.SCALES (800,) / MAX_SIZE 1333, SOLVER.CLIP_GRADIENTS (phase 5's
     reason), bf16 compute, for TRAIN_NET_STEPS steps (SOLVER.MAX_ITER 1,
     which the linear-scaling rule multiplies by the preset's 8 x 2 images
     a step over --bs 2). Every step's losses must be finite, and
     the last checkpoint must read back through utils/net.load_ckpt_params
     as the model's tree. Prints the median step after the first, img/s,
     and the loader's wait per step (time blocked on next(loader)).
  9. Keypoint R-CNN inference (the keypoint_rcnn_r50_fpn preset:
     Detectron's e2e_keypoint_rcnn_R-50-FPN_1x, 2 classes, 17 keypoints, 8
     3x3 convs of 512 channels on 14 x 14 RoIAlign features, a 4 x 4
     stride-2 deconv to 28 x 28 and a frozen bilinear x2 to 56 x 56
     heatmaps, MASK_ON off): detect_graph at full width in bfloat16, 2
     images in the 832 x 1344 canvas, 1000 RPN proposals, 100 detections
     per image, MAIN_RUNS batches (heatmaps (2, 100, 56, 56, 17) finite;
     the keypoint RoIs per ladder route printed), and a torch.profiler
     batch (device busy time, idle share); then run_inference over
     a synthetic person-keypoints val set of KPS_ENGINE_IMAGES PPM images
     (make_synthetic_valset --keypoints: 1-4 tall person boxes per image,
     17 keypoints each, visibility 0/1/2), batch ENGINE_BATCH, to
     detections.pkl and COCO box and keypoint AP (printed, not judged).
     Every image's keypoints must be finite and inside their boxes, and
     the first batch must equal detect_graph + keypoint_results called
     directly on the batch the engine prepared; the heatmap decode of that
     batch is timed alone.
  10. Keypoint R-CNN training from disk: phase 8 on the same maker's
     person-keypoints train set (keypoints_coco_2017_train, with flips),
     train_net_step.main --dataset keypoints_coco2017 --bs 2 --nw 4
     --load_detectron (the calibrated tree as a .pkl, conv_fcn1..8 and
     kps_score included, read back exactly), TRAIN.SCALES (800,),
     CLIP_GRADIENTS, TRAIN_NET_STEPS steps: loss_kps finite on every step,
     the checkpoint read back.
  11. Mask R-CNN R-50-C4 inference (the mask_rcnn_r50_c4 preset:
     Detectron's e2e_mask_rcnn_R-50-C4_1x, a conv4 body, a single-level
     RPN of 12 anchors a cell, TEST.RPN_PRE_NMS_TOP_N 6000 -> 1000, 14 x
     14 RoIAlign on res4 through K2 with one window spanning the map, the
     res5 head, the v0upshare mask head with 14 x 14 masks): detect_graph
     at full width in bfloat16, 2 images in the 832 x 1344 canvas,
     MAIN_RUNS batches, with cls_score calibrated so scores spread
     (calibrate_scores), a torch.profiler batch, and the same batch
     through the plain K1 and K2 on the card (plain_kernels): the same
     detections, as phase 3 matches them.
  12. The C4 engine: run_inference over C4_ENGINE_IMAGES synthetic PPM
     images, batch ENGINE_BATCH, to detections.pkl and COCO box and mask
     AP (printed, not judged); the first batch equal to detect_graph on
     the batch the engine prepared.
  13. The C4 trainer: train_net_step.main --dataset coco2017 --bs 2 --nw 4
     --load_detectron (the C4 tree as a .pkl, res5_* under the box head,
     read back exactly), the preset's TRAIN.SCALES (800,), TRAIN.RPN_PRE_
     NMS_TOP_N 12000 -> 2000, 512 RoIs an image, CLIP_GRADIENTS,
     TRAIN_NET_STEPS steps: loss_mask finite on every step, the
     checkpoint read back.
  14. Deterministic training (ROADMAP C2): two identical full-width Mask
     R-CNN R-50-FPN training steps (phase 5's cfg, params, batch and one
     set of sampling draws) under torch.use_deterministic_algorithms:
     losses and every gradient leaf bit-equal, K4's deterministic variant
     (roi_window_accum_det) launched and the atomic K4 not; torch raises
     for any op of the step without a deterministic implementation. The
     same two steps with the switch off are printed beside them. Then
     train_net_step --deterministic at phase 8's sizes for 4 steps, and
     for 2 steps then --resume to 4: the two checkpoints (params,
     momentum, step) and the stats of steps 2-3 bit-equal, through K4's
     deterministic variant only. main() sets
     CUBLAS_WORKSPACE_CONFIG=:4096:8 (deterministic cuBLAS, read when
     cuBLAS starts) before any CUDA work, for every phase.
  15-17. Mask R-CNN X-152-32x8d-FPN-IN5k (configs/baselines/e2e_mask_rcnn_
     X-152-32x8d-FPN-IN5k_1.44x.yaml: ResNeXt-152 with 32 groups of 8,
     50 bottlenecks, the stride on the 3x3 convs): phase 11's inference
     (cls_score calibrated so scores spread: calibrate_scores), the
     plain-K1-K3 match included; the engine over X152_ENGINE_IMAGES
     images to COCO box and mask AP; train_net_step from a Detectron .pkl
     for MODEL_TRAIN_STEPS steps at the yaml's multi-scale TRAIN.SCALES
     (640-800) and MAX_SIZE 1333 (NUM_GPUS 1: one step a MAX_ITER), with
     torch.cuda.max_memory_allocated.
  18. Mask R-CNN R-50-FPN with GroupNorm from scratch (configs/
     gn_baselines/scratch_e2e_mask_rcnn_R-50-FPN_3x_gn.yaml: GN body with
     no stage frozen, GN FPN, the Xconv1fc_gn box head, the v1up4convs_gn
     mask head): phase 11's inference and MODEL_TRAIN_STEPS
     train_net_step steps, in which every GN param and the stem move.
  Phase 2 also holds K1 at the C4 RPN's one-level lanes (2, 6000) and
  (2, 12000), K2 with the whole res4 map as its window (P = 14, N = 2000
  and 200, bf16), K4 at the C4 training shapes (N = 1024 and 256), and
  K4's deterministic variant at every FPN and C4 shape of K4 (two calls
  bit-equal, K4's tolerance, its time beside the atomic kernel's on the
  same inputs, and its two kernels' device times by name); phase 3 also checks a tiny Keypoint R-CNN detect_graph
  (heatmaps of matched detections within 1e-4 of max|cpu|) and
  train_step (loss_kps among the losses), a tiny Mask R-CNN R-50-C4, a
  tiny ResNeXt-50 32x8d and a tiny GN Mask R-CNN detect_graph and
  train_step, on the GPU against the CPU, at its tolerances.
  Phases 4-18 each zero the launch counters just before a path's run and
  read them just after; every kernel of the path must have launched (in
  the trainers K1, K2 and K4, in 11-12, 15-16 and 18's inference K1 and
  K2, in 14 K4's deterministic variant; K3 is reported).
Prints a {"kernels": [...]} line (each kernel's launches on its own path:
the inference main path for K1-K3, training for K4, phase 14 for K4's
deterministic variant, the TPU.FUSED_RES2 path for K5/K6;
launches_by_path has every path: "test_net" being phase 7's
run_inference, "train_net" phase 8's train_net_step, "keypoint_infer"
and "keypoint_test_net" phase 9's detect_graph and run_inference,
"keypoint_train" phase 10's train_net_step, "c4_infer", "c4_test_net"
and "c4_train" phases 11-13, "deterministic_train" and
"deterministic_resume" phase 14's steps and its trainer, "x152_infer",
"x152_test_net", "x152_train" phases 15-17, "gn_infer" and "gn_train"
phase 18; K1, K2, K4 and K4's deterministic variant carry their C4
shapes' measurements under "c4" (and K1's 12000-box lanes under
"c4_train"), the variant its atomic twin's times as atomic_ms /
atomic_device_ms and its kernels' as roi_reach_kernel_device_ms /
roi_window_accum_det_kernel_device_ms with their events a call), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
No single PyTorch call computes any of K1-K6 (there is no torchvision),
so every kernel's library_ms is null. --profile-train adds a torch.profiler
run of one more training step, printing its device time by kernel and
K4's launches in it, then the host time of each stage (forward, backward,
update) of 4 more steps.
--clip-gradients sets phase 5's CLIP_GRADIENTS.

TF32 is off for both cuDNN convolutions and matmuls
(torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 =
False), so the float32 checks of phases 2 and 3 run in full float32.
"""

import argparse
import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH = 2
CANVAS = (832, 1344)
IM_INFO = (800.0, 1333.0, 1.6)
MAIN_RUNS = 3
# Phase 7: the synthetic val set's size and the engine's batch.
ENGINE_IMAGES = 48
ENGINE_BATCH = 8
TRAIN_STEPS = 3
# Phase 8: the synthetic training set's size and train_net_step's steps.
TRAIN_NET_IMAGES = 16
TRAIN_NET_STEPS = 8
# Phases 9 and 10: the synthetic person-keypoints sets (val: about 24
# images, batch ENGINE_BATCH; train: 16 images, 8 steps).
KPS_ENGINE_IMAGES = 24
KPS_VAL = "keypoints_coco_2017_val"
# Phase 12: the C4 engine's synthetic val set (batch ENGINE_BATCH).
C4_ENGINE_IMAGES = 24
# Phases 15-18: the repository's X-152 and GN yamls, the X-152 engine's
# synthetic val set, and train_net_step's steps for both.
X152_YAML = "configs/baselines/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x.yaml"
GN_YAML = "configs/gn_baselines/scratch_e2e_mask_rcnn_R-50-FPN_3x_gn.yaml"
X152_ENGINE_IMAGES = 16
MODEL_TRAIN_STEPS = 4
# Phase 3's tiny ResNeXt and GN models on the mask_rcnn_r50_fpn preset:
# ResNeXt-50 with the X-101-32x8d yamls' group plan, and the GN scratch
# yaml's model (GN body with no stage frozen, GN FPN, the Xconv1fc_gn box
# head and the v1up4convs_gn mask head).
RESNEXT_TINY = ["RESNETS.NUM_GROUPS", "32", "RESNETS.WIDTH_PER_GROUP", "8",
                "RESNETS.STRIDE_1X1", "False"]
GN_TINY = ["RESNETS.USE_GN", "True", "RESNETS.FREEZE_AT", "0",
           "FPN.USE_GN", "True",
           "FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_Xconv1fc_gn_head",
           "MRCNN.ROI_MASK_HEAD",
           "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs_gn"]
# Global-norm gradient clipping of the training main path (the cfg's
# from-scratch setting, SOLVER.CLIP_GRADIENTS; Detectron's preset has none).
# From random weights with no trained BN statistics the warm-up step's loss
# is over a thousand, and without clipping (--clip-gradients 0) its update
# sends the next step's proposals to NaN on an H100, which stops the run
# with a device-side index assert in the ladder's level lookup.
CLIP_GRADIENTS = 10.0
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s, and FLOP/s by
# operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Phase 3 holds every ReLU input of a float32 training step within this
# share of its call's largest float64 input (the float32 forward's rounding,
# grown through the body, is ~1e-4 of it at res5 on these inputs).
ACT_REL = 1e-3
# Flops of one IoU test in K1 (4 max/min, 4 add/sub for the extents, 2
# clamps, 1 multiply for the intersection, 2 add/sub for the union, 1
# divide).
NMS_PAIR_FLOPS = 14
FUSED_RES2 = ["TPU.FUSED_RES2", "True"]
# Multiply-adds per pixel of the res2 stage (64 -> 256): block 0 is
# 4,096 + 36,864 + 16,384 + 16,384 (branch2a, 2b, 2c, branch1), blocks 1
# and 2 are 16,384 + 36,864 + 16,384 each.
RES2_MACS = 4096 + 36864 + 2 * 16384 + 2 * (2 * 16384 + 36864)
RES2_WEIGHTS = RES2_MACS      # one weight per multiply-add of a pixel
RES2_BIASES = 3 * (64 + 64 + 256)
# Names of the port's CUDA kernels (csrc/*.cu), as the profiler lists them.
PORT_KERNELS = ("nms_iou_mask_kernel", "nms_scan", "roi_window_pool_kernel",
                "roi_window_accum_kernel", "roi_window_accum_det_kernel",
                "roi_reach_kernel", "stem_pool", "fused_res2")


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


def device_kernels(fn, reps=10):
    """torch.profiler's device events of reps fn() calls, each after a
    synchronize as cuda_ms times them, recorded after two warm-up calls
    under the profiler (without them it missed some calls' kernels, 8 of
    10 for K4's deterministic variant): {event name: (device ms a call,
    events a call)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=reps,
                                   repeat=1)) as prof:
        for _ in range(2 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_ms(fn, reps=10):
    """Device milliseconds of one fn() call: the time of the kernels it
    launches, summed from torch.profiler's device events over reps calls
    (device_kernels), over reps. Unlike cuda_ms it leaves out the
    host time of the wrapper between launches, which exceeds a small
    kernel's own time."""
    return sum(ms for ms, _ in device_kernels(fn, reps).values())


def set_cfg(tiny, dtype, extra=(), keypoints=False, c4=False, yaml=None):
    """The mask_rcnn_r50_fpn preset (keypoint_rcnn_r50_fpn with
    `keypoints`, mask_rcnn_r50_c4 with `c4`, the repository's yaml file
    `yaml`), the compute dtype, with `tiny` phase 3's sizes (and a 2-conv,
    64-channel pose head), then `extra`."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core import configs_presets

    config.reset_cfg()
    if yaml:
        config.merge_cfg_from_file(yaml)
    elif keypoints:
        configs_presets.keypoint_rcnn_r50_fpn()
    elif c4:
        configs_presets.mask_rcnn_r50_c4()
    else:
        configs_presets.mask_rcnn_r50_fpn()
    keys = ["TPU.COMPUTE_DTYPE", dtype]
    if tiny and keypoints:
        keys += ["KRCNN.NUM_STACKED_CONVS", "2", "KRCNN.CONV_HEAD_DIM", "64"]
    if tiny:
        keys += ["TEST.RPN_PRE_NMS_TOP_N", "256",
                  "TEST.RPN_POST_NMS_TOP_N", "64",
                  "TEST.DETECTIONS_PER_IM", "20",
                  "TRAIN.BATCH_SIZE_PER_IM", "64",
                  "TRAIN.RPN_PRE_NMS_TOP_N", "256",
                  "TRAIN.RPN_POST_NMS_TOP_N", "64",
                  "TRAIN.RPN_BATCH_SIZE_PER_IM", "64",
                  "TPU.MAX_GT_BOXES", "8",
                  # 3 gt-mask cells per target cell (28 x 28 targets, 14
                  # x 14 for C4): a RoI equal to its gt box (gt boxes are
                  # sampled as RoIs) then samples on cell centres. With an
                  # even ratio it samples midway between two cells, where
                  # a random mask gives targets of 0.5 +- an ulp that the
                  # two devices' matmul orders round to either side of the
                  # 0.5 threshold.
                  "TPU.GT_MASK_SIZE", "42" if c4 else "84"]
    config.merge_cfg_from_list(list(extra) + keys)
    config.assert_and_infer_cfg(make_immutable=False)


def make_tree(seed=0):
    """The calibrated numpy params tree of the cfg's model."""
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    return calibrate_detector_params(init.init_model(seed),
                                     np.random.RandomState(seed))


def make_params(device, dtype, seed=0):
    from detectron_tpu_torch.models import bridge

    return bridge.to_torch(make_tree(seed), device, dtype)


def bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reached_cells(canvas_shape, starts, vy, vx):
    """Distinct canvas cells (b, y, x) that some RoI's weights reach: row
    h and column w of a RoI's window with vy[:, :, h] and vx[:, :, w] not
    all zero. At most the union of the windows; these inputs' cells only."""
    import torch

    B, Hc, Wc, _ = canvas_shape
    dev = starts.device
    rows = vy.ne(0).any(1)                          # (n, WY)
    cols = vx.ne(0).any(1)                          # (n, WX)
    y = starts[:, 1, None].long() + torch.arange(rows.shape[1], device=dev)
    x = starts[:, 2, None].long() + torch.arange(cols.shape[1], device=dev)
    hit = (rows & (y < Hc))[:, :, None] & (cols & (x < Wc))[:, None, :]
    flat = (starts[:, 0, None, None].long() * Hc + y[:, :, None]) * Wc + \
        x[:, None, :]
    mark = torch.zeros(B * Hc * Wc, dtype=torch.bool, device=dev)
    mark[flat[hit]] = True
    return int(mark.sum())


def roi_reach_cells(canvas_shape, starts, vy, vx):
    """Canvas cells K2/K3 read RoI by RoI: for each RoI, the rows from its
    first to its last nonzero vy row times the columns from its first to
    its last nonzero vx column, clipped at the canvas edge. Overlapping
    RoIs each count their shared cells, which reached_cells counts once."""
    import torch

    _, Hc, Wc, _ = canvas_shape

    def span(nonzero, origin, edge):
        idx = torch.arange(nonzero.shape[1], device=nonzero.device)
        lo = torch.where(nonzero, idx, nonzero.shape[1]).min(1).values
        hi = torch.minimum(torch.where(nonzero, idx, -1).max(1).values,
                           edge - 1 - origin.long())
        return (hi - lo + 1).clamp(min=0)

    rows = span(vy.ne(0).any(1), starts[:, 1], Hc)
    cols = span(vx.ne(0).any(1), starts[:, 2], Wc)
    return int((rows * cols).sum())


def window_bound(canvas_shape, itemsize, starts, vy, vx, accumulate):
    """Bound of K2/K3 (pool) or K4 (accumulate, a read-modify-write of the
    f32 gradient canvas) over the RoIs of starts/vy/vx (the active rows
    only). Bytes: the canvas cells their weights reach (reached_cells)
    read once, and written once by K4; origins, weights and pooled rows
    (or cotangent rows) once. Operations: the two contractions over the
    nonzero weights only, in the cheaper order for each RoI, a multiply
    and an add each: P nnz(vx) + nnz(vy) cols (x first) or P nnz(vy) +
    nnz(vx) rows (y first), times 2 C, where rows and cols are the window
    rows and columns some weight reaches."""
    C = canvas_shape[-1]
    rows, P, WY = vy.shape
    WX = vx.shape[-1]
    canvas = reached_cells(canvas_shape, starts, vy, vx) * C * itemsize
    nbytes = canvas * (2 if accumulate else 1) + rows * (
        12 + P * (WY + WX) * itemsize + P * P * C * itemsize)
    nz_y, nz_x = vy.ne(0), vx.ne(0)
    ny, nx = nz_y.sum((1, 2)), nz_x.sum((1, 2))
    x_first = P * nx + ny * nz_x.any(1).sum(1)
    y_first = P * ny + nx * nz_y.any(1).sum(1)
    flops = 2 * C * int(x_first.minimum(y_first).sum())
    return bound(nbytes, flops, "float32" if itemsize == 4 else "bfloat16")


def nms_bound(boxes, valid, keep):
    """Bound of K1: boxes, valid and keep moved once; one IoU test for
    every (kept pivot, later valid box) pair of this data."""
    L, N = valid.shape
    later_valid = valid.flip(1).cumsum(1).flip(1) - valid.int()
    pairs = int((later_valid * keep).sum())
    return bound(L * N * (16 + 1 + 1), pairs * NMS_PAIR_FLOPS, "float32")


# ---------------------------------------------------------------------------
# Phase 2 inputs at the main path's shapes
# ---------------------------------------------------------------------------

def nms_lanes(rng, L, N, device, cut=True):
    """L lanes of N random boxes, 97% valid; with `cut`, the lanes end at
    a random index past N / 2 (invalid slots after it)."""
    import torch

    x1 = rng.uniform(0, 1300, (L, N))
    y1 = rng.uniform(0, 780, (L, N))
    wh = rng.uniform(8, 300, (L, N, 2))
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
    valid = rng.rand(L, N) < 0.97
    if cut:
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
    """Phase 2. Returns {kernel name: entry} with max_abs_err (over every
    checked shape), and ms, plain_ms, bound_ms, bound_by at the primary
    shape; prints one line per checked shape."""
    import torch

    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    rng = np.random.RandomState(0)
    entries = {}

    def record(name, shape, err, fn, plain, bnd, primary, tag=None, **more):
        """Times the kernel's wrapper fn (CUDA events per call, and device
        time alone) and its plain version, and prints and keeps them (with
        the fields `more`): as the kernel's entry at its primary shape, and
        under entry[tag] (the C4 paths' shapes: "c4")."""
        ms, dev, plain_ms = cuda_ms(fn, 20), device_ms(fn), cuda_ms(plain, 3)
        print("check {} {}: max_abs_err={} kernel_ms={:.4f} device_ms={:.4f} "
              "plain_ms={:.4f} bound_ms={:.4f} ({}){}".format(
                  name, shape, err, ms, dev, plain_ms, *bnd, "".join(
                      " {}={:.4f}".format(k, v) for k, v in more.items())))
        e = entries.setdefault(name, {"max_abs_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], float(err))
        fields = dict(shape=shape, ms=ms, device_ms=dev, plain_ms=plain_ms,
                      bound_ms=bnd[0], bound_by=bnd[1], **more)
        if primary:
            e.update(fields)
        if tag:
            e[tag] = dict(fields, max_abs_err=float(err))

    # K1: the RPN's five levels stacked into one call, as the paths launch
    # it (L = 5B lanes; inference N = 1000, training N = 2000; P6's lanes
    # hold 819 boxes), one level alone (L = B; N = 1000, 819 at P6, 2000),
    # and the detection tail (L = B * 80 classes, N = K = 400). Then the
    # long lanes of the default cfg (RPN_PRE_NMS_TOP_N 12000, which the
    # preset lowers): the five levels stacked, P2-P4 at 12000 boxes, P5 at
    # 3276 and P6 at 819, and one level of 12000, each lane valid to its
    # end. Exact. The stacked and the long shapes draw from generators of
    # their own, so that the other shapes' inputs stay those of earlier
    # runs.
    stack_rng = np.random.RandomState(10)
    long_rng = np.random.RandomState(11)
    for (L, N), thr, levels in (((BATCH, 1000), 0.7, None),
                                ((BATCH, 819), 0.7, None),
                                ((BATCH, 2000), 0.7, None),
                                ((BATCH * 80, 400), 0.5, None),
                                ((5 * BATCH, 1000), 0.7, (1000,) * 4 + (819,)),
                                ((5 * BATCH, 2000), 0.7, (2000,) * 4 + (819,)),
                                ((5 * BATCH, 12000), 0.7,
                                 (12000,) * 3 + (3276, 819)),
                                ((BATCH, 12000), 0.7, (12000,)),
                                ((BATCH, 6000), 0.7, (6000,))):
        long_lane = N > 2048
        boxes, valid = nms_lanes(long_rng if long_lane else
                                 stack_rng if levels else rng, L, N, device,
                                 cut=not long_lane)
        for i, n in enumerate(levels or ()):
            valid[i * BATCH:(i + 1) * BATCH, n:] = False
        got = nms_kernel.nms_keep_mask(boxes, valid, thr)
        ref = nms_kernel.nms_keep_mask_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got != ref).sum())
        shape = "L={} N={}".format(L, N)
        if levels and len(levels) == 5:
            shape += " (5 RPN levels stacked, lanes of {})".format(
                "/".join(str(n) for n in levels))
        elif long_lane:
            # The C4 models' single-level RPN: TEST 6000, TRAIN 12000.
            shape += " (one level; C4 RPN {})".format(
                "inference" if N == 6000 else "training")
        if err:
            raise AssertionError("K1 nms_keep_mask disagrees with its plain "
                                 "version at {}: {} keep bits".format(shape,
                                                                      err))
        record("nms_keep_mask", shape, err,
               lambda: nms_kernel.nms_keep_mask(boxes, valid, thr),
               lambda: nms_kernel.nms_keep_mask_plain(boxes, valid, thr),
               nms_bound(boxes, valid, ref),
               primary=(levels is not None and N == 1000),
               tag={(BATCH, 6000): "c4", (BATCH, 12000): "c4_train"}.get(
                   (L, N)))
        del boxes, valid, got, ref

    def pool_check(name, fn, plain, args, rows, shape, bnd, primary,
                   tag=None):
        reach = roi_reach_cells(args[0].shape, *(t[rows[0]:rows[1]]
                                                 for t in args[1:]))
        shape += " (read RoI by RoI: {:.1f} MB of canvas)".format(
            reach * args[0].shape[-1] * args[0].element_size() / 1e6)
        got = fn(*args)[rows[0]:rows[1]].float()
        ref = plain(*args)[rows[0]:rows[1]].float()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        # 2 bf16 ulps of each value plus a floor for cancelling sums.
        tol = ref.abs() * (1.0 / 64) + 1e-3 * float(ref.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((diff > tol).any()):
            raise AssertionError("{} disagrees with its plain version at {}:"
                                 " max_abs_err {}".format(
                                     name, shape, float(diff.max())))
        record(name, shape, float(diff.max()), lambda: fn(*args),
               lambda: plain(*args), bnd, primary, tag)

    # K2: base sweep, box head (P = 7, N = B * 1000) and mask head (P = 14,
    # N = B * 100) at inference, box (N = B * 512) and mask (N = B * 128)
    # in training, bf16 on a full-size canvas.
    for pooled, n in ((7, BATCH * 1000), (14, BATCH * 100),
                      (7, BATCH * 512), (14, BATCH * 128)):
        canvas, starts, vy, vx, window = ladder_inputs(
            rng, n, pooled, None, device, torch.bfloat16)
        pool_check("roi_window_pool", roi_align_kernel.roi_window_pool,
                   roi_align_kernel.roi_window_pool_plain,
                   (canvas, starts, vy, vx), (0, n),
                   "P={} N={} window={} canvas={}".format(
                       pooled, n, window, tuple(canvas.shape)),
                   window_bound(canvas.shape, 2, starts, vy, vx, False),
                   (pooled, n) == (7, BATCH * 1000))

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
                   window_bound(canvas.shape, 2, *(t[rows[0]:rows[1]] for t in
                                                   (starts, vy, vx)), False),
                   (wy, wx) == (64, 48))

    def det_accum_check(shape, zero, starts, ct, vy, vx, rows, bnd, primary,
                        tag=None):
        """K4's deterministic variant on K4's inputs: two calls bit-equal,
        within K4's tolerance of the plain version; timed beside the atomic
        kernel on the same inputs."""
        rk = roi_align_kernel
        args = (starts, ct, vy, vx, rows)
        runs = [rk.roi_window_accum_det(zero.clone(), *args)
                for _ in range(2)]
        ref = rk.roi_window_accum_plain(zero.clone(), *args)
        torch.cuda.synchronize()
        err = float((runs[0] - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        if not torch.equal(runs[0], runs[1]) or err > tol or not bool(
                torch.isfinite(runs[0]).all()):
            raise AssertionError("K4's deterministic variant at {}: two "
                                 "calls equal {}, max_abs_err {} (bound {})"
                                 .format(shape, torch.equal(*runs), err,
                                         tol))
        got = runs[0]
        # The variant's two kernels by name, with their events a call
        # (1 each when the profiler sees every launch).
        named = {}
        for key, (ms, count) in device_kernels(
                lambda: rk.roi_window_accum_det(got, *args)).items():
            kernel = next((k for k in ("roi_reach_kernel",
                                       "roi_window_accum_det_kernel")
                           if k in key), "other")
            old = named.get(kernel, (0.0, 0.0))
            named[kernel] = (old[0] + ms, old[1] + count)
        record("roi_window_accum_det", shape + ", two calls bit-equal", err,
               lambda: rk.roi_window_accum_det(got, *args),
               lambda: rk.roi_window_accum_plain(ref, *args), bnd, primary,
               tag, atomic_ms=cuda_ms(lambda: rk.roi_window_accum(got, *args),
                                      20),
               atomic_device_ms=device_ms(
                   lambda: rk.roi_window_accum(got, *args)),
               **{"{}_{}".format(k, f): v[i] for k, v in named.items()
                  for i, f in enumerate(("device_ms", "events"))})

    # K4: the training backward's window accumulate into the f32 gradient
    # canvas: base window at box (P = 7, N = B * 512) and mask (P = 14,
    # N = B * 128) shapes, and the (16, 96) fix-up rung with 12% of a
    # 1024-row capacity active. Atomic adds: within 1e-5 max|ref| + 1e-6.
    # At each shape K4's deterministic variant too, and at the rung also
    # rows [300, 423) (its entry: the box shape's).
    for pooled, n, window, rows in ((7, BATCH * 512, None, None),
                                    (14, BATCH * 128, None, None),
                                    (7, 1024, (16, 96), (0, 123))):
        canvas, starts, vy, vx, window = ladder_inputs(
            rng, n, pooled, window, device, torch.float32)
        ct = torch.randn((n, pooled, pooled, canvas.shape[-1]),
                         device=device, generator=torch.Generator(
                             device).manual_seed(n + pooled))
        zero = torch.zeros_like(canvas)
        got = roi_align_kernel.roi_window_accum(zero.clone(), starts, ct, vy,
                                                vx, rows)
        ref = roi_align_kernel.roi_window_accum_plain(zero.clone(), starts,
                                                      ct, vy, vx, rows)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        shape = "P={} N={} rows={} window={} canvas={}".format(
            pooled, n, rows or (0, n), window, tuple(canvas.shape))
        if not bool(torch.isfinite(got).all()) or err > tol or \
                float(ref.abs().max()) == 0.0:
            raise AssertionError("K4 roi_window_accum disagrees with its "
                                 "plain version at {}: max_abs_err {} > {}"
                                 .format(shape, err, tol))
        lo, hi = rows or (0, n)
        record("roi_window_accum", shape, err,
               lambda: roi_align_kernel.roi_window_accum(
                   got, starts, ct, vy, vx, rows),
               lambda: roi_align_kernel.roi_window_accum_plain(
                   ref, starts, ct, vy, vx, rows),
               window_bound(canvas.shape, 4, *(t[lo:hi] for t in
                                               (starts, vy, vx)), True),
               (pooled, rows) == (7, None))
        # The variant also at a row range that starts past row 0.
        for r in (rows, (300, 423)) if rows else (rows,):
            lo, hi = r or (0, n)
            det_accum_check(
                "P={} N={} rows={} window={} canvas={}".format(
                    pooled, n, (lo, hi), window, tuple(canvas.shape)),
                zero, starts, ct, vy, vx, r,
                window_bound(canvas.shape, 4, *(t[lo:hi] for t in
                                                (starts, vy, vx)), True),
                (pooled, r) == (7, None))
        del canvas, zero, got, ref

    check_c4_window_kernels(device, pool_check, record, det_accum_check)
    check_fused_kernels(device, rng, record)
    return entries


def c4_roi_inputs(rng, n, device, dtype):
    """The C4 models' RoIAlign inputs (ops/roi_align.py): a random res4 map
    (B, 52, 84, 1024) of the CANVAS, n RoIs of detector-like sizes, and
    each RoI's window: the whole map, origin (img, 0, 0), with its 14 x 14
    weights at the adaptive sampling ratio 0 (at most 4 x 4 samples a
    bin) in `dtype`."""
    import torch

    from detectron_tpu_torch.ops import roi_align as ra

    H, W = CANVAS[0] // 16, CANVAS[1] // 16
    feat = torch.randn((BATCH, H, W, 1024), generator=torch.Generator(
        device).manual_seed(n), device=device, dtype=dtype)
    xy = rng.uniform(0, 1200, (n, 2)) * [1.0, 0.6]
    wh = rng.lognormal(4.5, 0.8, (n, 2)).clip(4, 800)
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
        np.float32)).to(device)
    vy, vx = ra.roi_weights(rois, 1.0 / 16, 14, 0, H, W)
    img = torch.from_numpy(rng.randint(0, BATCH, n).astype(np.int32)).to(
        device)
    zero = torch.zeros_like(img)
    starts = torch.stack([img, zero, zero], -1).contiguous()
    return feat, starts, vy.to(dtype).contiguous(), vx.to(dtype).contiguous()


def check_c4_window_kernels(device, pool_check, record, det_accum_check):
    """Phase 2, the C4 models' single-level RoIAlign (ops/roi_align.py):
    K2 with one window spanning the (B, 52, 84, 1024) res4 map, P = 14,
    bf16, at the inference box head's N = B * 1000 and mask head's B *
    100; K4, its backward into the f32 map gradient, at the training box
    (N = B * 512) and mask (B * 128) shapes, and K4's deterministic variant
    at both. Tolerances as the FPN shapes'."""
    import torch

    from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

    c4_rng = np.random.RandomState(12)
    for n in (BATCH * 1000, BATCH * 100):
        feat, starts, vy, vx = c4_roi_inputs(c4_rng, n, device,
                                             torch.bfloat16)
        pool_check("roi_window_pool", rk.roi_window_pool,
                   rk.roi_window_pool_plain, (feat, starts, vy, vx), (0, n),
                   "C4 P=14 N={} window=(52, 84), the whole res4 map {}"
                   .format(n, tuple(feat.shape)),
                   window_bound(feat.shape, 2, starts, vy, vx, False), False,
                   "c4" if n == BATCH * 1000 else None)
        del feat, starts, vy, vx
    for n in (BATCH * 512, BATCH * 128):
        feat, starts, vy, vx = c4_roi_inputs(c4_rng, n, device,
                                             torch.float32)
        ct = torch.randn((n, 14, 14, feat.shape[-1]), device=device,
                         generator=torch.Generator(device).manual_seed(n))
        zero = torch.zeros_like(feat)
        got = rk.roi_window_accum(zero.clone(), starts, ct, vy, vx)
        ref = rk.roi_window_accum_plain(zero.clone(), starts, ct, vy, vx)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        shape = "C4 P=14 N={} window=(52, 84), f32 map gradient {}".format(
            n, tuple(feat.shape))
        if not bool(torch.isfinite(got).all()) or err > tol or \
                float(ref.abs().max()) == 0.0:
            raise AssertionError("K4 roi_window_accum disagrees with its "
                                 "plain version at {}: max_abs_err {} > {}"
                                 .format(shape, err, tol))
        record("roi_window_accum", shape, err,
               lambda: rk.roi_window_accum(got, starts, ct, vy, vx),
               lambda: rk.roi_window_accum_plain(ref, starts, ct, vy, vx),
               window_bound(feat.shape, 4, starts, vy, vx, True), False,
               "c4" if n == BATCH * 512 else None)
        det_accum_check(shape, zero, starts, ct, vy, vx, None,
                        window_bound(feat.shape, 4, starts, vy, vx, True),
                        False, "c4" if n == BATCH * 512 else None)
        del feat, zero, got, ref, ct


def bf16_close(got, ref):
    """K6's bf16 tolerance: |got - ref| within 2^-7 |ref| + 2^-6 max|ref|
    (an ulp of the value plus 2 to 4 at the top magnitude), and under 20%
    of the elements differing. The kernel and cuDNN sum in other orders,
    so a bf16 rounding may fall the other way, later convs carry that on,
    and a residual add that cancels keeps its operands' ulps; a systematic
    rounding fault would move about half the elements. Returns (ok,
    max_abs_err, share differing)."""
    import torch

    d = (got.float() - ref.float()).abs()
    top = float(ref.float().abs().max())
    ok = bool((d <= 2.0 ** -7 * ref.float().abs() + 2.0 ** -6 * top).all()) \
        and bool(torch.isfinite(got).all())
    share = float((d > 0).float().mean())
    return ok and share < 0.2, float(d.max()), share


def res2_stage(params, device, rng):
    """The model's res2 params with random affines, so the fold and the
    zero halo (relu(bias) != 0 outside the image) are exercised."""
    import torch

    stage = params["body"]["res2"]
    for bp in stage:
        for k in [k for k in bp if k.endswith("_bn")]:
            c = bp[k]["s"].shape[0]
            bp[k] = {"s": torch.tensor(rng.uniform(0.5, 1.5, c),
                                       dtype=torch.float32, device=device),
                     "b": torch.tensor(rng.uniform(-0.3, 0.3, c),
                                       dtype=torch.float32, device=device)}
    return stage


def check_fused_kernels(device, rng, record):
    """Phase 2, K5 and K6 at the TPU.FUSED_RES2 path's full-width shapes:
    the stem conv's output (B, 416, 672, 64) and res2's input
    (B, 208, 336, 64), bf16; K6 also in f32 at the phase-3 tiny canvas's
    res2 shape (B, 64, 80, 64). Prints the yardstick: the port's unfused
    stem post-ops + res2 (cuDNN convs) beside K5 + K6."""
    import torch

    from detectron_tpu_torch.models import layers as L
    from detectron_tpu_torch.models import resnet
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk

    gen = torch.Generator(device).manual_seed(5)
    Hp, Wp = CANVAS[0] // 2, CANVAS[1] // 2
    x = (torch.randn((BATCH, Hp, Wp, 64), generator=gen, device=device)
         * 2.0).to(torch.bfloat16)
    s = torch.tensor(rng.uniform(0.5, 1.5, 64), dtype=torch.float32,
                     device=device)
    b = torch.tensor(rng.uniform(-0.5, 0.5, 64), dtype=torch.float32,
                     device=device)
    got = fk.stem_pool(x, s, b)
    ref = fk.stem_pool_plain(x, s, b)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K5 stem_pool disagrees with its plain version "
                             "at {}: {} elements".format(
                                 tuple(x.shape), int((got != ref).sum())))
    # Bytes: x read once, the pooled output written once, s and b. Ops: a
    # multiply, an add and a ReLU per input element, 8 max per output.
    record("stem_pool", "x={} bf16 -> {}".format(tuple(x.shape),
                                                  tuple(got.shape)),
           0.0, lambda: fk.stem_pool(x, s, b),
           lambda: fk.stem_pool_plain(x, s, b),
           bound(2 * (x.numel() + got.numel()) + 2 * 64 * 4,
                 3 * x.numel() + 8 * got.numel(), "float32"), True)

    params = make_params(device, torch.bfloat16)
    stage = res2_stage(params, device, rng)
    for dtype, shape in ((torch.bfloat16, (BATCH, Hp // 2, Wp // 2, 64)),
                         (torch.float32, (BATCH, 64, 80, 64))):
        h = torch.randn(shape, generator=gen, device=device).relu().to(dtype)
        folded = fk.fold_res2_weights(stage, dtype)
        got = fk.fused_res2(h, folded)
        ref = fk.fused_res2_plain(h, folded)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            ok, err, share = bf16_close(got, ref)
        else:
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and \
                err <= 1e-5 * float(ref.abs().max())
            share = float(((got - ref) != 0).float().mean())
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if not ok:
            raise AssertionError("K6 fused_res2 disagrees with its plain "
                                 "version at {} {}: max_abs_err {}, share "
                                 "differing {}".format(shape, name, err,
                                                       share))
        pixels = shape[0] * shape[1] * shape[2]
        item = h.element_size()
        record("fused_res2", "x={} {} (share differing {:.4f}, max|ref| "
               "{:.3f})".format(shape, name, share,
                                float(ref.float().abs().max())),
               err, lambda: fk.fused_res2(h, folded),
               lambda: fk.fused_res2_plain(h, folded),
               bound(pixels * (64 + 256) * item + RES2_WEIGHTS * item
                     + RES2_BIASES * 4, 2 * RES2_MACS * pixels,
                     "bfloat16" if dtype == torch.bfloat16 else "float32"),
               dtype == torch.bfloat16)

    # Yardstick (not library_ms: no single PyTorch call computes K5 or
    # K6): the port's unfused path on the same stem-conv output.
    bn = params["body"]["res_conv1_bn"]

    def unfused():
        y = L.max_pool(L.relu(resnet._norm(bn, x)), 3, 2, 1)
        for bp in stage:
            y = resnet.apply_bottleneck(bp, y, 1)
        return y

    def fused():
        return fk.fused_res2(fk.stem_pool(x, bn["s"], bn["b"]),
                             fk.fold_res2_weights(stage, torch.bfloat16))

    print("yardstick at x={} bf16: unfused stem post-ops + res2 (cuDNN) "
          "{:.4f} ms; K5 + fold + K6 {:.4f} ms".format(
              tuple(x.shape), cuda_ms(unfused, 20), cuda_ms(fused, 20)))


# ---------------------------------------------------------------------------
# Phases 3, 4 and 5
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


def heatmap_diff(a, b):
    """(b's valid detections that a has with a box within 1e-2 px and a
    score within 1e-3, the worst heatmap diff among them over that
    detection's max|b heatmap|)."""
    n, worst = 0, 0.0
    for i in range(b["valid"].shape[0]):
        va, vb = a["valid"][i], b["valid"][i]
        for k in range(int(vb.sum())):
            d = (a["boxes"][i][va] - b["boxes"][i][vb][k]).abs().amax(1)
            if len(d) == 0:
                continue
            j = int(d.argmin())
            if float(d[j]) > 1e-2 or abs(float(
                    a["scores"][i][va][j] - b["scores"][i][vb][k])) > 1e-3:
                continue
            ref = b["kps_heatmaps"][i][vb][k]
            worst = max(worst, float(
                (a["kps_heatmaps"][i][va][j] - ref).abs().max()) /
                float(ref.abs().max()))
            n += 1
    return n, worst


def ladder_statics(pooled, sampling_ratio):
    """The ladder's static arguments after the features for RoIAlign at
    pooled x pooled on the CANVAS's P2-P5 levels."""
    from detectron_tpu_torch.core.config import cfg

    return ((0.25, 0.125, 0.0625, 0.03125), pooled, sampling_ratio,
            cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
            cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
            tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS))


def ladder_routes(rois, dims, static):
    """RoIs (N, 4) on the CPU per ladder route (the base window, each
    fix-up rung (K3), the exact gather for slivers), as the ladder routes
    them for `static` (ladder_statics) on levels of `dims`; and the CPU's
    float32 base-window weights (vy, vx)."""
    import torch

    from detectron_tpu_torch.ops import windowed_roi as win

    geom = win.ladder_geom(dims, static[-1])
    _, _, vy, vx, ok = win.window_params(rois, geom, *static[:-1],
                                         geom["wy_base"], geom["wx_base"],
                                         torch.float32)
    covered, rid = win.rung_route(rois, geom, static[0], *static[3:-1])
    routes = {"base": int(ok.sum()), "sliver": int((~ok & ~covered).sum())}
    for r, shape in enumerate(geom["fix_rungs"]):
        routes["rung {}".format(shape)] = int((~ok & covered & (rid == r))
                                              .sum())
    return routes, (vy, vx)


def check_ladder_grad(device):
    """Phase 3: the RoIAlign ladder's backward as the training path runs
    it (K4 over the base window and each fix-up rung, autograd of the
    exact gather for slivers), through its autograd Function on `device`
    in float32, against the same backward on the CPU plain path in
    float64. The full-width box branch: the P2-P5 pyramid of BATCH images
    in the CANVAS, 512 RoIs per image of detector-like sizes and aspect
    ratios, a N(0, 1) cotangent. Each level's gradient within 1e-4 of its
    largest float64 value: float32 sums (K4's atomic adds and the gather's
    index_put add in an order that changes from run to run), and float32
    sample coordinates that the two devices round differently (fused
    multiply-adds on the card), so a bilinear weight may differ by a few
    ulps of a coordinate (~3e-5 at P2's 336 columns)."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.ops import windowed_roi as win

    rng = np.random.RandomState(4)
    n, C = 512, 256
    dims = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    pyramid = [torch.from_numpy(rng.randn(BATCH, h, w, C).astype(
        np.float32)).to(device).requires_grad_(True) for h, w in dims]
    xy = rng.uniform(0, min(CANVAS) * 0.75, (BATCH, n, 2))
    wh = rng.lognormal(4.5, 0.8, (BATCH, n, 2)).clip(4, 800)
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    ct = torch.from_numpy(rng.randn(BATCH, n, 7, 7, C).astype(np.float32))
    static = ladder_statics(7, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)

    # RoIs per route, as the ladder routes them, and how far the device's
    # float32 base-window weights are from the CPU's.
    geom = win.ladder_geom(dims, static[-1])
    flat = rois.reshape(-1, 4)
    routes, (vy, vx) = ladder_routes(flat, dims, static)
    _, _, vy_d, vx_d, _ = win.window_params(flat.to(device), geom,
                                            *static[:-1], geom["wy_base"],
                                            geom["wx_base"], torch.float32)
    weight_diff = max(float((vy_d.cpu() - vy).abs().max()),
                      float((vx_d.cpu() - vx).abs().max()))

    out = win.multilevel_roi_align_ladder_trainable(
        pyramid, static[0], rois.to(device), *static[1:])
    got = torch.autograd.grad(out, pyramid, ct.to(device))
    ref = win._ladder_backward(ct.double(), rois, dims, *static)
    # Relative to each level's largest gradient; a level no RoI reaches
    # must get exact zeros.
    errs = [float((g.double().cpu() - r).abs().max()) /
            (float(r.abs().max()) or 1.0) for g, r in zip(got, ref)]
    print("ladder backward check (float32 {} vs cpu float64, {} x {} canvas, "
          "{} RoIs, RoIs per route {}): worst diff / max|ref| per level {}; "
          "largest base-window weight diff, {} vs cpu float32, {:.3e}".format(
              device, *CANVAS, flat.shape[0], routes,
              ["{:.3e}".format(e) for e in errs], device, weight_diff))
    if max(errs) > 1e-4 or routes["sliver"] == 0 or \
            sum(routes.values()) - routes["base"] - routes["sliver"] == 0:
        raise AssertionError("the ladder's backward disagrees with its plain "
                             "version, or missed a route: {} {}".format(
                                 errs, routes))


def check_small_input(device, extra=(), keypoints=False, c4=False,
                      pixel_scale=0.3, cls_scale=1.0):
    """Phase 3: GPU kernels vs CPU plain versions, tiny float32 config
    (with the cfg keys `extra`; Keypoint R-CNN with `keypoints`, whose
    matched detections' heatmaps must agree within 1e-4 of max|cpu|; Mask
    R-CNN R-50-C4 with `c4`). With TPU.FUSED_RES2 the GPU run must launch
    K6 (the "auto" mode in float32). Images N(0, pixel_scale); cls_score's
    weights times cls_scale (a ResNeXt or GN body's random-init features
    stay near unit scale, and its class logits then barely leave their
    biases)."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk

    set_cfg(tiny=True, dtype="float32", extra=extra, keypoints=keypoints,
            c4=c4)
    tree = make_tree()
    if keypoints:
        # One class: its bias up by 3, or on these low-contrast inputs
        # few of its scores pass TEST.SCORE_THRESH.
        tree["box_outs"]["cls_score"]["b"][1] += 3.0
    if c4:
        # The res5 head's features score no class over TEST.SCORE_THRESH
        # on these inputs under the calibration's background bias:
        # every foreground bias up by 5.
        tree["box_outs"]["cls_score"]["b"][1:] += 5.0
    tree["box_outs"]["cls_score"]["w"] *= np.float32(cls_scale)
    rng = np.random.RandomState(1)
    # x0.3, not the main path's x20: random weights without trained BN
    # statistics grow activations through a ResNet body, and larger inputs
    # saturate every score at 1.0, which would hide a mis-ordering.
    images = rng.randn(BATCH, 256, 320, 3).astype(np.float32) * pixel_scale
    im_info = np.array([[250.0, 310.0, 1.0]] * BATCH, np.float32)
    outs = {}
    k6 = fk.fused_res2.launches
    for dev in ("cpu", device):
        params = bridge.to_torch(tree, dev, torch.float32)
        outs[dev] = {k: v.cpu() for k, v in det.detect_graph(
            params, torch.from_numpy(images).to(dev),
            torch.from_numpy(im_info).to(dev)).items()}
    k6 = fk.fused_res2.launches - k6
    cpu, gpu = outs["cpu"], outs[device]
    frac = match_detections(gpu, cpu)
    n_cpu, n_gpu = int(cpu["valid"].sum()), int(gpu["valid"].sum())
    hm_err = heatmap_diff(gpu, cpu) if keypoints else None
    print("small-input check (float32, 2 x 256 x 320{}{}): valid cpu={} "
          "gpu={} matched={:.4f}, K6 launches {}{}".format(
              ", Keypoint R-CNN" if keypoints else
              ", Mask R-CNN R-50-C4" if c4 else "",
              "".join(", {} {}".format(*extra[i:i + 2])
                      for i in range(0, len(extra), 2)),
              n_cpu, n_gpu, frac, k6,
              "" if hm_err is None else ", heatmaps of {} matched "
              "detections: worst diff / max|cpu| {:.3e}".format(*hm_err)))
    if n_cpu == 0 or frac < 0.95 or abs(n_cpu - n_gpu) > 0.05 * n_cpu:
        raise AssertionError("GPU detect_graph disagrees with the CPU plain "
                             "path on the small input")
    if keypoints and (hm_err[0] < 0.95 * n_cpu or hm_err[1] > 1e-4):
        raise AssertionError("GPU keypoint heatmaps disagree with the CPU "
                             "plain path: {}".format(hm_err))
    if k6 != int(FUSED_RES2[0] in extra):
        raise AssertionError("K6 launched {} times in the small-input "
                             "check".format(k6))


def _flat(tree):
    from detectron_tpu_torch.parallel import optimizer as opt

    return [t for _, t in opt.flatten(tree)]


def _small_train_run(tree, dev, dtype, H, W, masks=None):
    """One train_step of the tiny configuration on `dev` in `dtype`:
    ([params, grads, update], each a flat list of CPU float64 tensors, the
    update being the SGD step p - p' before it is rounded into the params;
    the losses; the input of every layers.relu call, on the CPU, in call
    order). With `masks` (bool tensors, one per relu call, in that order),
    each relu keeps the elements of its mask instead of its positive
    ones: x * mask, whose gradient is the mask."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import bridge, layers, train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    cfg.TPU.COMPUTE_DTYPE = str(dtype).split(".")[-1]
    params = bridge.to_torch(tree, dev, dtype)
    batch = synthetic_train_batch(BATCH, H, W, dev, np.random.RandomState(2),
                                  1.0)
    # N(0, 1) images, not the synthetic N(0, 20): random weights without
    # trained BN statistics make losses and gradients grow with the input
    # scale, and this check is about the kernels, not the scale.
    batch["images"] = batch["images"] / 20.0
    draws = train_graph.make_draws(torch.Generator().manual_seed(3), BATCH,
                                   (H, W), cfg.TPU.MAX_GT_BOXES, dev)
    relu_inputs = []

    def relu(x):
        relu_inputs.append(x.detach().cpu())
        if masks is None:
            return torch.relu(x)
        m = masks[len(relu_inputs) - 1]
        if m.shape != x.shape:
            raise AssertionError("relu call {}: mask {} for input {}".format(
                len(relu_inputs) - 1, tuple(m.shape), tuple(x.shape)))
        return x * m.to(x.device, x.dtype)

    plain_relu, layers.relu = layers.relu, relu
    try:
        _, parts, grads = ts.loss_and_grads(params, batch, draws)
    finally:
        layers.relu = plain_relu
    _, state, _ = opt.apply_updates(params, grads,
                                    opt.init_opt_state(params))
    flat = [[t.detach().double().cpu() for t in _flat(x)]
            for x in (params, grads, state["momentum"])]
    return flat, {k: float(v) for k, v in parts.items()}, relu_inputs


def relu_flips(inputs, ref):
    """Two runs' relu inputs, call by call: (elements whose sign (> 0)
    differs, the largest |ref| at such an element over its call's max|ref|,
    the largest |input - ref| over its call's max|ref|)."""
    n, worst, err = 0, 0.0, 0.0
    for x, r in zip(inputs, ref):
        x = x.double()
        scale = float(r.abs().max())
        if scale == 0.0:
            continue
        err = max(err, float((x - r).abs().max()) / scale)
        flip = (x > 0) != (r > 0)
        if bool(flip.any()):
            n += int(flip.sum())
            worst = max(worst, float(r[flip].abs().max()) / scale)
    return n, worst, err


def check_small_train(device, keypoints=False, c4=False, extra=()):
    """Phase 3, training: one float32 train_step on the GPU (kernels)
    against the same step on the CPU (plain versions), with the same
    params, batch and sampling draws; gradients against the CPU plain path
    in float64. The GPU runs once with cuDNN off (PyTorch's own CUDA
    convolutions) and once with cuDNN, the main path's convolution
    library. A ReLU whose input lies within float32 rounding of 0 may take
    the other side on one device (a sign flip): its gradient then moves by
    a whole term, not by rounding. So each float32 run is held against a
    float64 run that takes that run's ReLU signs (x * mask), and its ReLU
    inputs within ACT_REL of the float64 run's (so a flip is only ever at
    an input that close to 0). With `keypoints`, Keypoint R-CNN (the tiny
    pose head; loss_kps among the losses checked); with `c4`, Mask R-CNN
    R-50-C4 (the res5 head, shared by the v0upshare mask head; single-level
    RoIAlign, K4 in its backward), its RPN deltas calibrated: uncalibrated,
    the decode of rail-clipped deltas moves the proposals by ~4e-3 px
    between a float32 and a float64 run, and RoIAlign carries that into
    every gradient of the heads (~1e-4 of max|g|). `extra`: more cfg keys
    (phase 3's ResNeXt and GN models)."""
    import torch

    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    set_cfg(tiny=True, dtype="float32", keypoints=keypoints, c4=c4,
            extra=extra)
    H, W = 128, 160
    tree = init.init_model(1)
    if c4:
        tree = calibrate_detector_params(tree, np.random.RandomState(1))
    paths = [path for path, _ in opt.flatten(tree)]
    runs = {"cpu f64": ("cpu", torch.float64, True),
            "cpu f32": ("cpu", torch.float32, True),
            "gpu f32": (device, torch.float32, False),
            "gpu f32 cudnn": (device, torch.float32, True)}
    out = {}
    for name, (dev, dtype, cudnn) in runs.items():
        torch.backends.cudnn.enabled = cudnn
        out[name] = _small_train_run(tree, dev, dtype, H, W)
    torch.backends.cudnn.enabled = True
    for name in ("cpu f32", "gpu f32", "gpu f32 cudnn"):
        out["cpu f64, signs of " + name] = _small_train_run(
            tree, "cpu", torch.float64, H, W,
            masks=[x > 0 for x in out[name][2]])
    set_cfg(tiny=True, dtype="float32", keypoints=keypoints, c4=c4,
            extra=extra)

    (_, g64, _), _, relu64 = out["cpu f64"]
    cpu_loss = out["cpu f32"][1]

    def worst(vals, ref):
        errs = sorted(((float((a - r).abs().max()) / float(r.abs().max()),
                        path) for path, a, r in zip(paths, vals, ref)
                       if float(r.abs().max()) > 0), reverse=True)
        return errs[0]

    report = {}
    for name in ("cpu f32", "gpu f32", "gpu f32 cudnn"):
        (_, g, upd), loss, relu_in = out[name]
        (_, g_ref, upd_ref), _, _ = out["cpu f64, signs of " + name]
        report[name] = dict(
            loss=max(abs(loss[k] - v) / max(abs(v), 1e-12)
                     for k, v in cpu_loss.items()),
            flips=relu_flips(relu_in, relu64),
            grad_f64=worst(g, g64), grad=worst(g, g_ref),
            update=worst(upd, upd_ref))
        r = report[name]
        print("small-input train check ({}{}2 x {} x {}), {}: losses {}; max "
              "relative loss diff vs cpu f32 {:.3e}; ReLU inputs vs cpu f64: "
              "{} sign flips, largest |input| at a flip / its call's max "
              "{:.3e}, worst diff / its call's max {:.3e}; "
              "worst grad diff / max|g| vs cpu f64 {:.3e} {}, vs cpu f64 "
              "with this run's ReLU signs {:.3e} {}; worst update diff / "
              "max update vs the latter {:.3e} {}".format(
                  "Keypoint R-CNN, " if keypoints else
                  "Mask R-CNN R-50-C4, " if c4 else "",
                  "".join("{} {}, ".format(*extra[i:i + 2])
                          for i in range(0, len(extra), 2)), H, W, name, loss,
                  r["loss"], *r["flips"], *r["grad_f64"],
                  *r["grad"], *r["update"]))
    # With its own ReLU signs a float32 step is within ~1e-5 of float64
    # here (1e-3 to 1e-2 without them); each (the CPU's, and the GPU's
    # with cuDNN off and on) must be within 1e-4, gradients and update. A
    # wrong K4 or a wrong convolution backward moves whole terms of the
    # FPN and body gradients and fails this at any ReLU signs.
    bad = {k: r for k, r in report.items()
           if r["loss"] > 1e-3 or r["flips"][2] > ACT_REL or
           r["grad"][0] > 1e-4 or r["update"][0] > 1e-4}
    if bad:
        raise AssertionError("GPU train_step disagrees with the CPU plain "
                             "path on the small input: {}".format(bad))


def main_inputs(device, params=True):
    """The inference main path's bf16 params (None without `params`) and
    images (and im_info)."""
    import torch

    params = make_params(device, torch.bfloat16) if params else None
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(BATCH, *CANVAS, 3).astype(np.float32) * 20.0).to(
            device, torch.bfloat16)
    im_info = torch.tensor([IM_INFO] * BATCH, device=device)
    return params, images, im_info


def compare_fused_inference(device):
    """Phase 6, continued: the inference main path with TPU.FUSED_RES2 off
    and on in turns (off, on, on, off), MAIN_RUNS batches each after a
    warm-up batch, on the same params and images, then one profiled batch
    of each: host ms per batch, device busy time and idle share."""
    import torch

    from detectron_tpu_torch.core import test as det

    params, images, im_info = main_inputs(device)

    def batch():
        return det.detect_graph(params, images, im_info)

    times = {False: [], True: []}
    for fused in (False, True, True, False):
        set_cfg(tiny=False, dtype="bfloat16",
                extra=FUSED_RES2 if fused else ())
        batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MAIN_RUNS):
            batch()
        torch.cuda.synchronize()
        times[fused].append((time.perf_counter() - t0) / MAIN_RUNS * 1e3)
    print("inference in turns (off, on, on, off), host ms per batch of {} "
          "over {} batches: TPU.FUSED_RES2 off {}, on {}".format(
              BATCH, MAIN_RUNS, [round(t, 3) for t in times[False]],
              [round(t, 3) for t in times[True]]))
    for fused in (False, True):
        set_cfg(tiny=False, dtype="bfloat16",
                extra=FUSED_RES2 if fused else ())
        profile_call("one inference batch, TPU.FUSED_RES2 {}".format(fused),
                     batch, n_kernels=20, n_ops=0)


def run_main_path(device, extra=()):
    """Phase 4 (or, with extra = FUSED_RES2, phase 6). Returns the kernels'
    launch counts over MAIN_RUNS batches."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    set_cfg(tiny=False, dtype="bfloat16", extra=extra)
    params, images, im_info = main_inputs(device)
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg}
    if cfg.TPU.FUSED_RES2:
        wrappers.update(stem_pool=fk.stem_pool, fused_res2=fk.fused_res2)
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
    print("inference path (Mask R-CNN R-50-FPN, bf16, {} x {} x {}, RPN {} "
          "proposals, D={}{}): {:.3f} img/s over {} batches, valid "
          "detections per image {}, launches {}".format(
              BATCH, *CANVAS, cfg.TEST.RPN_POST_NMS_TOP_N, D,
              ", TPU.FUSED_RES2" if cfg.TPU.FUSED_RES2 else "",
              BATCH * MAIN_RUNS / dt, MAIN_RUNS, per_image, launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    if sum(per_image) == 0:
        raise AssertionError("the main path produced no detections")
    return launches


def run_train_path(device, profile, clip):
    """Phase 5. Returns the kernels' launch counts over TRAIN_STEPS steps."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    set_cfg(tiny=False, dtype="bfloat16",
            extra=["SOLVER.CLIP_GRADIENTS", str(clip)])
    params = make_params(device, torch.float32)
    p0 = [t.clone() for t in _flat(params)]
    opt_state = opt.init_opt_state(params)
    batch = synthetic_train_batch(BATCH, *CANVAS, device,
                                  np.random.RandomState(0))
    gen = torch.Generator().manual_seed(0)

    def draws():
        return train_graph.make_draws(gen, BATCH, CANVAS,
                                      cfg.TPU.MAX_GT_BOXES, device)

    def step(params, opt_state):
        return ts.train_step(params, opt_state, batch, draws())

    t0 = time.perf_counter()
    params, opt_state, stats = step(params, opt_state)   # warm-up
    torch.cuda.synchronize()
    print("train warm-up step: {:.3f} ms, loss {}".format(
        (time.perf_counter() - t0) * 1e3, float(stats["loss"])))

    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg,
                "roi_window_accum": roi_align_kernel.roi_window_accum}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats_list, marks, k4_marks = [], [], []
    for _ in range(TRAIN_STEPS):
        params, opt_state, stats = step(params, opt_state)
        stats_list.append(stats)
        marks.append(time.perf_counter())
        k4_marks.append(roi_align_kernel.roi_window_accum.launches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # Host-clock marks between steps (each step synchronizes inside, at
    # the ladder's torch.nonzero), so these split the run by step.
    print("train steps, host ms each: {}; K4 launches each: {} (one per "
          "ladder route with RoIs: the box and mask base windows and each "
          "fix-up rung that this step's RoIs reach)".format(
              [round((b - a) * 1e3, 3) for a, b in zip([t0] + marks, marks)],
              [b - a for a, b in zip([0] + k4_marks, k4_marks)]))
    losses = [{k: round(float(v), 4) for k, v in st.items()}
              for st in stats_list]
    launches = {name: fn.launches for name, fn in wrappers.items()}

    moved = sum(not torch.equal(a, b) for a, b in zip(p0, _flat(params)))
    median = statistics.median(b - a for a, b in zip([t0] + marks, marks))
    # The mean carries one-off costs of the first steps (the first backward
    # through the sliver gather spends seconds in PyTorch's first CUDA
    # index_put); the median step is the steady state.
    print("train path (Mask R-CNN R-50-FPN, bf16 compute / f32 params, {} x "
          "{} x {}, RPN {}/{}, {} RoIs/img, CLIP_GRADIENTS {}): median "
          "{:.3f} ms/step = {:.3f} img/s, mean {:.3f} ms/step = {:.3f} "
          "img/s over {} steps after 1 warm-up, peak memory {:.2f} GB, {} "
          "of {} param leaves moved, launches {}".format(
              BATCH, *CANVAS, cfg.TRAIN.RPN_PRE_NMS_TOP_N,
              cfg.TRAIN.RPN_POST_NMS_TOP_N, cfg.TRAIN.BATCH_SIZE_PER_IM,
              cfg.SOLVER.CLIP_GRADIENTS, median * 1e3, BATCH / median,
              dt / TRAIN_STEPS * 1e3, BATCH * TRAIN_STEPS / dt, TRAIN_STEPS,
              torch.cuda.max_memory_allocated() / 1e9, moved, len(p0),
              launches))
    for i, row in enumerate(losses):
        print("train step {}: {}".format(i + 2, row))
    bad = [row for row in losses if not all(np.isfinite(list(row.values())))]
    if bad:
        raise AssertionError("non-finite training stats: {}".format(bad))
    if opt_state["step"] != TRAIN_STEPS + 1:
        raise AssertionError("opt_state step {} != {}".format(
            opt_state["step"], TRAIN_STEPS + 1))
    if moved == 0:
        raise AssertionError("the training steps changed no param")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError("kernels not launched on the training path: "
                             + ", ".join(missing))
    if profile:
        k4 = roi_align_kernel.roi_window_accum.launches
        profile_call("one train step", lambda: step(params, opt_state))
        print("K4 launches in the profiled step: {}".format(
            roi_align_kernel.roi_window_accum.launches - k4))
        stage_times(params, opt_state, batch, draws)
    return launches


def stage_times(params, opt_state, batch, draws, steps=4):
    """Host ms of each stage of `steps` more training steps: forward
    (training_losses), backward (torch.autograd.grad over the trainable
    leaves) and update (apply_updates), each ended by a synchronize."""
    import torch

    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts

    for i in range(steps):
        d = draws()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, leaves = ts.grad_leaves(params)
        total, _ = train_graph.training_losses(p, batch, d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = ts.grads_of(total, p, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt_state, _ = opt.apply_updates(params, grads, opt_state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print("stage times, step {} after the profiled one: forward {:.3f} "
              "ms, backward {:.3f} ms, update {:.3f} ms".format(
                  i + 1, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))


def profile_call(label, fn, n_kernels=20, n_ops=15):
    """torch.profiler over one call of fn: its wall time, the device time
    summed over its kernels (device events only, so no time is counted
    twice under the ops that launched it), the device's idle share, and
    the top kernels and ops by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print("profile of {}: wall {:.3f} ms, device busy {:.3f} ms (sum over "
          "kernels), idle share {:.3f}".format(label, wall, busy,
                                               1 - busy / wall))
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        # The top n_kernels, and the port's own kernels (csrc/) wherever
        # they rank.
        if i < n_kernels or any(k in e.key for k in PORT_KERNELS):
            print("  kernel {:9.3f} ms {:6d} calls  {}{}".format(
                e.self_device_time_total / 1e3, e.count, e.key[:90],
                "" if i < n_kernels else "  (rank {})".format(i + 1)))
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(ops, key=lambda e: -e.cpu_time_total)[:n_ops]:
        print("  op {:9.3f} ms cpu total {:6d} calls  {}".format(
            e.cpu_time_total / 1e3, e.count, e.key[:90]))


# ---------------------------------------------------------------------------
# Phase 7: the dataset inference engine
# ---------------------------------------------------------------------------

def _check_engine_results(dets, roidb, num_classes):
    """Every image has a result; each all_boxes[j][i] is a finite (n, 5)
    array inside its original image, with as many RLEs of the image's size
    in all_segms[j][i]. Returns the number of detections."""
    n = 0
    for i, entry in enumerate(roidb):
        h, w = entry["height"], entry["width"]
        for j in range(1, num_classes):
            b, segms = dets["all_boxes"][j][i], dets["all_segms"][j][i]
            if not isinstance(b, np.ndarray) or b.ndim != 2 or \
                    b.shape[1] != 5:
                raise AssertionError("image {} class {}: no (n, 5) result: "
                                     "{!r}".format(i, j, b))
            if not np.isfinite(b).all():
                raise AssertionError("image {} class {}: non-finite "
                                     "boxes".format(i, j))
            if ((b[:, :4] < 0).any() or (b[:, [0, 2]] > w).any()
                    or (b[:, [1, 3]] > h).any()):
                raise AssertionError("image {} class {}: boxes outside the "
                                     "{} x {} image".format(i, j, w, h))
            if len(segms) != len(b) or any(r["size"] != [h, w]
                                           for r in segms):
                raise AssertionError("image {} class {}: {} boxes, {} RLEs"
                                     .format(i, j, len(b), len(segms)))
            n += len(b)
    return n


def _same_image_results(got_boxes, got_segms, dets, idx, num_classes):
    """Exact equality of one image's per-class boxes and RLE strings with
    entry idx of a detections.pkl payload."""
    for j in range(1, num_classes):
        if not np.array_equal(got_boxes[j], dets["all_boxes"][j][idx]):
            return "class {} boxes".format(j)
        if got_segms[j] != dets["all_segms"][j][idx]:
            return "class {} RLEs".format(j)
    return None


def _unmatched_detections(got, ref):
    """Rows of ref (n, 5) that no row of got matches one to one, within
    tests/test_e2e_inference.py's tolerances: score rtol 1e-4 / atol 1e-5,
    boxes rtol 1e-3 / atol 0.05. Rows are paired in score order, each with
    the first unused match, so detections of near-equal score may come in
    either order."""
    used = np.zeros(len(got), bool)
    n = 0
    for r in ref[np.argsort(-ref[:, 4], kind="stable")]:
        ok = ~used & (np.abs(got[:, 4] - r[4]) <= 1e-5 + 1e-4 * abs(r[4]))
        ok &= (np.abs(got[:, :4] - r[:4]) <= 0.05 + 1e-3 * np.abs(
            r[:4])).all(1)
        if ok.any():
            used[np.argmax(ok)] = True
        else:
            n += 1
    return n


def run_engine_path(device, workdir):
    """Phase 7. Returns K1-K3's launch counts over run_inference."""
    import logging
    import types

    import torch

    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import image_io
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.logging import setup_logging
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    # The engine's own log lines (img/s, per-batch timers, evaluation
    # time, AP) go to stdout; the per-category AP lines do not.
    setup_logging(__name__)
    logging.getLogger("detectron_tpu_torch.data.json_dataset_evaluator"
                      ).setLevel(logging.WARNING)

    t0 = time.perf_counter()
    n_ann = make_valset(workdir, ENGINE_IMAGES)
    set_cfg(tiny=False, dtype="bfloat16",
            extra=["DATA_DIR", workdir, "TEST.DATASETS",
                   "('coco_2017_val',)"])
    ckpt = net_utils.save_ckpt(
        workdir + "/train", 0,
        calibrate_detector_params(init.init_model(0),
                                  np.random.RandomState(0)))
    args = types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None)
    print("engine set-up: {} images, {} annotations, checkpoint {}, in "
          "{:.3f} s".format(ENGINE_IMAGES, n_ann, ckpt,
                            time.perf_counter() - t0))

    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg}
    for fn in wrappers.values():
        fn.launches = 0
    out_dir = workdir + "/eval"
    t0 = time.perf_counter()
    results = test_engine.run_inference(
        args, dataset_name="coco_2017_val", output_dir=out_dir,
        batch_size=ENGINE_BATCH, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    with open(out_dir + "/detections.pkl", "rb") as f:
        dets = pickle.load(f)
    dataset = JsonDataset("coco_2017_val")
    roidb = dataset.get_roidb(gt=True)
    C = cfg.MODEL.NUM_CLASSES
    n_dets = _check_engine_results(dets, roidb, C)
    ap = {task: results["coco_2017_val"][task]["AP"]
          for task in ("box", "mask")}
    if not all(np.isfinite(v) for v in ap.values()):
        raise AssertionError("non-finite COCO AP: {}".format(ap))
    print("engine path (run_inference, Mask R-CNN R-50-FPN, bf16, batch {}, "
          "TEST.SCALE {} / MAX_SIZE {}): {} images, {} detections, box AP "
          "{}, mask AP {} (random weights), {:.3f} s in all, launches {}"
          .format(ENGINE_BATCH, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE,
                  len(roidb), n_dets, ap["box"], ap["mask"], wall, launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError("kernels not launched on the test_net path: "
                             + ", ".join(missing))
    if n_dets == 0:
        raise AssertionError("the engine produced no detections")

    # The engine's first batch (the first ENGINE_BATCH landscape images)
    # against detect_graph called directly on the batch the engine
    # prepared: boxes equal, RLE strings identical.
    params = test_engine.initialize_model_from_cfg(args, device=device)
    first = [i for i, e in enumerate(roidb)
             if e["width"] >= e["height"]][:ENGINE_BATCH]
    prepared = []

    def spy(params, images, im_info):
        prepared.append((images.clone(), im_info.clone()))
        return det.detect_graph(params, images, im_info)

    test_engine.test_net(params, [roidb[i] for i in first], dataset,
                         batch_size=ENGINE_BATCH, detect_fn=spy,
                         device=device)
    out = det.detect_graph(params, *prepared[0])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    im_info = prepared[0][1].cpu().numpy()
    for bi, idx in enumerate(first):
        cls_boxes, cls_segms, _ = test_engine.device_outputs_to_image_results(
            out, bi, im_info, C, (roidb[idx]["height"], roidb[idx]["width"]))
        diff = _same_image_results(cls_boxes, cls_segms, dets, idx, C)
        if diff:
            raise AssertionError("engine image {} differs from detect_graph "
                                 "on its prepared batch: {}".format(idx,
                                                                    diff))
    print("engine first batch: {} images equal to detect_graph on the "
          "prepared batch (boxes and RLE strings)".format(len(first)))

    # The flagged host path on 4 images: Soft-NMS, then box voting, routed
    # through test_net_im_detect_all; then, with neither, im_detect_all
    # against the batched path on the same single-image batches.
    four = roidb[:4]
    for keys in (["TEST.SOFT_NMS.ENABLED", "True"],
                 ["TEST.BBOX_VOTE.ENABLED", "True"]):
        config.merge_cfg_from_list(keys)
        if not test_engine._flagged_host_path():
            raise AssertionError(keys[0] + " does not route to the host "
                                 "path")
        flagged = dict(zip(("all_boxes", "all_segms"), test_engine.test_net(
            params, four, dataset, batch_size=ENGINE_BATCH,
            device=device)[:2]))
        n = _check_engine_results(flagged, four, C)
        print("engine host path, {}: {} images, {} detections".format(
            keys[0], len(four), n))
        config.merge_cfg_from_list([keys[0], "False"])
    profile_call("one engine batch (test_net over {} landscape images: "
                 "load, device, mask paste)".format(len(first)),
                 lambda: test_engine.test_net(
                     params, [roidb[i] for i in first], dataset,
                     batch_size=ENGINE_BATCH, device=device),
                 n_kernels=10, n_ops=10)

    # im_detect_all against the batched path, in float32 as
    # tests/test_e2e_inference.py compares them, on low-contrast copies of
    # the 4 images (PIXEL_MEANS + N(0, 1) pixels) resized to TEST.SCALE on
    # their short side. Low contrast: on the set's 0-255 noise the random
    # weights saturate scores at 1.0, and the host limit then keeps every
    # box tied with its last one. Scale 1: the host NMS runs on boxes in
    # image coordinates and the device NMS in scaled ones, and with
    # Detectron's +1 box convention an IoU near the threshold can fall on
    # either side in the two.
    set_cfg(tiny=False, dtype="float32",
            extra=["DATA_DIR", workdir, "TEST.DATASETS",
                   "('coco_2017_val',)"])
    params = test_engine.initialize_model_from_cfg(args, device=device)
    rng = np.random.RandomState(7)
    low = []
    for i, entry in enumerate(four):
        k = cfg.TEST.SCALE / min(entry["height"], entry["width"])
        h, w = round(entry["height"] * k), round(entry["width"] * k)
        im = np.round(cfg.PIXEL_MEANS + rng.randn(h, w, 3))
        path = "{}/low{}.ppm".format(workdir, i)
        image_io.write_ppm(path, np.clip(im, 0, 255).astype(np.uint8))
        low.append(dict(entry, image=path, height=h, width=w))
    batched = test_engine.test_net(params, low, dataset, batch_size=1,
                                   device=device)[0]
    for i, entry in enumerate(low):
        cls_boxes, _, _ = det.im_detect_all(
            params, image_io.imread(entry["image"]), torch.device(device))
        h = np.concatenate([b for b in cls_boxes[1:] if len(b)] or
                           [np.zeros((0, 5), np.float32)])
        d = np.concatenate([batched[j][i] for j in range(1, C)])
        unmatched = _unmatched_detections(d, h)
        if len(h) != len(d) or unmatched:
            raise AssertionError(
                "image {}: im_detect_all has {} detections, the batched "
                "path {}; {} without a match".format(i, len(h), len(d),
                                                     unmatched))
    print("engine host path without flags, float32: im_detect_all equals "
          "the batched path (batch 1) on {} low-contrast images at scale 1 "
          "({} detections)".format(
              len(low), sum(len(b) for cls in batched[1:] for b in cls)))
    return launches


def run_train_net_path(device, workdir):
    """Phase 8. Returns K1-K4's launch counts over train_net_step.main."""
    import types

    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    t0 = time.perf_counter()
    n_ann = make_valset(workdir, TRAIN_NET_IMAGES, "train2017")
    set_cfg(tiny=False, dtype="bfloat16",
            extra=["DATA_DIR", workdir, "OUTPUT_DIR", workdir + "/out"])
    # Phase 4's calibrated weights as a Detectron .pkl, in Caffe2 layouts.
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    pkl = workdir + "/model_final.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f,
                    pickle.HIGHEST_PROTOCOL)
    loaded = dict(opt.flatten(dwh.load_detectron_weight(init.init_model(1),
                                                         pkl)))
    ref = dict(opt.flatten(tree))
    diff = [p for p, a in ref.items() if not np.array_equal(loaded[p], a)]
    if set(loaded) != set(ref) or diff:
        raise AssertionError("load_detectron_weight of the written .pkl "
                             "differs from its tree at {}".format(diff[:5]))
    ckpt = net_utils.save_ckpt(workdir + "/weights", 0, tree)
    from_pkl = test_engine.initialize_model_from_cfg(
        types.SimpleNamespace(load_ckpt=None, load_detectron=pkl),
        device=device)
    from_ckpt = test_engine.initialize_model_from_cfg(
        types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None),
        device=device)
    a, b = _flat(from_pkl), _flat(from_ckpt)
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("initialize_model_from_cfg: --load_detectron "
                             "and --load_ckpt of the same weights differ")
    del from_pkl, from_ckpt, a, b
    print("train_net set-up: {} images, {} annotations (coco_2017_train), "
          "Detectron .pkl of {} blobs read back exactly, "
          "initialize_model_from_cfg --load_detectron == --load_ckpt on {} "
          "leaves, in {:.3f} s".format(
              TRAIN_NET_IMAGES, n_ann, len(dwh.full_weight_mapping()),
              len(ref), time.perf_counter() - t0))

    # The preset's schedule is for NUM_GPUS x IMS_PER_BATCH = 16 images a
    # step; the linear-scaling rule multiplies MAX_ITER by that over --bs
    # (and divides the lr by it), so MAX_ITER 1 makes 8 steps of 2 images.
    scale = cfg.NUM_GPUS * cfg.TRAIN.IMS_PER_BATCH // BATCH
    max_iter = TRAIN_NET_STEPS // scale
    assert max_iter * scale == TRAIN_NET_STEPS
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg,
                "roi_window_accum": roi_align_kernel.roi_window_accum}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run = train_net_step.main([
        "--dataset", "coco2017", "--bs", str(BATCH), "--nw", "4",
        "--load_detectron", pkl, "--ckpt_num_per_epoch", "1",
        "--disp_interval", "1", "--device", device, "--set",
        "SOLVER.MAX_ITER", str(max_iter),
        "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS),
        "TRAIN.USE_FLIPPED", "True", "TRAIN.SCALES", "(800,)",
        "TRAIN.MAX_SIZE", "1333"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    steps = len(run["stats"])
    if steps != TRAIN_NET_STEPS:
        raise AssertionError("train_net_step took {} steps, not {}".format(
            steps, TRAIN_NET_STEPS))
    bad = [s for s in run["stats"] if not all(np.isfinite(list(s.values())))]
    if bad:
        raise AssertionError("non-finite training stats: {}".format(bad))
    got = dict(opt.flatten(net_utils.load_ckpt_params(run["ckpt"])))
    if set(got) != set(ref) or not all(
            got[p].shape == a.shape and np.isfinite(got[p]).all()
            for p, a in ref.items()):
        raise AssertionError("the checkpoint {} does not read back as the "
                             "model's tree of finite values".format(
                                 run["ckpt"]))
    moved = sum(not np.array_equal(got[p], a) for p, a in ref.items())
    step_ms = [t * 1e3 for t in run["step_s"][1:]]
    wait_ms = [t * 1e3 for t in run["loader_wait_s"]]
    median = statistics.median(step_ms)
    print("train_net path (train_net_step.main, Mask R-CNN R-50-FPN, bf16 "
          "compute / f32 params, --bs {} --nw 4 --load_detectron, "
          "TRAIN.SCALES (800,) / MAX_SIZE 1333, USE_FLIPPED, "
          "CLIP_GRADIENTS {}): {} steps over {} roidb entries in {:.3f} s, "
          "canvases {}; median step {:.3f} ms after the first = {:.3f} "
          "img/s; loader wait per step median {:.3f} ms, mean {:.3f} ms "
          "(first step {:.3f} ms); checkpoint {} read back, {} of {} leaves "
          "moved; launches {}".format(
              BATCH, CLIP_GRADIENTS, steps, 2 * TRAIN_NET_IMAGES, wall,
              sorted(set(run["canvases"])), median, BATCH / median * 1e3,
              statistics.median(wait_ms), statistics.mean(wait_ms),
              wait_ms[0], run["ckpt"], moved, len(got), launches))
    print("train_net step ms: {}; loader wait ms: {}".format(
        [round(t, 3) for t in [run["step_s"][0] * 1e3] + step_ms],
        [round(t, 3) for t in wait_ms]))
    for i, row in enumerate(run["stats"]):
        print("train_net step {}: {}".format(
            i, {k: round(v, 4) for k, v in row.items()}))
    if moved == 0:
        raise AssertionError("the training steps changed no param")
    missing = [k for k in ("nms_keep_mask", "roi_window_pool",
                           "roi_window_accum") if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the train_net path: "
                             + ", ".join(missing))
    return launches


# ---------------------------------------------------------------------------
# Phases 9 and 10: Keypoint R-CNN
# ---------------------------------------------------------------------------

def _check_keypoint_results(dets, roidb):
    """Every image has finite (n, 5) person boxes inside it, and as many
    (4, K) keypoint arrays, finite, each keypoint inside its box (the
    decode places it at a cell centre of the box's resized heatmap).
    Returns the number of detections."""
    n = 0
    for i, entry in enumerate(roidb):
        h, w = entry["height"], entry["width"]
        b, kps = dets["all_boxes"][1][i], dets["all_keyps"][1][i]
        if not isinstance(b, np.ndarray) or b.ndim != 2 or b.shape[1] != 5 \
                or not np.isfinite(b).all():
            raise AssertionError("image {}: no finite (n, 5) person boxes: "
                                 "{!r}".format(i, b))
        if ((b[:, :4] < 0).any() or (b[:, [0, 2]] > w).any()
                or (b[:, [1, 3]] > h).any()):
            raise AssertionError("image {}: boxes outside the {} x {} image"
                                 .format(i, w, h))
        if len(kps) != len(b):
            raise AssertionError("image {}: {} boxes, {} keypoint sets"
                                 .format(i, len(b), len(kps)))
        for box, k in zip(b, kps):
            if k.shape != (4, 17) or not np.isfinite(k).all():
                raise AssertionError("image {}: keypoints {!r}".format(i, k))
            x1, y1, x2, y2 = box[:4]
            if ((k[0] < x1 - 1e-3).any() or (k[0] > max(x2, x1 + 1) + 1e-3)
                    .any() or (k[1] < y1 - 1e-3).any()
                    or (k[1] > max(y2, y1 + 1) + 1e-3).any()):
                raise AssertionError("image {}: keypoints outside box {}: {}"
                                     .format(i, box[:4], k[:2]))
        n += len(b)
    return n


def calibrate_person_class(tree, device, frac=0.25):
    """Turn the person column of cls_score (Keypoint R-CNN's one
    foreground class) so that about `frac` of the main inputs' proposals
    score it above the background. calibrate_detector_params' background
    bias alone, made for 80 classes, leaves one class with no detection:
    under random weights every RoI's fc7 features share a large common
    direction u, so the person-minus-background logit has one sign on
    almost every RoI (negative for seed 0). The column moves by -c u, c
    the (1 - frac) quantile of that logit over each RoI's projection on
    u; the network is positively homogeneous in its input (zero biases),
    so the share holds at any input scale. Updates and returns `tree`."""
    import torch

    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import model_builder as mb

    params = bridge.to_torch(tree, device, torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
    with torch.no_grad():
        feats, scales = mb.forward_features(params, images)
        rois, _, valid = mb.generate_proposals(
            mb.forward_rpn(params, feats), feats, im_info, False)
        f = mb.forward_box_outputs(params, feats, scales, rois)[2]
    f = f.float()[valid.reshape(-1)].cpu().numpy().astype(np.float64)
    w = tree["box_outs"]["cls_score"]["w"]
    u = f.mean(0) / np.linalg.norm(f.mean(0))
    proj = f @ u
    keep = proj > 0
    c = np.quantile((f[keep] @ (w[:, 1] - w[:, 0]).astype(np.float64))
                    / proj[keep], 1 - frac)
    w[:, 1] -= (c * u).astype(np.float32)
    return tree


def run_keypoint_infer_path(device, workdir):
    """Phase 9. Returns (K1-K3's launch counts over MAIN_RUNS detect_graph
    batches, and over run_inference)."""
    import types

    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.logging import setup_logging

    setup_logging(__name__)
    set_cfg(tiny=False, dtype="bfloat16", keypoints=True)
    tree = calibrate_person_class(make_tree(), device)
    params = bridge.to_torch(tree, device, torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
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
    infer = {name: fn.launches for name, fn in wrappers.items()}

    D, S = cfg.TEST.DETECTIONS_PER_IM, cfg.KRCNN.HEATMAP_SIZE
    K = cfg.KRCNN.NUM_KEYPOINTS
    shapes = {"boxes": (BATCH, D, 4), "scores": (BATCH, D),
              "classes": (BATCH, D), "valid": (BATCH, D),
              "kps_heatmaps": (BATCH, D, S, S, K)}
    if set(out) != set(shapes):
        raise AssertionError("detect_graph returned {}".format(sorted(out)))
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError("{} has shape {}, expected {}".format(
                k, tuple(out[k].shape), shape))
        if out[k].is_floating_point() and not bool(
                torch.isfinite(out[k]).all()):
            raise AssertionError(k + " has non-finite values")
    per_image = out["valid"].sum(1).tolist()
    # The keypoint head's RoIs (all D slots of each image, as the ladder
    # gets them) per ladder route.
    dims = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    routes, _ = ladder_routes(
        out["boxes"].reshape(-1, 4).float().cpu(), dims,
        ladder_statics(cfg.KRCNN.ROI_XFORM_RESOLUTION,
                       cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO))
    print("keypoint inference path (Keypoint R-CNN R-50-FPN, bf16, {} x {} "
          "x {}, RPN {} proposals, D={}, pose head {} x {} convs on {} x {}, "
          "heatmaps {} x {} x {}): {:.3f} img/s over {} batches, valid "
          "detections per image {}, keypoint RoIs per ladder route {}, "
          "launches {}".format(
              BATCH, *CANVAS, cfg.TEST.RPN_POST_NMS_TOP_N, D,
              cfg.KRCNN.NUM_STACKED_CONVS, cfg.KRCNN.CONV_HEAD_DIM,
              cfg.KRCNN.ROI_XFORM_RESOLUTION, cfg.KRCNN.ROI_XFORM_RESOLUTION,
              S, S, K, BATCH * MAIN_RUNS / dt, MAIN_RUNS, per_image, routes,
              infer))
    if sum(per_image) == 0:
        raise AssertionError("the keypoint path produced no detections")
    profile_call("one keypoint inference batch",
                 lambda: det.detect_graph(params, images, im_info),
                 n_kernels=15, n_ops=0)

    # The engine over a synthetic person-keypoints val set.
    t0 = time.perf_counter()
    n_ann = make_valset(workdir, KPS_ENGINE_IMAGES, keypoints=True)
    set_cfg(tiny=False, dtype="bfloat16", keypoints=True,
            extra=["DATA_DIR", workdir, "TEST.DATASETS",
                   "('{}',)".format(KPS_VAL)])
    ckpt = net_utils.save_ckpt(workdir + "/train", 0, tree)
    args = types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None)
    print("keypoint engine set-up: {} images, {} person annotations, "
          "checkpoint {}, in {:.3f} s".format(
              KPS_ENGINE_IMAGES, n_ann, ckpt, time.perf_counter() - t0))
    for fn in wrappers.values():
        fn.launches = 0
    out_dir = workdir + "/eval"
    t0 = time.perf_counter()
    results = test_engine.run_inference(
        args, dataset_name=KPS_VAL, output_dir=out_dir,
        batch_size=ENGINE_BATCH, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine = {name: fn.launches for name, fn in wrappers.items()}
    with open(out_dir + "/detections.pkl", "rb") as f:
        dets = pickle.load(f)
    dataset = JsonDataset(KPS_VAL)
    roidb = dataset.get_roidb(gt=True)
    n_dets = _check_keypoint_results(dets, roidb)
    ap = {task: results[KPS_VAL][task]["AP"] for task in ("box", "keypoint")}
    if not all(np.isfinite(v) for v in ap.values()):
        raise AssertionError("non-finite COCO AP: {}".format(ap))
    print("keypoint engine path (run_inference, Keypoint R-CNN R-50-FPN, "
          "bf16, batch {}, TEST.SCALE {} / MAX_SIZE {}): {} images, {} "
          "detections, box AP {}, keypoint AP {} (random weights), {:.3f} s "
          "in all, launches {}".format(
              ENGINE_BATCH, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, len(roidb),
              n_dets, ap["box"], ap["keypoint"], wall, engine))
    if n_dets == 0:
        raise AssertionError("the keypoint engine produced no detections")

    # The first batch against detect_graph and keypoint_results called
    # directly on the batch the engine prepared: boxes and keypoints
    # equal; the heatmap decode timed alone, on one thread.
    params = test_engine.initialize_model_from_cfg(args, device=device)
    first = [i for i, e in enumerate(roidb)
             if e["width"] >= e["height"]][:ENGINE_BATCH]
    prepared = []

    def spy(params, images, im_info):
        prepared.append((images.clone(), im_info.clone()))
        return det.detect_graph(params, images, im_info)

    test_engine.test_net(params, [roidb[i] for i in first], dataset,
                         batch_size=ENGINE_BATCH, detect_fn=spy,
                         device=device)
    out = det.detect_graph(params, *prepared[0])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    im_info = prepared[0][1].cpu().numpy()
    t0 = time.perf_counter()
    decoded = [test_engine.device_outputs_to_image_results(
        out, bi, im_info, cfg.MODEL.NUM_CLASSES,
        (roidb[idx]["height"], roidb[idx]["width"]))
        for bi, idx in enumerate(first)]
    decode_s = time.perf_counter() - t0
    n_first = 0
    for (cls_boxes, _, cls_keyps), idx in zip(decoded, first):
        n_first += len(cls_boxes[1])
        if not np.array_equal(cls_boxes[1], dets["all_boxes"][1][idx]) or \
                len(cls_keyps[1]) != len(dets["all_keyps"][1][idx]) or \
                not all(np.array_equal(a, b) for a, b in zip(
                    cls_keyps[1], dets["all_keyps"][1][idx])):
            raise AssertionError("engine image {} differs from detect_graph "
                                 "+ keypoint_results on its prepared batch"
                                 .format(idx))
    print("keypoint engine first batch: {} images equal to detect_graph + "
          "keypoint_results on the prepared batch (boxes and keypoints); "
          "heatmap decode of its {} detections on one thread {:.3f} s".format(
              len(first), n_first, decode_s))
    for path, counts in (("keypoint inference", infer),
                         ("keypoint test_net", engine)):
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError("kernels not launched on the {} path: {}"
                                 .format(path, ", ".join(missing)))
    return infer, engine


def run_keypoint_train_net_path(device, workdir):
    """Phase 10. Returns K1-K4's launch counts over train_net_step.main."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils

    t0 = time.perf_counter()
    n_ann = make_valset(workdir, TRAIN_NET_IMAGES, "train2017",
                        keypoints=True)
    set_cfg(tiny=False, dtype="bfloat16", keypoints=True,
            extra=["DATA_DIR", workdir, "OUTPUT_DIR", workdir + "/out"])
    # The calibrated weights as a Detectron .pkl, conv_fcn1..8 and the
    # kps_score deconv included, in Caffe2 layouts.
    tree = make_tree()
    pkl = workdir + "/model_final.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f,
                    pickle.HIGHEST_PROTOCOL)
    loaded = dict(opt.flatten(dwh.load_detectron_weight(init.init_model(1),
                                                         pkl)))
    ref = dict(opt.flatten(tree))
    diff = [p for p, a in ref.items() if not np.array_equal(loaded[p], a)]
    if set(loaded) != set(ref) or diff:
        raise AssertionError("load_detectron_weight of the written .pkl "
                             "differs from its tree at {}".format(diff[:5]))
    print("keypoint train_net set-up: {} images, {} person annotations "
          "(keypoints_coco_2017_train), Detectron .pkl of {} blobs read back "
          "exactly, in {:.3f} s".format(
              TRAIN_NET_IMAGES, n_ann, len(dwh.full_weight_mapping()),
              time.perf_counter() - t0))

    scale = cfg.NUM_GPUS * cfg.TRAIN.IMS_PER_BATCH // BATCH
    max_iter = TRAIN_NET_STEPS // scale
    assert max_iter * scale == TRAIN_NET_STEPS
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg,
                "roi_window_accum": roi_align_kernel.roi_window_accum}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run = train_net_step.main([
        "--dataset", "keypoints_coco2017", "--bs", str(BATCH), "--nw", "4",
        "--load_detectron", pkl, "--ckpt_num_per_epoch", "1",
        "--disp_interval", "1", "--device", device, "--set",
        "SOLVER.MAX_ITER", str(max_iter),
        "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS),
        "TRAIN.USE_FLIPPED", "True", "TRAIN.SCALES", "(800,)",
        "TRAIN.MAX_SIZE", "1333"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    steps = len(run["stats"])
    if steps != TRAIN_NET_STEPS:
        raise AssertionError("train_net_step took {} steps, not {}".format(
            steps, TRAIN_NET_STEPS))
    bad = [s for s in run["stats"] if "loss_kps" not in s
           or not all(np.isfinite(list(s.values())))]
    if bad:
        raise AssertionError("non-finite training stats, or no loss_kps: "
                             "{}".format(bad))
    got = dict(opt.flatten(net_utils.load_ckpt_params(run["ckpt"])))
    if set(got) != set(ref) or not all(
            got[p].shape == a.shape and np.isfinite(got[p]).all()
            for p, a in ref.items()):
        raise AssertionError("the checkpoint {} does not read back as the "
                             "model's tree of finite values".format(
                                 run["ckpt"]))
    moved = sum(not np.array_equal(got[p], a) for p, a in ref.items())
    step_ms = [t * 1e3 for t in run["step_s"][1:]]
    wait_ms = [t * 1e3 for t in run["loader_wait_s"]]
    median = statistics.median(step_ms)
    print("keypoint train_net path (train_net_step.main --dataset "
          "keypoints_coco2017, Keypoint R-CNN R-50-FPN, bf16 compute / f32 "
          "params, --bs {} --nw 4 --load_detectron, TRAIN.SCALES (800,) / "
          "MAX_SIZE 1333, USE_FLIPPED, CLIP_GRADIENTS {}, {} RoIs/img, "
          "keypoint RoIs {} per image): {} steps over {} images and their "
          "flips in {:.3f} s, canvases {}; median step {:.3f} ms after the "
          "first = "
          "{:.3f} img/s; loader wait per step median {:.3f} ms, mean {:.3f} "
          "ms (first step {:.3f} ms); checkpoint {} read back, {} of {} "
          "leaves moved; launches {}".format(
              BATCH, CLIP_GRADIENTS, cfg.TRAIN.BATCH_SIZE_PER_IM,
              int(round(cfg.TRAIN.FG_FRACTION * cfg.TRAIN.BATCH_SIZE_PER_IM)),
              steps, TRAIN_NET_IMAGES, wall,
              sorted(set(run["canvases"])), median, BATCH / median * 1e3,
              statistics.median(wait_ms), statistics.mean(wait_ms),
              wait_ms[0], run["ckpt"], moved, len(got), launches))
    print("keypoint train_net step ms: {}; loader wait ms: {}".format(
        [round(t, 3) for t in [run["step_s"][0] * 1e3] + step_ms],
        [round(t, 3) for t in wait_ms]))
    for i, row in enumerate(run["stats"]):
        print("keypoint train_net step {}: {}".format(
            i, {k: round(v, 4) for k, v in row.items()}))
    if moved == 0:
        raise AssertionError("the training steps changed no param")
    missing = [k for k in ("nms_keep_mask", "roi_window_pool",
                           "roi_window_accum") if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the keypoint "
                             "train_net path: " + ", ".join(missing))
    return launches


# ---------------------------------------------------------------------------
# Phases 11-13 (R-50-C4) and 15-18 (X-152, GN): one model's inference,
# engine and trainer
# ---------------------------------------------------------------------------

# The models these phases drive: a label for the printed lines, set_cfg's
# model arguments, and the trainer's extra --set keys and its check.
C4_MODEL = dict(label="C4", name="Mask R-CNN R-50-C4", cfg=dict(c4=True),
                train_set=[], engine_images=C4_ENGINE_IMAGES,
                train_steps=TRAIN_NET_STEPS)
X152_MODEL = dict(label="X-152", name="Mask R-CNN X-152-32x8d-FPN-IN5k",
                  cfg=dict(yaml=X152_YAML), train_set=["NUM_GPUS", "1"],
                  engine_images=X152_ENGINE_IMAGES,
                  train_steps=MODEL_TRAIN_STEPS)
GN_MODEL = dict(label="GN", name="Mask R-CNN R-50-FPN GN from scratch",
                cfg=dict(yaml=GN_YAML), train_set=["NUM_GPUS", "1"],
                engine_images=0, train_steps=MODEL_TRAIN_STEPS)


@contextlib.contextmanager
def plain_kernels():
    """K1, K2, K3 and K4 replaced, where the paths call them (ops/nms.py,
    ops/roi_align.py, the ladder in ops/windowed_roi.py), by their plain
    versions, which run on CUDA tensors too: a path's reference run on the
    card."""
    from detectron_tpu_torch.ops import nms, roi_align, windowed_roi
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    rk = roi_align_kernel
    swaps = [(nms, "nms_keep_mask", nms_kernel.nms_keep_mask_plain)]
    for m in (roi_align, windowed_roi):
        swaps += [(m, "roi_window_pool", rk.roi_window_pool_plain),
                  (m, "roi_window_accum", rk.roi_window_accum_plain)]
    swaps.append((windowed_roi, "roi_window_pool_seg",
                  rk.roi_window_pool_plain))
    saved = [getattr(m, n) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for (m, n, _), f in zip(swaps, saved):
            setattr(m, n, f)


def calibrate_scores(tree, device, pixel_std=20.0, spread=1.5, frac=0.25):
    """Scale cls_score's weights so that the class logits of the main
    inputs' proposals (images N(0, pixel_std)) spread by about `spread`
    (their standard deviation over valid RoIs and classes), then move the
    background bias so that about `frac` of those proposals score some
    foreground class above the background. Under random weights a C4
    model's res5 head features grow with the input (zero biases: the body
    and head are positively homogeneous), so on the x20 main inputs the
    logits spread by hundreds and every proposal scores one class at 1.0;
    an X-152 or GN body's features stay near unit scale, and the logits
    barely leave their biases. Returns a copy of `tree` whose box_outs are
    calibrated."""
    import copy

    import torch

    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import model_builder as mb

    tree = dict(tree, box_outs=copy.deepcopy(tree["box_outs"]))
    params = bridge.to_torch(tree, device, torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
    images = images * (pixel_std / 20.0)
    with torch.no_grad():
        feats, scales = mb.forward_features(params, images)
        rois, _, valid = mb.generate_proposals(
            mb.forward_rpn(params, feats), feats, im_info, False)
        f = mb.forward_box_outputs(params, feats, scales, rois)[2]
    del params, feats
    f = f.float()[valid.reshape(-1)].cpu().numpy().astype(np.float64)
    w, b = (tree["box_outs"]["cls_score"][k] for k in ("w", "b"))
    w *= np.float32(spread / (f @ w.astype(np.float64)).std())
    logits = f @ w.astype(np.float64) + b
    b[0] += np.float32(np.quantile(logits[:, 1:].max(1) - logits[:, 0],
                                   1 - frac))
    return tree


def check_outputs(out, label):
    """detect_graph's outputs: the expected keys and shapes at BATCH and
    the cfg's D and mask size, finite."""
    import torch

    from detectron_tpu_torch.core.config import cfg

    D, M = cfg.TEST.DETECTIONS_PER_IM, cfg.MRCNN.RESOLUTION
    shapes = {"boxes": (BATCH, D, 4), "scores": (BATCH, D),
              "classes": (BATCH, D), "valid": (BATCH, D),
              "mask_probs": (BATCH, D, M, M)}
    if set(out) != set(shapes):
        raise AssertionError("{} detect_graph returned {}".format(
            label, sorted(out)))
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError("{} {} has shape {}, expected {}".format(
                label, k, tuple(out[k].shape), shape))
        if out[k].is_floating_point() and not bool(
                torch.isfinite(out[k]).all()):
            raise AssertionError(label + " " + k + " has non-finite values")


def run_model_infer_path(device, model, base):
    """Phase 11 (C4) or 15 / 18 (X-152, GN): detect_graph of the model at
    full width, bf16, with cls_score calibrated on the base tree. Returns
    K1-K3's launch counts over MAIN_RUNS batches."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    label = model["label"]
    set_cfg(tiny=False, dtype="bfloat16", **model["cfg"])
    params = bridge.to_torch(calibrate_scores(base, device), device,
                             torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
    t0 = time.perf_counter()
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
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
    check_outputs(out, label)
    per_image = out["valid"].sum(1).tolist()
    print("{} inference path ({}, bf16, {} x {} x {}, RPN {} -> {} "
          "proposals, D={}, masks {} x {}): {:.3f} img/s over {} batches "
          "(warm-up batch {:.3f} s), valid detections per image {}, "
          "launches {}".format(
              label, model["name"], BATCH, *CANVAS,
              cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N,
              cfg.TEST.DETECTIONS_PER_IM, cfg.MRCNN.RESOLUTION,
              cfg.MRCNN.RESOLUTION, BATCH * MAIN_RUNS / dt, MAIN_RUNS, warm,
              per_image, launches))
    if sum(per_image) == 0:
        raise AssertionError("the {} path produced no detections".format(
            label))
    missing = [k for k in ("nms_keep_mask", "roi_window_pool")
               if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the {} inference "
                             "path: {}".format(label, ", ".join(missing)))
    profile_call("one {} inference batch".format(label),
                 lambda: det.detect_graph(params, images, im_info),
                 n_kernels=15, n_ops=0)

    # The same batch through the plain versions of K1-K3, on the card.
    with plain_kernels():
        ref = det.detect_graph(params, images, im_info)
    got = {k: v.float() if v.is_floating_point() else v
           for k, v in out.items()}
    ref = {k: v.float() if v.is_floating_point() else v
           for k, v in ref.items()}
    frac = match_detections(got, ref)
    n_ref, n_got = int(ref["valid"].sum()), int(got["valid"].sum())
    mask_err = float((got["mask_probs"] - ref["mask_probs"]).abs().max())
    print("{} inference against the plain K1-K3 on the card: valid "
          "plain={} kernels={} matched={:.4f}, largest mask probability "
          "diff {:.3e}".format(label, n_ref, n_got, frac, mask_err))
    if n_ref == 0 or frac < 0.95 or abs(n_ref - n_got) > 0.05 * n_ref:
        raise AssertionError("the {} path's kernels disagree with their "
                             "plain versions at full width".format(label))
    return launches


def run_model_engine_path(device, workdir, model, base):
    """Phase 12 (C4) or 16 (X-152): run_inference over the model's
    synthetic val set, to COCO box and mask AP. Returns K1-K3's launch
    counts."""
    import types

    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.logging import setup_logging

    label = model["label"]
    setup_logging(__name__)
    t0 = time.perf_counter()
    n_images = model["engine_images"]
    n_ann = make_valset(workdir, n_images)
    set_cfg(tiny=False, dtype="bfloat16", **model["cfg"])
    # The synthetic images are uniform 0-255 noise: 74 about the means.
    tree = calibrate_scores(base, device, pixel_std=74.0)
    set_cfg(tiny=False, dtype="bfloat16",
            extra=["DATA_DIR", workdir, "TEST.DATASETS",
                   "('coco_2017_val',)"], **model["cfg"])
    ckpt = net_utils.save_ckpt(workdir + "/train", 0, tree)
    args = types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None)
    print("{} engine set-up: {} images, {} annotations, checkpoint {}, in "
          "{:.3f} s".format(label, n_images, n_ann, ckpt,
                            time.perf_counter() - t0))
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg}
    for fn in wrappers.values():
        fn.launches = 0
    out_dir = workdir + "/eval"
    t0 = time.perf_counter()
    results = test_engine.run_inference(
        args, dataset_name="coco_2017_val", output_dir=out_dir,
        batch_size=ENGINE_BATCH, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    with open(out_dir + "/detections.pkl", "rb") as f:
        dets = pickle.load(f)
    dataset = JsonDataset("coco_2017_val")
    roidb = dataset.get_roidb(gt=True)
    C = cfg.MODEL.NUM_CLASSES
    n_dets = _check_engine_results(dets, roidb, C)
    ap = {task: results["coco_2017_val"][task]["AP"]
          for task in ("box", "mask")}
    if not all(np.isfinite(v) for v in ap.values()):
        raise AssertionError("non-finite COCO AP: {}".format(ap))
    print("{} engine path (run_inference, {}, bf16, batch {}, TEST.SCALE {} "
          "/ MAX_SIZE {}, masks {} x {}): {} images, {} detections, box AP "
          "{}, mask AP {} (random weights), {:.3f} s in all, launches {}"
          .format(label, model["name"], ENGINE_BATCH, cfg.TEST.SCALE,
                  cfg.TEST.MAX_SIZE, cfg.MRCNN.RESOLUTION,
                  cfg.MRCNN.RESOLUTION, len(roidb), n_dets, ap["box"],
                  ap["mask"], wall, launches))
    missing = [k for k in ("nms_keep_mask", "roi_window_pool")
               if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the {} test_net path: "
                             "{}".format(label, ", ".join(missing)))
    if n_dets == 0:
        raise AssertionError("the {} engine produced no detections".format(
            label))

    # The first batch against detect_graph on the batch the engine
    # prepared: boxes equal, RLE strings identical.
    params = test_engine.initialize_model_from_cfg(args, device=device)
    first = [i for i, e in enumerate(roidb)
             if e["width"] >= e["height"]][:ENGINE_BATCH]
    prepared = []

    def spy(params, images, im_info):
        prepared.append((images.clone(), im_info.clone()))
        return det.detect_graph(params, images, im_info)

    test_engine.test_net(params, [roidb[i] for i in first], dataset,
                         batch_size=ENGINE_BATCH, detect_fn=spy,
                         device=device)
    out = det.detect_graph(params, *prepared[0])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    im_info = prepared[0][1].cpu().numpy()
    for bi, idx in enumerate(first):
        cls_boxes, cls_segms, _ = test_engine.device_outputs_to_image_results(
            out, bi, im_info, C, (roidb[idx]["height"], roidb[idx]["width"]))
        diff = _same_image_results(cls_boxes, cls_segms, dets, idx, C)
        if diff:
            raise AssertionError("{} engine image {} differs from "
                                 "detect_graph on its prepared batch: {}"
                                 .format(label, idx, diff))
    print("{} engine first batch: {} images equal to detect_graph on the "
          "prepared batch (boxes and RLE strings)".format(label, len(first)))
    return launches


def run_model_train_net_path(device, workdir, model, base):
    """Phase 13 (C4) or 17 / 18 (X-152, GN): train_net_step.main from a
    Detectron .pkl of the base tree (read back exactly) on a synthetic
    training set, at the model's TRAIN.SCALES and MAX_SIZE, for its
    train_steps steps. Returns K1-K4's launch counts."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils

    label = model["label"]
    t0 = time.perf_counter()
    n_ann = make_valset(workdir, TRAIN_NET_IMAGES, "train2017")
    set_cfg(tiny=False, dtype="bfloat16",
            extra=["DATA_DIR", workdir, "OUTPUT_DIR", workdir + "/out"]
            + model["train_set"], **model["cfg"])
    # The base tree as a Detectron .pkl, read back exactly.
    pkl = workdir + "/model_final.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(base)}, f,
                    pickle.HIGHEST_PROTOCOL)
    loaded = dict(opt.flatten(dwh.load_detectron_weight(init.init_model(1),
                                                         pkl)))
    ref = dict(opt.flatten(base))
    diff = [p for p, a in ref.items() if not np.array_equal(loaded[p], a)]
    if set(loaded) != set(ref) or diff:
        raise AssertionError("load_detectron_weight of the written .pkl "
                             "differs from its tree at {}".format(diff[:5]))
    del loaded
    print("{} train_net set-up: {} images, {} annotations, Detectron .pkl "
          "of {} blobs read back exactly, in {:.3f} s".format(
              label, TRAIN_NET_IMAGES, n_ann, len(dwh.full_weight_mapping()),
              time.perf_counter() - t0))

    # train_net_step's linear-scaling rule takes MAX_ITER x (NUM_GPUS x
    # IMS_PER_BATCH / --bs) steps.
    steps = model["train_steps"]
    scale = cfg.NUM_GPUS * cfg.TRAIN.IMS_PER_BATCH // BATCH
    max_iter = steps // scale
    assert max_iter * scale == steps
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": roi_align_kernel.roi_window_pool,
                "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg,
                "roi_window_accum": roi_align_kernel.roi_window_accum}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_net_step.main([
        "--dataset", "coco2017", "--bs", str(BATCH), "--nw", "4",
        "--load_detectron", pkl, "--ckpt_num_per_epoch", "1",
        "--disp_interval", "1", "--device", device, "--set",
        "SOLVER.MAX_ITER", str(max_iter),
        "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS),
        "TRAIN.USE_FLIPPED", "True"] + model["train_set"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: fn.launches for name, fn in wrappers.items()}

    if len(run["stats"]) != steps:
        raise AssertionError("{} train_net_step took {} steps, not {}"
                             .format(label, len(run["stats"]), steps))
    bad = [s for s in run["stats"] if "loss_mask" not in s
           or not all(np.isfinite(list(s.values())))]
    if bad:
        raise AssertionError("non-finite training stats, or no loss_mask: "
                             "{}".format(bad))
    got = dict(opt.flatten(net_utils.load_ckpt_params(run["ckpt"])))
    if set(got) != set(ref) or not all(
            got[p].shape == a.shape and np.isfinite(got[p]).all()
            for p, a in ref.items()):
        raise AssertionError("the checkpoint {} does not read back as the "
                             "model's tree of finite values".format(
                                 run["ckpt"]))
    moved = {p for p, a in ref.items() if not np.array_equal(got[p], a)}
    step_ms = [t * 1e3 for t in run["step_s"][1:]]
    wait_ms = [t * 1e3 for t in run["loader_wait_s"]]
    median = statistics.median(step_ms)
    print("{} train_net path (train_net_step.main, {}, bf16 compute / f32 "
          "params, --bs {} --nw 4 --load_detectron, TRAIN.SCALES {} / "
          "MAX_SIZE {}, USE_FLIPPED, CLIP_GRADIENTS {}, RPN {} -> {}, {} "
          "RoIs/img, FREEZE_AT {}): {} steps over {} images and their flips "
          "in {:.3f} s, canvases {}; median step {:.3f} ms after the first "
          "= {:.3f} img/s; peak memory {:.3f} GiB "
          "(torch.cuda.max_memory_allocated); loader wait per step median "
          "{:.3f} ms (first step {:.3f} ms); checkpoint read back, {} of {} "
          "leaves moved; launches {}".format(
              label, model["name"], BATCH, cfg.TRAIN.SCALES,
              cfg.TRAIN.MAX_SIZE, CLIP_GRADIENTS,
              cfg.TRAIN.RPN_PRE_NMS_TOP_N, cfg.TRAIN.RPN_POST_NMS_TOP_N,
              cfg.TRAIN.BATCH_SIZE_PER_IM, cfg.RESNETS.FREEZE_AT, steps,
              TRAIN_NET_IMAGES, wall, sorted(set(run["canvases"])), median,
              BATCH / median * 1e3, peak, statistics.median(wait_ms),
              wait_ms[0], len(moved), len(got), launches))
    print("{} train_net step ms: {}; loader wait ms: {}".format(
        label, [round(t, 3) for t in [run["step_s"][0] * 1e3] + step_ms],
        [round(t, 3) for t in wait_ms]))
    for i, row in enumerate(run["stats"]):
        print("{} train_net step {}: {}".format(
            label, i, {k: round(v, 4) for k, v in row.items()}))
    if not moved:
        raise AssertionError("the training steps changed no param")
    if cfg.RESNETS.USE_GN:
        # GN params train, and with FREEZE_AT 0 so does the stem.
        gn = [p for p in ref if opt.param_kind(p) == "gn"]
        still = [p for p in gn if p not in moved]
        if cfg.RESNETS.FREEZE_AT != 0 or ("body", "conv1", "w") not in \
                moved or not gn or still:
            raise AssertionError("{}: GN params that did not move: {} (of "
                                 "{}); FREEZE_AT {}".format(
                                     label, still[:5], len(gn),
                                     cfg.RESNETS.FREEZE_AT))
        print("{} train_net: all {} GN params moved, the stem's "
              "included".format(label, len(gn)))
    missing = [k for k in ("nms_keep_mask", "roi_window_pool",
                           "roi_window_accum") if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the {} train_net "
                             "path: {}".format(label, ", ".join(missing)))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: deterministic training steps on the card (K4 without atomics)
# ---------------------------------------------------------------------------

def run_det_train_check(device):
    """Phase 14: two identical full-width Mask R-CNN R-50-FPN training
    steps (phase 5's cfg, params, batch and one set of sampling draws:
    loss and gradients, no update) under torch.use_deterministic_algorithms
    give bit-equal losses and gradients, through the deterministic K4
    (roi_window_accum_det) only; torch raises for any op of the step that
    has no deterministic implementation on the card. Then the same two
    steps with the switch off, for comparison (the atomic K4). Returns the
    kernels' launch counts under the switch."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    rk = roi_align_kernel
    set_cfg(tiny=False, dtype="bfloat16",
            extra=["SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)])
    params = make_params(device, torch.float32)
    batch = synthetic_train_batch(BATCH, *CANVAS, device,
                                  np.random.RandomState(0))
    draws = train_graph.make_draws(torch.Generator().manual_seed(0), BATCH,
                                   CANVAS, cfg.TPU.MAX_GT_BOXES, device)
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": rk.roi_window_pool,
                "roi_window_pool_seg": rk.roi_window_pool_seg,
                "roi_window_accum": rk.roi_window_accum,
                "roi_window_accum_det": rk.roi_window_accum_det}

    def two_steps(deterministic):
        torch.use_deterministic_algorithms(deterministic)
        try:
            runs, times = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                total, _, grads = ts.loss_and_grads(params, batch, draws)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                runs.append((total, _flat(grads)))
        finally:
            torch.use_deterministic_algorithms(False)
        (t0_, g0), (t1_, g1) = runs
        differ = sum(not torch.equal(a, b) for a, b in zip(g0, g1))
        return bool(torch.equal(t0_, t1_)), differ, len(g0), times

    two_steps(True)   # warm-up: cuDNN's deterministic plans
    for fn in wrappers.values():
        fn.launches = 0
    same_loss, differ, n, times = two_steps(True)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    off_loss, off_differ, _, off_times = two_steps(False)
    print("deterministic training (Mask R-CNN R-50-FPN, bf16 / f32 params, "
          "{} x {} x {}, loss and gradients twice on the same inputs; "
          "CUBLAS_WORKSPACE_CONFIG {}): under "
          "torch.use_deterministic_algorithms losses equal {}, {} of {} "
          "gradient leaves differ, step ms {}, launches {}; with the switch "
          "off losses equal {}, {} leaves differ, step ms {}".format(
              BATCH, *CANVAS, os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
              same_loss, differ, n, [round(t, 3) for t in times], launches,
              off_loss, off_differ, [round(t, 3) for t in off_times]))
    if not same_loss or differ:
        raise AssertionError("two training steps under the deterministic "
                             "switch differ: {} of {} gradient leaves"
                             .format(differ, n))
    if launches["roi_window_accum"] or not launches["roi_window_accum_det"]:
        raise AssertionError("under the switch K4 must run its "
                             "deterministic variant only: {}".format(
                                 launches))
    return launches


def run_det_resume_check(device, workdir):
    """Phase 14, the trainer: train_net_step --deterministic at phase 8's
    full width (calibrated weights from a Detectron .pkl, TRAIN.SCALES
    (800,), flips, batch 2) for four steps, and for two steps then
    --resume to four. The resumed run must end in the uninterrupted run's
    checkpoint bit for bit (params, momentum and step) with the same
    stats, through K4's deterministic variant only. Returns the kernels'
    launch counts over the three runs."""
    import torch

    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

    rk = roi_align_kernel
    make_valset(workdir, TRAIN_NET_IMAGES, "train2017")
    # One image batch a step, as the preset's schedule counts them: no
    # linear scaling, so MAX_ITER is the number of steps.
    extra = ["DATA_DIR", workdir, "NUM_GPUS", "1", "TRAIN.IMS_PER_BATCH",
             str(BATCH)]
    set_cfg(tiny=False, dtype="bfloat16", extra=extra)
    tree = calibrate_detector_params(init.init_model(0),
                                     np.random.RandomState(0))
    pkl = workdir + "/model_final.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f,
                    pickle.HIGHEST_PROTOCOL)
    del tree
    wrappers = {"nms_keep_mask": nms_kernel.nms_keep_mask,
                "roi_window_pool": rk.roi_window_pool,
                "roi_window_pool_seg": rk.roi_window_pool_seg,
                "roi_window_accum": rk.roi_window_accum,
                "roi_window_accum_det": rk.roi_window_accum_det}
    for fn in wrappers.values():
        fn.launches = 0

    def cli(out, steps, *flags):
        set_cfg(tiny=False, dtype="bfloat16",
                extra=extra + ["OUTPUT_DIR", workdir + "/" + out])
        t0 = time.perf_counter()
        run = train_net_step.main([
            "--dataset", "coco2017", "--bs", str(BATCH), "--nw", "4",
            "--load_detectron", pkl, "--ckpt_num_per_epoch", "1",
            "--disp_interval", "1", "--device", device, "--deterministic",
            "--set", "SOLVER.MAX_ITER", str(steps),
            "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS),
            "TRAIN.USE_FLIPPED", "True", "TRAIN.SCALES", "(800,)",
            "TRAIN.MAX_SIZE", "1333"] + list(flags))
        torch.cuda.synchronize()
        if torch.are_deterministic_algorithms_enabled():
            raise AssertionError("train_net_step --deterministic left the "
                                 "switch on")
        return run, time.perf_counter() - t0

    full, t_full = cli("full", 4)
    half, t_half = cli("half", 2)
    rest, t_rest = cli("rest", 4, "--load_ckpt", half["ckpt"], "--resume")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    got = net_utils.load_ckpt(rest["ckpt"])
    ref = net_utils.load_ckpt(full["ckpt"])
    flat_got, flat_ref = opt.flatten(got[1]), opt.flatten(ref[1])
    differ = [p for (p, a), (_, b) in zip(flat_got, flat_ref)
              if a.shape != b.shape or not np.array_equal(a, b)]
    finite = all(np.isfinite(list(row.values())).all()
                 for row in full["stats"])
    print("deterministic resume (train_net_step --deterministic, Mask R-CNN "
          "R-50-FPN, bf16 / f32 params, --bs {} --load_detectron, "
          "TRAIN.SCALES (800,) / MAX_SIZE 1333, USE_FLIPPED, CLIP_GRADIENTS "
          "{}): 4 steps in {:.3f} s; 2 steps in {:.3f} s, then --resume from "
          "step {} to 4 in {:.3f} s; checkpoints at steps {} / {}, {} of {} "
          "leaves (params and momentum) differ; stats of steps 2-3 equal "
          "{}; launches {}".format(
              BATCH, CLIP_GRADIENTS, t_full, t_half, rest["start_step"],
              t_rest, got[0], ref[0], len(differ), len(flat_ref),
              rest["stats"] == full["stats"][2:], launches))
    if rest["start_step"] != 2 or len(rest["stats"]) != 2 or \
            got[0] != ref[0] or len(flat_got) != len(flat_ref) or differ \
            or rest["stats"] != full["stats"][2:] or not finite:
        raise AssertionError("a --resume'd deterministic run differs from "
                             "the uninterrupted one: {} leaves ({}), stats "
                             "{} / {}".format(len(differ), differ[:5],
                                              rest["stats"],
                                              full["stats"][2:]))
    if launches["roi_window_accum"] or not launches["roi_window_accum_det"]:
        raise AssertionError("under --deterministic K4 must run its "
                             "deterministic variant only: {}".format(
                                 launches))
    return launches


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-train", action="store_true",
                    help="profile one more training step and time its "
                    "stages")
    ap.add_argument("--clip-gradients", type=float, default=CLIP_GRADIENTS,
                    help="SOLVER.CLIP_GRADIENTS of the training main path "
                    "(0: no clipping)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is false")
    from detectron_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Phase 14 runs under torch.use_deterministic_algorithms, whose matmuls
    # need a deterministic cuBLAS workspace, read when cuBLAS starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    for source, log in build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas {}: {}".format(source, line.strip()))

    set_cfg(tiny=False, dtype="bfloat16")
    entries = check_kernels(device)
    check_ladder_grad(device)
    check_small_input(device)
    check_small_input(device, FUSED_RES2)
    check_small_train(device)
    check_small_input(device, keypoints=True)
    check_small_train(device, keypoints=True)
    check_small_input(device, c4=True)
    check_small_train(device, c4=True)
    check_small_input(device, RESNEXT_TINY, pixel_scale=20.0, cls_scale=30.0)
    check_small_train(device, extra=RESNEXT_TINY)
    check_small_input(device, GN_TINY, pixel_scale=20.0, cls_scale=100.0)
    check_small_train(device, extra=GN_TINY)
    paths = {"inference": run_main_path(device),
             "training": run_train_path(device, args.profile_train,
                                        args.clip_gradients),
             "inference_fused_res2": run_main_path(device, FUSED_RES2)}
    compare_fused_inference(device)
    with tempfile.TemporaryDirectory() as workdir:
        paths["test_net"] = run_engine_path(device, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        paths["train_net"] = run_train_net_path(device, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        paths["keypoint_infer"], paths["keypoint_test_net"] = \
            run_keypoint_infer_path(device, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        paths["keypoint_train"] = run_keypoint_train_net_path(device,
                                                              workdir)
    for model, key, engine in ((C4_MODEL, "c4", True),
                               (X152_MODEL, "x152", True),
                               (GN_MODEL, "gn", False)):
        if key == "x152":
            paths["deterministic_train"] = run_det_train_check(device)
            with tempfile.TemporaryDirectory() as workdir:
                paths["deterministic_resume"] = run_det_resume_check(
                    device, workdir)
        t0 = time.perf_counter()
        set_cfg(tiny=False, dtype="bfloat16", **model["cfg"])
        base = make_tree()
        print("{} set-up: init_model and calibrate_detector_params in "
              "{:.3f} s".format(model["label"], time.perf_counter() - t0))
        paths[key + "_infer"] = run_model_infer_path(device, model, base)
        if engine:
            with tempfile.TemporaryDirectory() as workdir:
                paths[key + "_test_net"] = run_model_engine_path(
                    device, workdir, model, base)
        with tempfile.TemporaryDirectory() as workdir:
            paths[key + "_train"] = run_model_train_net_path(
                device, workdir, model, base)
        del base

    meta = {
        "nms_keep_mask": ("detectron_tpu_torch/csrc/nms_keep_mask.cu",
                          "detectron_tpu/ops/pallas/nms_kernel.py:92"),
        "roi_window_pool": ("detectron_tpu_torch/csrc/roi_window_pool.cu",
                            "detectron_tpu/ops/pallas/roi_align_kernel.py:546"),
        "roi_window_pool_seg": (
            "detectron_tpu_torch/csrc/roi_window_pool.cu",
            "detectron_tpu/ops/pallas/roi_align_kernel.py:304"),
        "roi_window_accum": (
            "detectron_tpu_torch/csrc/roi_window_accum.cu",
            "detectron_tpu/ops/pallas/roi_align_kernel.py:458"),
        "roi_window_accum_det": (
            "detectron_tpu_torch/csrc/roi_window_accum_det.cu",
            "detectron_tpu/ops/pallas/roi_align_kernel.py:458"),
        "stem_pool": ("detectron_tpu_torch/csrc/stem_pool.cu",
                      "detectron_tpu/ops/pallas/fused_stem_kernel.py:473"),
        "fused_res2": ("detectron_tpu_torch/csrc/fused_res2.cu",
                       "detectron_tpu/ops/pallas/fused_stem_kernel.py:328"),
    }
    # The path each kernel's launches are read from: the main (inference)
    # path for K1-K3, training for K4, the deterministic training steps
    # for K4's deterministic variant, TPU.FUSED_RES2 inference for K5/K6.
    path_of = {"nms_keep_mask": "inference", "roi_window_pool": "inference",
               "roi_window_pool_seg": "inference",
               "roi_window_accum": "training",
               "roi_window_accum_det": "deterministic_train",
               "stem_pool": "inference_fused_res2",
               "fused_res2": "inference_fused_res2"}
    kernels = []
    for name, (src, rep) in meta.items():
        e = entries[name]
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_path[path_of[name]],
            "launches_by_path": by_path,
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "device_ms": e["device_ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None, "shape": e["shape"],
            **{k: v for k, v in e.items() if k.startswith((
                "atomic_", "roi_reach_kernel_",
                "roi_window_accum_det_kernel_", "other_"))},
            **{k: dict(v, library_ms=None) for k, v in e.items()
               if k.startswith("c4")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
