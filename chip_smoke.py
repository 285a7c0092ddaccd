#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detectron_tpu_torch) on one GPU.

Run from the repository root:
    python3 chip_smoke.py [--profile-train] [--clip-gradients X]

Phases, each of which raises on failure (exit code != 0, no result line):
  1. Device and build: the card's name and power limit from nvidia-smi,
     then every CUDA kernel (K1-K6) built from csrc/, ptxas's registers
     and spills, and the count of TF32 tensor-core products
     (HMMA.1688.F32.TF32) and scalar FFMAs in the SASS of K6's float32
     route, which must have the former.
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
     max|ref| with under 20% of the elements differing, in f32 (at the
     full-width res2 input and at phase 3's) within 1e-5 max|ref|), with
     median CUDA-event times of both (one call
     between two events, so a small kernel's time includes its wrapper's
     host time), the kernel's device time alone (device_ms, torch.profiler
     over 10 calls), and the least time the card could take for the same
     work (bound_ms:
     bytes over 3.35 TB/s or operations over the peak rate of the inputs'
     type, 989 TFLOP/s bf16 and 67 TFLOP/s f32, whichever is larger; for
     K6's float32 route, which multiplies on the tensor cores as three
     TF32 products, operations over the larger of 67 and 494.7 / 3
     TFLOP/s). Yardstick lines time the port's unfused stem post-ops +
     res2 stage (cuDNN) beside K5 + K6 on the same input in bf16, and in
     f32 the unfused post-ops then res2 by cuDNN (TF32 off) or by K6's
     float32 route (the "auto" mode).
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
     same two steps with the switch off are printed beside them. The same
     pair for Mask R-CNN R-50-C4 (its preset, full width: K4's variant at
     the whole-map window of the res4 map). Then
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
  19. Test-time augmentation (core/test_aug.py) of Mask R-CNN R-50-FPN
     over TTA_IMAGES synthetic images through run_inference (test_net
     routes TTA to im_detect_all): TEST.BBOX_AUG H_FLIP and TTA_SCALES
     (400-1200) at MAX_SIZE 2000, each flipped, UNION / UNION, and
     TEST.MASK_AUG SOFT_AVG over the same scales and flips (18 detect and
     18 mask passes an image), to COCO box and mask AP; Keypoint R-CNN
     with TEST.KPS_AUG HM_AVG likewise, to keypoint AP. Prints seconds per
     image, the canvases visited and K1-K3's launches per image; TTA on
     with no scale and no flip must give the plain im_detect_all's boxes
     and RLEs bit for bit. Phase 2 holds K1-K3 against their plain
     versions on the inputs a full-width pass at the largest TTA canvas
     (1216 x 2016) gives them.
  20. The rest of the model cfg surface, each at full width in bf16: one
     inference batch (after a warm-up batch) and one training step of C4
     with RoIPoolF (and its RoI transform alone, timed, with its peak
     memory), C4 with RESNETS.RES5_DILATION 2 (28 x 28 masks), FPN with
     RoICrop (likewise timed), TPU.S2D_STEM and TPU.S2D_INPUT (each stem
     held against the plain stem within bf16 rounding), FPN.EXTRA_CONV_
     LEVELS with ZERO_INIT_LATERAL (RPN_MAX_LEVEL 7), and the v1up mask
     head with MRCNN.USE_FC_OUTPUT (class-agnostic: VARIANTS says why);
     the FPN RoIAlign routes (TPU.ROI_IMPL windowed and gather,
     TPU.ROI_LADDER False, TPU.ROI_LADDER_NARROW True; each with the
     device time of its RoI transforms in one profiled batch, and the
     exact ones, all but ROI_LADDER False, with the default ladder's
     detections on the same params and images in float32: 95% matched,
     counts within 5%), each after phase 3's small GPU-against-CPU
     inference check of its cfg, and RoIPoolF and RoICrop alone on the
     card against the CPU.
  21. tools/infer_simple.main over demo/'s three JPEGs (480 x 640, 640 x
     480, 500 x 500 -> 800 on the short side), with configs/baselines/
     e2e_mask_rcnn_R-50-FPN_1x.yaml and phase 4's calibrated weights as a
     checkpoint (--load_ckpt), then with the Keypoint R-CNN yaml,
     --dataset keypoints_coco and phase 9's calibration (on the demo
     images' blobs: the main inputs' calibration leaves them no person),
     bf16, --thresh 0.7: each image's cls_boxes and cls_segms / cls_keyps
     equal detect_graph + device_outputs_to_image_results on the same
     blob, bit for bit; a non-empty file per image (the tool's matplotlib
     PDF where the host has matplotlib, else its OpenCV drawing as a PNG,
     said on a line of its own); seconds and K1-K3 launches per
     image.
  22. VOC: a synthetic VOC2007 (make_synthetic_valset.make_vocset: 16
     trainval and 8 test images at ~500 x 375, 20 classes, the converted
     jsons and the devkit tree), then tools/train_net.main --dataset
     voc2007 with the Faster R-CNN R-50-FPN yaml from its calibrated
     weights as a .pkl, --bs 2 (8 steps an epoch, no flips) --epochs 2
     --lr_decay_epochs 1: model_epoch1 and model_epoch2, the lr of epoch 2
     BASE_LR x GAMMA, and --resume from model_epoch1 running epoch 2 only;
     then tools/test_net.main --dataset voc2007 from model_epoch2 (devkit
     XML through task_evaluation), the devkit-XML and json protocols
     equal on the detections as the comp4 files round them, and the
     ground truth fed back scoring mAP 1 (within 1e-12: the 11-point sum)
     by both; step ms, img/s and K1-K4 launches.
  23. Cityscapes: make_cityscapes_set's 8 images of 1024 x 2048 (8
     classes of polygon instances, a crowd region and an instance under
     100 px an image), tools/test_net.main with the Mask R-CNN yaml and
     MODEL.NUM_CLASSES 9 (COCO-protocol box and mask AP through
     task_evaluation), then evaluate_masks_official on the engine's
     detections and on the ground truth fed back (AP 1); img/s and the
     evaluation's seconds.
  24. The native host ops (detectron_tpu_torch/native) built with g++ on
     the card's host, each against its numpy twin at engine sizes, bit for
     bit: nms over 80 classes of 100-1000 detections, rle_encode /
     rle_decode of 100 masks of 800 x 1333, poly_to_counts of 200 seeded
     polygons, rle_intersection through the mask IoU of 100 x 50 RLEs;
     each op's ms, native and numpy (host code: no kernel).
  Phases 25-28, parallelism. The card's host has one H100 and NCCL takes
  one rank per card, so the ranks (one process each,
  detectron_tpu_torch/parallel/launch.py) share cuda:0 over gloo, which
  reduces CUDA tensors through the host; their times are not a
  multi-card speed.
  25. Data-parallel training at full width (phase 5's model, batch,
     draws and weights, global batch 2, 2 ranks of 1 image): one step in
     float32 with TF32 off and the convolutions without cuDNN in the
     ranks and in a one-process train_step on both images, so that an
     image's forward does not depend on its batch: losses within
     PAR_LOSS_RTOL, params within PAR_PARAM_REL of each leaf's largest
     value, every rank's stats equal; then 1 + 3 steps in bf16 (cuDNN on)
     per rank and in one process, median step ms of each, and the
     bucketed all-reduce of the gradient tree timed through gloo; an
     NCCL world of 1 on the card (init, the all-reduce timed, 1 + 3
     steps); the cross-card NCCL step against the one-process step where
     torch.cuda.device_count() >= 2, else a line saying it did not run.
  26. tools/train_net_step in 2 processes with --multihost_coordinator
     localhost:<port> --num_hosts 2 --host_rank r --dist_backend gloo on
     phase 8's synthetic training set (the Mask R-CNN yaml, bf16, global
     batch 2 at TRAIN.SCALES 800): both join the world of 2, their loader
     seeds differ, they log identical finite json_stats, only rank 0
     writes checkpoints, and a --resume from its model_step2 continues
     at step 2.
  27. tools/test_net in 2 such processes on phase 7's ENGINE_IMAGES noise
     images,
     batch 8 (4 rows a rank), against the one-process engine on batches
     of 4 (each rank's rows): boxes and scores within 1e-3, identical
     RLEs and equal COCO AP lines; img/s from rank 0's log.
  28. parallel/dryrun.dryrun_multichip(4) on cuda:0: 2 data x 2 model
     ranks with the box head's fc6 / fc7 split, float32 without cuDNN,
     its step against the one-process step on its 2 images, at phase
     25's tolerances.
  29. The float32 TPU.FUSED_RES2 path at full width (run after phase 6):
     the "auto" mode (the unfused stem post-ops, then K6's float32 route),
     which the default TPU.COMPUTE_DTYPE takes. detect_graph on phase 4's
     images and calibrated weights in float32, then train_step on phase
     5's batch and draws, each with TPU.FUSED_RES2 off and on in turns
     (off, on, on, off; MAIN_RUNS batches or TRAIN_STEPS steps a turn
     after a warm-up): host ms a batch and a step, K6 launched once a
     batch and a step (and never with the switch off), the detections on
     against off by phase 3's criterion (95% matched, counts within 5%),
     finite training stats, the warm-up step's loss on within
     LOSS_REL_F32 of off, K6 on the training batch's own res2 input
     within 1e-5 max|ref| of fused_res2_plain, then one profiled batch of
     each setting (busy time, idle share). One on turn's launches go into
     launches_by_path as "inference_fused_res2_f32" and
     "training_fused_res2_f32".
  30. The measuring and parity tools at full width
     (detectron_tpu_torch/tools; run after phase 24, and
     multiscale_bench inside the X-152 block): profile_net for 2
     inference steps and 1 training step (R-50-FPN, batch 2, bf16,
     --calibrate; the training step at CLIP_GRADIENTS) and
     trace_summary on both traces: the inference trace's device self
     time within TRACE_SESSION_REL (0.5%) of its own profiler session's
     device total (key_averages()), and a step of it within
     TRACE_BUSY_REL of profile_call's busy time for the same step (the
     median of 3 profiles; the kernels behind the gap are printed), K1
     attributed to
     ops/nms.py and K2 / K3 to ops/windowed_roi.py, K4 in the training
     trace; stage_bench at batch 2 (2 iterations, calibrated); roi_bench
     at batch 2 with P = 7 / 1000 RoIs and P = 14 / 100 RoIs, the ladder
     and the level sweep within bf16_close's elementwise limit of the
     exact gather; golden_compare: a dump of phase 4's calibrated tree
     (the Mask R-CNN yaml, bf16) on one 800 x 1333 noise image, a dump
     through --pkl of that tree, and their --diff, which must exit 0;
     multiscale_bench --scales 640 800 --iters 2 on the X-152 block's
     tree (finite losses). Each tool's K1-K6 launches (K4's
     deterministic variant among them) go into
     launches_by_path ("profile_net_infer", "profile_net_train",
     "stage_bench", "roi_bench_p7", "roi_bench_p14", "golden_compare",
     "golden_compare_pkl", "multiscale_bench").
  31. The twin of bench.py (detectron_tpu_torch/tools/bench.py, run last,
     after phase 28), its three runs one after another in one fresh
     process (bench_twin_runs) with the BENCH_* variables of this
     environment cleared and BENCH_WINDOWS 1: default inference,
     inference with BENCH_SET "TPU.FUSED_RES2 True", and BENCH_MODE=train
     at its default batch. Each must end without an exception and print
     exactly one line on
     stdout, a JSON record with bench.py's metric name for its mode, unit
     "images/sec/chip", finite positive value, median, mfu and
     tflops_per_image, and device equal to this card's name; the line is
     printed after the run's stderr (the card line, the warm-up, and the
     "# run" line with the window rates and peak memory). The "# run"
     line's launch counts over the timed calls (bench.parse_stderr) go
     into launches_by_path ("bench_infer", "bench_infer_fused_res2",
     "bench_train"); K1 and K2 (and K4 training, K5 and K6 fused) must
     have launched.
  Each rank's K1-K4 launches go into launches_by_path ("dp_train_rank<r>",
  "nccl_world1_train", "multihost_train_rank<r>",
  "multihost_resume_rank<r>", "sharded_test_net_rank<r>",
  "dryrun_rank<r>"); K1, K2 and (training) K4 must launch on every rank.
  Phase 2 also holds K1 at the C4 RPN's one-level lanes (2, 6000) and
  (2, 12000), K2 with the whole res4 map as its window (P = 14, N = 2000
  and 200, bf16), K4 at the C4 training shapes (N = 1024 and 256),
  the conv epilogue (channel_epilogue: branch2c's AffineChannel, shortcut
  and ReLU in one pass) at the FPN cell's res2 block (64, 208, 336, 256)
  and the C4 cell's res5 block (16000, 7, 7, 2048), bf16, with the
  identity and branch1's shortcut (within 1 ulp, bit-equal on 99.9%),
  the narrow ladder's shapes (TPU.ROI_LADDER_NARROW: K2 at its (32, 40)
  base window, P = 7, N = 2000, K3 at its whole-top-level (32, 48) rung
  over the RoIs that take it, K4 at both), and
  K4's deterministic variant at every FPN and C4 shape of K4 (two calls
  bit-equal, K4's tolerance, its time beside the atomic kernel's on the
  same inputs with their device times' ratio, its kernels' device times
  by name (DET_KERNELS), its work items and split tiles, and at the FPN
  and C4 box shapes its pre-pass's tile lists against their plain
  version); phase 3 also checks a tiny Keypoint R-CNN detect_graph
  (heatmaps of matched detections within 1e-4 of max|cpu|) and
  train_step (loss_kps among the losses), a tiny Mask R-CNN R-50-C4, a
  tiny ResNeXt-50 32x8d and a tiny GN Mask R-CNN detect_graph and
  train_step, on the GPU against the CPU, at its tolerances.
  Phases 4-23 each zero the launch counters just before a path's run and
  read them just after; every kernel of the path must have launched (in
  the trainers K1, K2 and K4, in 11-12, 15-16 and 18's inference K1 and
  K2, in 14 K4's deterministic variant, in 19 K1 and K2, in 20 K1, and K2
  and K4 where the variant pools with RoIAlign through a window (and K3
  under TPU.ROI_LADDER_NARROW), in 21-23 K1 and K2, and
  in 22's epoch trainer K1, K2 and K4; K3 is reported).
Prints a {"kernels": [...]} line (each kernel's launches on its own path:
the inference main path for K1-K3, training for K4, phase 14 for K4's
deterministic variant, the TPU.FUSED_RES2 path for K5/K6;
launches_by_path has every path that counted the kernel (a path's run
reads only the counts of the kernels it can launch): "test_net" being
phase 7's
run_inference, "train_net" phase 8's train_net_step, "keypoint_infer"
and "keypoint_test_net" phase 9's detect_graph and run_inference,
"keypoint_train" phase 10's train_net_step, "c4_infer", "c4_test_net"
and "c4_train" phases 11-13, "deterministic_train",
"deterministic_c4_train" and "deterministic_resume" phase 14's FPN and
C4 steps and its trainer, "x152_infer",
"x152_test_net", "x152_train" phases 15-17, "gn_infer" and "gn_train"
phase 18, "tta_test_net" and "tta_keypoint_test_net" phase 19,
"variant_<name>_infer" / "variant_<name>_train" phase 20's,
"infer_simple" and "keypoint_infer_simple" phase 21, "voc_train_net",
"voc_train_net_resume" and "voc_test_net" phase 22,
"cityscapes_test_net" phase 23, and "bench_infer",
"bench_infer_fused_res2" and "bench_train" phase 31; K6 carries its
float32 route's measurements under "f32" (the full-width res2 input)
and "f32_small"
(phase 3's); K1, K2, K4
and K4's deterministic variant carry their C4 shapes' measurements under
"c4" (and K1's 12000-box lanes under "c4_train"), K1-K3 theirs at the
TTA canvas under "tta" (and "tta_tail", "tta_mask"), K2-K4 theirs at the
narrow ladder's base window and top rung under "narrow_base" and
"narrow_top_rung", the variant its
atomic twin's times as atomic_ms /
atomic_device_ms, its device time over the atomic's as
det_over_atomic_device, and its kernels' as <name>_device_ms with their
events a call for each name of DET_KERNELS), then as the last line
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
import glob
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Names of the port's CUDA kernels as the profiler lists them (DET_KERNELS:
# K4's deterministic variant); reset_launches sets the wrappers' launch
# counts to 0 and returns them by name.
from detectron_tpu_torch.ops.cuda import (DET_KERNELS, PORT_KERNELS,
                                          reset_launches)

BATCH = 2
CANVAS = (832, 1344)
# The wrappers of K1-K3, which every inference path of the main model runs.
MAIN_WRAPPERS = ("nms_keep_mask", "roi_window_pool", "roi_window_pool_seg")
IM_INFO = (800.0, 1333.0, 1.6)
MAIN_RUNS = 2
# Phase 7: the synthetic val set's size and the engine's batch.
ENGINE_IMAGES = 24
ENGINE_BATCH = 8
TRAIN_STEPS = 2
# Phase 29: the float32 warm-up step's loss with TPU.FUSED_RES2 on, relative
# to the unfused path's. K6 moves res2 by at most 1e-5 of its max|ref|, but
# the RPN's top-k and NMS and the RoI sampling turn that into whole proposal
# swaps (3.8e-4 measured on an H100); a K6 fault moves every level above.
LOSS_REL_F32 = 1e-2
# Phase 8: the synthetic training set's size and train_net_step's steps.
TRAIN_NET_IMAGES = 16
TRAIN_NET_STEPS = 8
# Phases 9 and 10: the synthetic person-keypoints sets (val: about 16
# images, batch ENGINE_BATCH; train: 16 images, 8 steps).
KPS_ENGINE_IMAGES = 16
KPS_VAL = "keypoints_coco_2017_val"
# Phase 12: the C4 engine's synthetic val set (batch ENGINE_BATCH).
C4_ENGINE_IMAGES = 16
# Phases 15-18: the repository's X-152 and GN yamls, the X-152 engine's
# synthetic val set, and train_net_step's steps for both.
X152_YAML = "configs/baselines/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x.yaml"
GN_YAML = "configs/gn_baselines/scratch_e2e_mask_rcnn_R-50-FPN_3x_gn.yaml"
X152_ENGINE_IMAGES = 16
MODEL_TRAIN_STEPS = 4
# Phase 19: test-time augmentation's scales (Detectron's published
# multi-scale test settings for its FPN models) at MAX_SIZE 2000, over
# TTA_IMAGES synthetic images; the largest canvas is 1216 x 2016.
TTA_SCALES = (400, 500, 600, 700, 900, 1000, 1100, 1200)
TTA_MAX_SIZE = 2000
TTA_IMAGES = 3
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
# "tf32x3": float32-accurate products on the tensor cores as three TF32
# products (494.7 TFLOP/s of TF32, dense); K6's float32 route alone
# runs them, and its bound is the lesser of the float32 and the tf32x3
# time.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 494.7e12 / 3}
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


def cpu_quota():
    """This process's cgroup CPU quota in whole cores (cgroup v2 cpu.max),
    or None where there is none."""
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        return None if quota == "max" else max(1, int(quota) // int(period))
    except (OSError, ValueError):
        return None


@contextlib.contextmanager
def phase_timer(label):
    """Prints "<label>: <seconds> s" when the block ends."""
    t0 = time.perf_counter()
    yield
    print("{}: {:.3f} s".format(label, time.perf_counter() - t0))


def cuda_call_ms(fn):
    """(milliseconds of one fn() call between two CUDA events, its
    result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def cuda_ms(fn, reps, warm=True):
    """Median milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run (none without `warm`: the caller has just run fn)."""
    import torch

    if warm:
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
    events a call)}. Every call launches the same kernels, but a trace may
    miss some calls (most traces on an H100 held 9 of 10): an event's time
    a call is its time per event seen times its events a call (rounded
    up). A trace with no device event is taken again, twice; then the
    call's CUDA-event time (cuda_ms, wrapper host time included) stands in,
    under the name "cuda events"."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=reps,
                                       repeat=1)) as prof:
            for _ in range(2 + reps):
                fn()
                torch.cuda.synchronize()
                prof.step()
        got = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and not getattr(e, "is_user_annotation", False)}
        if got:
            return {k: (ms / n * math.ceil(n / reps), math.ceil(n / reps))
                    for k, (ms, n) in got.items()}
    print("profiler: no device event in 3 traces; CUDA events instead")
    return {"cuda events": (cuda_ms(fn, reps), 1)}


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


def ladder_inputs(rng, n, pooled, window, device, dtype, rois=None):
    """A real-size canvas (B, 428, 432, 256) from a random pyramid of an
    832 x 1344 image (the narrow ladder's too: the same levels, padding
    and size), and window origins/weights of n RoIs of detector-like sizes
    (or of `rois`, (rois (n, 4), their images (n,))) at the given window
    shape (None: the ladder's base window)."""
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
    if rois is None:
        xy = rng.uniform(0, 1000, (n, 2))
        wh = rng.lognormal(4.5, 0.8, (n, 2)).clip(4, 800)
        rois = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
            np.float32)).to(device)
        img = torch.from_numpy(rng.randint(0, BATCH, n).astype(
            np.int32)).to(device)
    else:
        rois, img = rois
    sy, sx, vy, vx, _ = win.window_params(
        rois, geom, (0.25, 0.125, 0.0625, 0.03125), pooled, 2, 2, 5, 224, 4,
        window[0], window[1], dtype)
    return canvas, torch.stack([img, sy, sx], -1).contiguous(), vy, vx, \
        window


def narrow_top_rung_rois(device, rng):
    """The RoIs the narrow ladder (TPU.ROI_LADDER_NARROW) pools at its
    whole-top-level rung, top-level RoIs its (32, 40) base window does not
    cover: those among the box RoIs of phase 4's batch (its images and
    calibrated weights, 1000 proposals an image), or, where that batch has
    none, those among 400 large RoIs (900-1340 x 300-680 px from near the
    canvas's left edge, on random images). Returns ((rois (n, 4), images
    (n,) int32), phase 4's top-level RoIs, phase 4's RoIs at the rung)."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.ops import multilevel_roi as ml
    from detectron_tpu_torch.ops import windowed_roi as win

    dims = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    geom = win.ladder_geom(dims, tuple(tuple(r) for r in cfg.TPU.ROI_RUNGS),
                           narrow_base=True)
    scales = (0.25, 0.125, 0.0625, 0.03125)

    def at_rung(flat):
        ok = win.window_params(flat, geom, scales, 7, 2, 2, 5, 224, 4,
                               geom["wy_base"], geom["wx_base"],
                               torch.float32)[-1]
        covered, rid = win.rung_route(flat, geom, scales, 2, 5, 224, 4)
        return ~ok & covered & (rid == 0)

    params, images, im_info = main_inputs(device)
    with torch.no_grad():
        feats, _ = mb.forward_features(params, images)
        rois, _, _ = mb.generate_proposals(mb.forward_rpn(params, feats),
                                           feats, im_info, False)
    flat = rois.reshape(-1, 4).float()
    img = torch.arange(BATCH, dtype=torch.int32,
                       device=device).repeat_interleave(rois.shape[1])
    top = int((ml.roi_levels(flat, 2, 5, 224, 4) == 5).sum())
    sel = at_rung(flat)
    n_main = int(sel.sum())
    del params, images, feats
    if n_main == 0:
        n = 400
        xy = rng.uniform(0, 300, (n, 2)) * [1.0, 0.5]
        wh = np.stack([rng.uniform(900, 1340, n), rng.uniform(300, 680, n)],
                      -1)
        flat = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
            np.float32)).to(device)
        img = torch.from_numpy(rng.randint(0, BATCH, n).astype(
            np.int32)).to(device)
        sel = at_rung(flat)
    return (flat[sel].contiguous(), img[sel].contiguous()), top, n_main


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
        time alone) and its plain version (a callable, timed once: the
        reference call just made is its warm-up; or its milliseconds),
        and prints and keeps them (with the fields `more`): as the
        kernel's entry at its primary shape, and under entry[tag] (the C4
        paths' shapes: "c4")."""
        ms, dev = cuda_ms(fn, 20), device_ms(fn)
        plain_ms = plain if isinstance(plain, float) else \
            cuda_ms(plain, 1, warm=False)
        print("check {} {}: max_abs_err={} kernel_ms={:.4f} device_ms={:.4f} "
              "plain_ms={:.4f} bound_ms={:.4f} ({}) share={:.3f}{}".format(
                  name, shape, err, ms, dev, plain_ms, *bnd, bnd[0] / dev,
                  "".join(" {}={:.4f}".format(k, v)
                          for k, v in more.items())))
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
        plain_ms, ref = cuda_call_ms(
            lambda: nms_kernel.nms_keep_mask_plain(boxes, valid, thr))
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
               plain_ms, nms_bound(boxes, valid, ref),
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
                        tag=None, lists=False):
        """K4's deterministic variant on K4's inputs: two calls bit-equal,
        within K4's tolerance of the plain version; timed beside the atomic
        kernel on the same inputs, with its device time over the atomic's.
        With `lists`, its pre-pass's per-tile lists equal their plain
        version (roi_tile_lists_plain)."""
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
        counts, listed = rk.roi_tile_lists(starts, vy, vx, rows, zero.shape)
        if lists:
            want = rk.roi_tile_lists_plain(starts, vy, vx, rows, zero.shape,
                                           rk.DET_TILE)
            if not (torch.equal(counts, want[0]) and
                    torch.equal(listed, want[1])):
                raise AssertionError(
                    "K4's deterministic variant at {}: the pre-pass's "
                    "tile lists differ from roi_tile_lists_plain ({} / {} "
                    "entries)".format(shape, listed.numel(),
                                      want[1].numel()))
            shape += ", tile lists equal their plain version"
        # Work items (32 rows of a tile's list) and the tiles whose items
        # chain their read-modify-writes in list order.
        chunks = (counts.long() + 31) // 32
        shape += " ({} rows listed in {} tiles, {} items, {} split)".format(
            listed.numel(), int((counts > 0).sum()), int(chunks.sum()),
            int((chunks > 1).sum()))
        # The variant's kernels by name, with their events a call (1 each
        # when the profiler sees every launch).
        named = {}
        for key, (ms, count) in device_kernels(
                lambda: rk.roi_window_accum_det(got, *args)).items():
            kernel = next((k for k in DET_KERNELS if k in key), "other")
            old = named.get(kernel, (0.0, 0.0))
            named[kernel] = (old[0] + ms, old[1] + count)
        det_dev = sum(ms for ms, _ in named.values())
        atomic_dev = device_ms(lambda: rk.roi_window_accum(got, *args))
        record("roi_window_accum_det", shape + ", two calls bit-equal", err,
               lambda: rk.roi_window_accum_det(got, *args),
               lambda: rk.roi_window_accum_plain(ref, *args), bnd, primary,
               tag, atomic_ms=cuda_ms(lambda: rk.roi_window_accum(got, *args),
                                      20),
               atomic_device_ms=atomic_dev,
               det_over_atomic_device=det_dev / atomic_dev,
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
                (pooled, r) == (7, None), lists=(pooled, r) == (7, None))
        del canvas, zero, got, ref

    check_narrow_window_kernels(device, rng, pool_check, record)
    check_c4_window_kernels(device, pool_check, record, det_accum_check)
    check_fused_kernels(device, rng, record)
    check_channel_epilogue(device, record)
    check_tta_canvas_kernels(device, pool_check, record)
    return entries


def check_narrow_window_kernels(device, rng, pool_check, record):
    """Phase 2, continued: the narrow ladder's kernel shapes
    (TPU.ROI_LADDER_NARROW) at 832 x 1344. K2 at its (32, 40) base window
    (P = 7, N = B * 1000, bf16), K3 at its whole-top-level (32, 48) rung
    over the RoIs that take it (narrow_top_rung_rois: phase 4's batch's,
    or large ones where that batch has none),
    and K4 at both (the training box count, N = B * 512, at the base; the
    same top-level rows at the rung), each against its plain version at
    its tolerance; entries "narrow_base" and "narrow_top_rung"."""
    import torch

    from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

    top, n_top, n_main = narrow_top_rung_rois(device, rng)
    count = int(top[0].shape[0])
    print("narrow ladder on phase 4's batch: {} top-level box RoIs, {} of "
          "them at the whole-top-level rung; the rung's check takes {} "
          "rows{}".format(n_top, n_main, count, "" if n_main else
                          " of 400 large RoIs (narrow_top_rung_rois)"))
    if count == 0:
        raise AssertionError("no RoI at the narrow ladder's top rung")
    cases = (("narrow_base", BATCH * 1000, BATCH * 512, (32, 40), None),
             ("narrow_top_rung", count, count, (32, 48), top))
    for tag, n_pool, n_accum, window, rois in cases:
        seg = tag == "narrow_top_rung"
        canvas, starts, vy, vx, _ = ladder_inputs(
            rng, n_pool, 7, window, device, torch.bfloat16, rois)
        rows = (0, n_pool)
        pool = (lambda *a: rk.roi_window_pool_seg(*a, rows)) if seg else \
            rk.roi_window_pool
        pool_check("roi_window_pool_seg" if seg else "roi_window_pool", pool,
                   lambda *a: rk.roi_window_pool_plain(*a, rows=rows),
                   (canvas, starts, vy, vx), rows,
                   "narrow ladder P=7 N={} window={} canvas={}".format(
                       n_pool, window, tuple(canvas.shape)),
                   window_bound(canvas.shape, 2, starts, vy, vx, False),
                   False, tag)
        canvas, starts, vy, vx, _ = ladder_inputs(
            rng, n_accum, 7, window, device, torch.float32, rois)
        ct = torch.randn((n_accum, 7, 7, canvas.shape[-1]), device=device,
                         generator=torch.Generator(device).manual_seed(
                             n_accum))
        zero = torch.zeros_like(canvas)
        got = rk.roi_window_accum(zero.clone(), starts, ct, vy, vx)
        ref = rk.roi_window_accum_plain(zero.clone(), starts, ct, vy, vx)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        shape = "narrow ladder P=7 N={} window={} canvas={}".format(
            n_accum, window, tuple(canvas.shape))
        if not bool(torch.isfinite(got).all()) or err > tol or \
                float(ref.abs().max()) == 0.0:
            raise AssertionError("K4 roi_window_accum disagrees with its "
                                 "plain version at {}: max_abs_err {} > {}"
                                 .format(shape, err, tol))
        record("roi_window_accum", shape, err,
               lambda: rk.roi_window_accum(got, starts, ct, vy, vx),
               lambda: rk.roi_window_accum_plain(ref, starts, ct, vy, vx),
               window_bound(canvas.shape, 4, starts, vy, vx, True), False,
               tag)
        del canvas, zero, got, ref


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
                        False, "c4" if n == BATCH * 512 else None,
                        lists=n == BATCH * 512)
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

    ok, d = bf16_within(got, ref)
    share = float((d > 0).float().mean())
    return ok and share < 0.2, float(d.max()), share


def bf16_within(got, ref):
    """bf16_close's elementwise part: (every |got - ref| within 2^-7 |ref|
    + 2^-6 max|ref| and every value of got finite, |got - ref|). A NaN
    in either fails it."""
    import torch

    d = (got.float() - ref.float()).abs()
    top = float(ref.float().abs().max())
    ok = bool((d <= 2.0 ** -7 * ref.float().abs() + 2.0 ** -6 * top).all()) \
        and bool(torch.isfinite(got).all())
    return ok, d


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
    (B, 208, 336, 64), bf16; K6 also in f32 there (entry "f32") and at the
    phase-3 tiny canvas's res2 shape (B, 64, 80, 64) ("f32_small"). Prints
    the yardsticks: the port's unfused stem post-ops + res2 (cuDNN convs)
    beside K5 + K6 in bf16, and beside the unfused post-ops + K6 in f32."""
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
    for dtype, shape, tag in (
            (torch.bfloat16, (BATCH, Hp // 2, Wp // 2, 64), None),
            (torch.float32, (BATCH, Hp // 2, Wp // 2, 64), "f32"),
            (torch.float32, (BATCH, 64, 80, 64), "f32_small")):
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
        nbytes = pixels * (64 + 256) * item + RES2_WEIGHTS * item \
            + RES2_BIASES * 4
        bnd = bound(nbytes, 2 * RES2_MACS * pixels, "bfloat16") if tag is \
            None else min(bound(nbytes, 2 * RES2_MACS * pixels, t)
                          for t in ("float32", "tf32x3"))
        record("fused_res2", "x={} {} (share differing {:.4f}, max|ref| "
               "{:.3f})".format(shape, name, share,
                                float(ref.float().abs().max())),
               err, lambda: fk.fused_res2(h, folded),
               lambda: fk.fused_res2_plain(h, folded), bnd, tag is None,
               tag)
        del h, got, ref

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

    # The float32 yardstick: the unfused stem post-ops, then res2 by cuDNN
    # (TF32 off) or by fold + K6 (the "auto" mode's float32 route).
    x32 = x.float()
    stage32 = [{k: {n: t.float() for n, t in v.items()} for k, v in
                bp.items()} for bp in stage]

    def post_ops():
        return L.max_pool(L.relu(resnet._norm(bn, x32)), 3, 2, 1)

    def unfused32():
        y = post_ops()
        for bp in stage32:
            y = resnet.apply_bottleneck(bp, y, 1)
        return y

    def auto32():
        return fk.fused_res2(post_ops().contiguous(),
                             fk.fold_res2_weights(stage32, torch.float32))

    print("yardstick at x={} f32: unfused stem post-ops + res2 (cuDNN, "
          "TF32 off) {:.4f} ms; unfused post-ops + fold + K6 {:.4f} "
          "ms".format(tuple(x.shape), cuda_ms(unfused32, 20),
                      cuda_ms(auto32, 20)))


def check_channel_epilogue(device, record):
    """Phase 2, the conv epilogue at the benchmark cells' shapes, bf16:
    branch2c's output with its shortcut, identity and branch1's affine, of
    an FPN res2 block at batch 64 on the 832 x 1344 canvas (64, 208, 336,
    256) and of a C4 res5 block over 16 images' 1000 RoIs (16000, 7, 7,
    2048), all with ReLU. Within 1 bf16 ulp of the plain version and
    bit-equal on 99.9% of the elements (test_torch_cuda_kernels.py's
    criterion). Entries: the FPN identity form, then under "branch1",
    "c4" and "c4_branch1"."""
    import torch

    from detectron_tpu_torch.ops.cuda import channel_epilogue as ce

    def ordered(t):
        # bf16 bits as integers in the order of the values: two differ by
        # the values' distance in ulps.
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)

    gen = torch.Generator(device).manual_seed(7)
    for shape, cell in (((64, 208, 336, 256), ""), ((16000, 7, 7, 2048),
                                                     "c4")):
        C = shape[-1]
        s, b, s_r, b_r = (torch.randn(C, generator=gen, device=device)
                          * scale + base
                          for scale, base in ((0.5, 1), (1, 0), (0.5, 1),
                                              (1, 0)))
        y, r = ((torch.randn(shape, generator=gen, device=device) * 4).to(
            torch.bfloat16) for _ in range(2))
        for form, more in (("identity", ()), ("branch1", (s_r, b_r))):
            args = (y, s, b, r) + more
            got = ce.channel_epilogue(*args, relu=True)
            plain_ms, ref = cuda_call_ms(
                lambda: ce.channel_epilogue_plain(*args, relu=True))
            ulps = (ordered(got) - ordered(ref)).abs()
            share = float((ulps == 0).float().mean())
            if int(ulps.max()) > 1 or share < 0.999:
                raise AssertionError(
                    "channel_epilogue disagrees with its plain version at "
                    "{} ({} shortcut): {} ulps, {:.5f} equal".format(
                        shape, form, int(ulps.max()), share))
            # Bytes: y and r read once, out written once, the (C,)
            # vectors. Ops an element: the affine, the shortcut's add (and
            # its affine), the ReLU.
            record("channel_epilogue", "y={} bf16, {} shortcut (equal "
                   "{:.5f})".format(shape, form, share),
                   float((got.float() - ref.float()).abs().max()),
                   lambda: ce.channel_epilogue(*args, relu=True), plain_ms,
                   bound(3 * 2 * y.numel() + len(args) * 4 * C,
                         (4 + len(more)) * y.numel(), "float32"),
                   not cell and not more,
                   "_".join(k for k in (cell, form if more else "") if k)
                   or None)
            del got, ref, ulps
        del y, r


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
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
    from detectron_tpu_torch.utils import blob as blob_utils

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
    if cfg.TPU.S2D_INPUT:
        images = blob_utils.space_to_depth(images)
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
    ones: x * mask, whose gradient is the mask. Only relus whose input
    requires grad are recorded and masked."""
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
        if not x.requires_grad:
            # No gradient flows back through it (a frozen stage's ReLU), so
            # its sign at an input near 0 moves the step by rounding only.
            # The card runs these inside channel_epilogue, where no call
            # reaches here; the CPU calls here, so neither records them.
            return torch.relu(x)
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


def main_inputs(device, params=True, blocked=True, dtype=None):
    """The inference main path's params (None without `params`) and images
    (and im_info), bf16 unless `dtype`; with TPU.S2D_INPUT and `blocked`,
    the images' space_to_depth blocks, as that stem takes them."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import resnet

    dtype = dtype or torch.bfloat16
    params = make_params(device, dtype) if params else None
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(BATCH, *CANVAS, 3).astype(np.float32) * 20.0).to(
            device, dtype)
    if cfg.TPU.S2D_INPUT and blocked:
        images = resnet.space_to_depth(images)
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


def run_fused_f32_paths(device, clip):
    """Phase 29: the float32 TPU.FUSED_RES2 path at full width, the "auto"
    mode (the unfused stem post-ops, then K6's float32 route), which the
    default TPU.COMPUTE_DTYPE takes. detect_graph on phase 4's images and
    calibrated weights in float32, then train_step on phase 5's batch and
    draws (CLIP_GRADIENTS as phase 5), each with TPU.FUSED_RES2 off and on
    in turns (off, on, on, off): MAIN_RUNS batches or TRAIN_STEPS steps a
    turn after a warm-up, K6 launched once a batch and a step. On against
    off: the detections by check_small_input's criterion; the warm-up
    step's loss within LOSS_REL_F32 of the off turn's; and K6 on the
    training batch's own res2 input (the stem's unfused post-ops on its
    images) within 1e-5 max|ref| of fused_res2_plain. Then one profiled
    batch of each setting. Returns the launches of one on turn (MAIN_RUNS
    batches, TRAIN_STEPS steps):
    {"inference_fused_res2_f32": ..., "training_fused_res2_f32": ...}."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import bridge, resnet, train_graph
    from detectron_tpu_torch.models import layers as L
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    def settings(fused, train=False):
        set_cfg(tiny=False, dtype="float32",
                extra=(FUSED_RES2 if fused else []) +
                (["SOLVER.CLIP_GRADIENTS", str(clip)] if train else []))

    launches = {}
    settings(False)
    tree = make_tree()
    params = bridge.to_torch(tree, device, torch.float32)
    _, images, im_info = main_inputs(device, params=False,
                                     dtype=torch.float32)
    times, outs = {False: [], True: []}, {}
    wrappers = dict(kernel_wrappers(), fused_res2=fk.fused_res2)
    for fused in (False, True, True, False):
        settings(fused)
        outs[fused] = det.detect_graph(params, images, im_info)  # warm-up
        torch.cuda.synchronize()
        reset_launches(wrappers)
        t0 = time.perf_counter()
        for _ in range(MAIN_RUNS):
            det.detect_graph(params, images, im_info)
        torch.cuda.synchronize()
        times[fused].append((time.perf_counter() - t0) / MAIN_RUNS * 1e3)
        got = {name: fn.launches for name, fn in wrappers.items()}
        if got["fused_res2"] != (MAIN_RUNS if fused else 0):
            raise AssertionError("K6 launched {} times in {} float32 "
                                 "batches".format(got["fused_res2"],
                                                  MAIN_RUNS))
        if fused:
            launches = got
    require_launches(launches, ("nms_keep_mask", "roi_window_pool",
                                "fused_res2"), "float32 FUSED_RES2")
    on, off = ({k: v.cpu() for k, v in outs[f].items()} for f in (True,
                                                                  False))
    frac = match_detections(on, off)
    n_off, n_on = int(off["valid"].sum()), int(on["valid"].sum())
    print("float32 inference (Mask R-CNN R-50-FPN, {} x {} x {}) in turns "
          "(off, on, on, off), host ms per batch over {} batches: "
          "TPU.FUSED_RES2 off {}, on {}; on against off: valid {} / {}, "
          "matched {:.4f}; launches of an on turn {}".format(
              BATCH, *CANVAS, MAIN_RUNS, [round(t, 3) for t in times[False]],
              [round(t, 3) for t in times[True]], n_on, n_off, frac,
              launches))
    if n_off == 0 or frac < 0.95 or abs(n_off - n_on) > 0.05 * n_off:
        raise AssertionError("float32 detect_graph with TPU.FUSED_RES2 "
                             "disagrees with the unfused path")
    for fused in (False, True):
        settings(fused)
        profile_call("one float32 inference batch, TPU.FUSED_RES2 {}"
                     .format(fused), lambda: det.detect_graph(
                         params, images, im_info), n_kernels=20, n_ops=0)
    del params, outs

    batch = synthetic_train_batch(BATCH, *CANVAS, device,
                                  np.random.RandomState(0))
    train_launches, times, first = {}, {False: [], True: []}, {}
    wrappers = dict(kernel_wrappers(accum=True), fused_res2=fk.fused_res2)
    for fused in (False, True, True, False):
        settings(fused, train=True)
        params = bridge.to_torch(tree, device, torch.float32)
        opt_state = opt.init_opt_state(params)
        gen = torch.Generator().manual_seed(0)

        def step(params, opt_state):
            return ts.train_step(params, opt_state, batch,
                                 train_graph.make_draws(
                                     gen, BATCH, CANVAS,
                                     cfg.TPU.MAX_GT_BOXES, device))
        params, opt_state, stats = step(params, opt_state)   # warm-up
        first[fused] = {k: float(v) for k, v in stats.items()}
        torch.cuda.synchronize()
        reset_launches(wrappers)
        marks = [time.perf_counter()]
        for _ in range(TRAIN_STEPS):
            params, opt_state, stats = step(params, opt_state)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        times[fused].append(statistics.median(
            (b - a) * 1e3 for a, b in zip(marks, marks[1:])))
        got = {name: fn.launches for name, fn in wrappers.items()}
        if got["fused_res2"] != (TRAIN_STEPS if fused else 0):
            raise AssertionError("K6 launched {} times in {} float32 "
                                 "steps".format(got["fused_res2"],
                                                TRAIN_STEPS))
        if not all(np.isfinite(float(v)) for v in stats.values()):
            raise AssertionError("non-finite float32 training stats: "
                                 "{}".format(stats))
        if fused:
            train_launches = got
            with torch.no_grad():
                body = params["body"]
                h = resnet.stem_conv(body["conv1"], batch["images"].to(
                    torch.float32))
                h = L.max_pool(L.relu(resnet._norm(body["res_conv1_bn"], h)),
                               3, 2, 1).contiguous()
                folded = fk.fold_res2_weights(body["res2"], torch.float32)
                ref = fk.fused_res2_plain(h, folded)
                err = float((fk.fused_res2(h, folded) - ref).abs().max())
            top = float(ref.abs().max())
            print("float32 training batch's res2 input {}: K6 against "
                  "fused_res2_plain max_abs_err {:.3e} (limit {:.3e})".format(
                      tuple(h.shape), err, 1e-5 * top))
            if not err <= 1e-5 * top:
                raise AssertionError("K6 float32 disagrees with its plain "
                                     "version on the training batch")
            del h, ref
        del params, opt_state
    require_launches(train_launches, ("nms_keep_mask", "roi_window_pool",
                                      "roi_window_accum", "fused_res2"),
                     "float32 FUSED_RES2 training")
    rel = abs(first[True]["loss"] - first[False]["loss"]) / \
        abs(first[False]["loss"])
    print("float32 training (Mask R-CNN R-50-FPN, {} x {} x {}, {} RoIs/"
          "img) in turns (off, on, on, off), median host ms per step over {} "
          "steps: TPU.FUSED_RES2 off {}, on {}; warm-up step loss off {} on "
          "{} (relative difference {:.3e}, limit {}); launches of an on "
          "turn {}".format(
              BATCH, *CANVAS, cfg.TRAIN.BATCH_SIZE_PER_IM, TRAIN_STEPS,
              [round(t, 3) for t in times[False]],
              [round(t, 3) for t in times[True]], first[False]["loss"],
              first[True]["loss"], rel, LOSS_REL_F32, train_launches))
    if not rel <= LOSS_REL_F32:
        raise AssertionError("float32 train_step's loss with TPU.FUSED_RES2 "
                             "is {:.3e} away from the unfused path's".format(
                                 rel))
    return {"inference_fused_res2_f32": launches,
            "training_fused_res2_f32": train_launches}


def run_main_path(device, extra=()):
    """Phase 4 (or, with extra = FUSED_RES2, phase 6). Returns the kernels'
    launch counts over MAIN_RUNS batches."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg

    set_cfg(tiny=False, dtype="bfloat16", extra=extra)
    params, images, im_info = main_inputs(device)
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    wrappers = reset_launches(MAIN_WRAPPERS + ("channel_epilogue",) + (
        ("stem_pool", "fused_res2") if cfg.TPU.FUSED_RES2 else ()))
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
    from detectron_tpu_torch.ops.cuda import roi_align_kernel
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

    wrappers = kernel_wrappers(accum=True)
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


def profile_call(label, fn, n_kernels=20, n_ops=15, by_name=None):
    """torch.profiler over one call of fn: its wall time, the device time
    summed over its kernels (device events only, so no time is counted
    twice under the ops that launched it), the device's idle share, and
    the top kernels and ops by device time. Returns (wall ms, busy ms);
    a dict given as by_name gets {kernel: (calls, device ms)}."""
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
    # The program's dt.* spans (utils/tracing.py) also appear on the
    # device, as annotations that cover the kernels launched under them.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if by_name is not None:
        by_name.update({e.key: (e.count, e.self_device_time_total / 1e3)
                        for e in kernels})
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
    return wall, busy


# ---------------------------------------------------------------------------
# Phase 7: the dataset inference engine
# ---------------------------------------------------------------------------

def _check_engine_results(dets, roidb, num_classes, slack=0.0):
    """Every image has a result; each all_boxes[j][i] is a finite (n, 5)
    array inside its original image (give or take `slack` pixels: a
    flipped pass's box flipped back may start up to a pixel before 0),
    with as many RLEs of the image's size in all_segms[j][i]. Returns the
    number of detections."""
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
            if ((b[:, :4] < -slack).any() or (b[:, [0, 2]] > w + slack).any()
                    or (b[:, [1, 3]] > h + slack).any()):
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

    wrappers = kernel_wrappers()
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
    wrappers = kernel_wrappers(accum=True)
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


def calibrate_person_class(tree, device, frac=0.25, batches=None):
    """Turn the person column of cls_score (Keypoint R-CNN's one
    foreground class) so that about `frac` of the proposals of `batches`
    (a list of (images, im_info); default: the main inputs) score it above
    the background. calibrate_detector_params' background
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
    if batches is None:
        batches = [main_inputs(device, params=False)[1:]]
    fs = []
    for images, im_info in batches:
        with torch.no_grad():
            feats, scales = mb.forward_features(params, images)
            rois, _, valid = mb.generate_proposals(
                mb.forward_rpn(params, feats), feats, im_info, False)
            f = mb.forward_box_outputs(params, feats, scales, rois)[2]
        fs.append(f.float()[valid.reshape(-1)].cpu().numpy())
    f = np.concatenate(fs).astype(np.float64)
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
    wrappers = kernel_wrappers()
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
    reset_launches(wrappers)
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
    wrappers = kernel_wrappers(accum=True)
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

    label = model["label"]
    set_cfg(tiny=False, dtype="bfloat16", **model["cfg"])
    params = bridge.to_torch(calibrate_scores(base, device), device,
                             torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
    t0 = time.perf_counter()
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    wrappers = kernel_wrappers()
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
    wrappers = kernel_wrappers()
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
    wrappers = kernel_wrappers(accum=True)
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
# Phase 2, continued: K1-K3 at test-time augmentation's largest canvas
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_kernel_calls(calls):
    """K1-K3 where the paths call them (the names plain_kernels swaps),
    each call's arguments (tensors cloned) appended to calls[wrapper name]
    before it runs."""
    import torch

    from detectron_tpu_torch.ops import nms, roi_align, windowed_roi

    swaps = [(nms, "nms_keep_mask"), (roi_align, "roi_window_pool"),
             (windowed_roi, "roi_window_pool"),
             (windowed_roi, "roi_window_pool_seg")]
    saved = [getattr(m, n) for m, n in swaps]

    def spy(name, fn):
        def call(*args):
            calls.setdefault(name, []).append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)
        return call

    try:
        for (m, n), fn in zip(swaps, saved):
            setattr(m, n, spy(n, fn))
        yield
    finally:
        for (m, n), fn in zip(swaps, saved):
            setattr(m, n, fn)


def check_tta_canvas_kernels(device, pool_check, record):
    """Phase 2: K1, K2 and K3 against their plain versions on the inputs
    full-width passes at TTA's largest canvas give them: detect_graph of
    the main model (bf16; phase 19's weights, calibrate_scores on its
    uniform-noise images) on phase 19's synthetic images at
    max(TTA_SCALES) / TTA_MAX_SIZE, one image a pass, landscape ones (a
    1216 x 2016 canvas) first, with every K1-K3 call recorded, until a
    pass has launched K3 (the ladder's fix-up rungs, which only some
    proposals need; a portrait image's canvas is 2016 x 1216). K1 and K2
    are checked on the first pass's inputs, K3 on the first pass that
    launched it. Entries under "tta" (the RPN's K1 call, the box window,
    the first rung) and "tta_tail" / "tta_mask"."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_aug
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import image_io

    runs = []      # (canvas, {wrapper name: recorded calls}) per pass
    with tempfile.TemporaryDirectory() as workdir:
        make_valset(workdir, TTA_IMAGES)
        set_cfg(tiny=False, dtype="bfloat16", extra=[
            "DATA_DIR", workdir, "TEST.DATASETS", "('coco_2017_val',)"])
        params = bridge.to_torch(calibrate_scores(
            make_tree(), device, pixel_std=74.0), device, torch.bfloat16)
        # Landscape images first: their canvas is 1216 x 2016 (portrait
        # ones take 2016 x 1216).
        roidb = sorted(JsonDataset("coco_2017_val").get_roidb(gt=True),
                       key=lambda e: e["width"] < e["height"])
        for entry in roidb:
            blob, _, im_info = test_aug.prep_on_device(
                image_io.imread(entry["image"]), max(TTA_SCALES),
                TTA_MAX_SIZE, device)
            calls = {}
            with recorded_kernel_calls(calls):
                out = det.detect_graph(params, blob.to(torch.bfloat16),
                                       im_info)
            torch.cuda.synchronize()
            print("TTA canvas {}: image {} at {} x {}, {} valid detections, "
                  "recorded calls {}".format(
                      tuple(blob.shape[1:3]), entry["id"],
                      *im_info[0, :2].tolist(), int(out["valid"].sum()),
                      {k: len(v) for k, v in calls.items()}))
            runs.append(("TTA canvas {} x {}".format(*blob.shape[1:3]),
                         calls if not runs else {
                             k: v for k, v in calls.items()
                             if k == "roi_window_pool_seg"}))
            if calls.get("roi_window_pool_seg"):
                break
    set_cfg(tiny=False, dtype="bfloat16")
    del params, out
    # K1 and K2 from the first (landscape) pass, K3 from the first pass
    # that launched it.
    where, calls = runs[0]
    seg = next(((w, c["roi_window_pool_seg"]) for w, c in runs
                if c.get("roi_window_pool_seg")), (None, ()))
    for i, (boxes, valid, thr) in enumerate(calls.get("nms_keep_mask", ())):
        got = nms_kernel.nms_keep_mask(boxes, valid, thr)
        plain_ms, ref = cuda_call_ms(
            lambda: nms_kernel.nms_keep_mask_plain(boxes, valid, thr))
        err = int((got != ref).sum())
        L, N = valid.shape
        shape = "{}: L={} N={} ({})".format(
            where, L, N, "the RPN's levels stacked" if i == 0 else
            "the per-class tail")
        if err:
            raise AssertionError("K1 nms_keep_mask disagrees with its plain "
                                 "version at {}: {} keep bits".format(
                                     shape, err))
        record("nms_keep_mask", shape, err,
               lambda: nms_kernel.nms_keep_mask(boxes, valid, thr),
               plain_ms, nms_bound(boxes, valid, ref), False,
               ("tta", "tta_tail")[i] if i < 2 else None)
    for i, args in enumerate(calls.get("roi_window_pool", ())):
        n, P = args[2].shape[:2]
        pool_check("roi_window_pool", roi_align_kernel.roi_window_pool,
                   roi_align_kernel.roi_window_pool_plain, args, (0, n),
                   "{}: P={} N={} canvas={}".format(where, P, n,
                                                    tuple(args[0].shape)),
                   window_bound(args[0].shape, 2, *args[1:], False), False,
                   ("tta", "tta_mask")[i] if i < 2 else None)
    for i, args in enumerate(seg[1]):
        rows = args[4]
        lo, hi = rows
        pool_check("roi_window_pool_seg",
                   lambda *a: roi_align_kernel.roi_window_pool_seg(*a, rows),
                   lambda *a: roi_align_kernel.roi_window_pool_plain(
                       *a, rows=rows), args[:4], rows,
                   "{}: P={} rows={} window=({}, {})".format(
                       seg[0], args[2].shape[1], rows, args[2].shape[2],
                       args[3].shape[2]),
                   window_bound(args[0].shape, 2, *(t[lo:hi] for t in
                                                    args[1:4]), False),
                   False, "tta" if i == 0 else None)
    if not calls.get("nms_keep_mask") or not calls.get("roi_window_pool"):
        raise AssertionError("the pass at the TTA canvas launched no K1 or "
                             "no K2: {}".format(sorted(calls)))
    if not seg[1]:
        print("TTA canvas: no pass of the {} images launched K3 (no "
              "proposal needed a fix-up rung); K3 not checked there".format(
                  len(roidb)))


# ---------------------------------------------------------------------------
# Phase 19: test-time augmentation
# ---------------------------------------------------------------------------

def tta_keys(aug):
    """TEST.<aug>'s keys: on, with H_FLIP and TTA_SCALES at TTA_MAX_SIZE,
    each scale flipped too (SCALE_H_FLIP)."""
    p = "TEST.{}.".format(aug)
    return [p + "ENABLED", "True", p + "H_FLIP", "True", p + "SCALES",
            str(TTA_SCALES), p + "MAX_SIZE", str(TTA_MAX_SIZE),
            p + "SCALE_H_FLIP", "True"]


@contextlib.contextmanager
def counted_passes(passes):
    """core/test.py's detect_raw, mask_on_boxes_graph and
    kps_on_boxes_graph, each call's canvas (H, W) counted in
    passes[graph name]."""
    import collections

    from detectron_tpu_torch.core import test as det

    names = ("detect_raw", "mask_on_boxes_graph", "kps_on_boxes_graph")
    saved = [getattr(det, n) for n in names]

    def spy(name, fn):
        def call(params, images, *rest):
            passes.setdefault(name, collections.Counter())[
                tuple(images.shape[1:3])] += 1
            return fn(params, images, *rest)
        return call

    try:
        for n, fn in zip(names, saved):
            setattr(det, n, spy(n, fn))
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(det, n, fn)


def _tta_engine_run(device, args, label, n_images):
    """run_inference over the cfg's val set with every pass counted: (the
    results, wall seconds, K1-K3 launches, the passes)."""
    import torch

    from detectron_tpu_torch.core import test_engine

    wrappers = kernel_wrappers()
    passes = {}
    t0 = time.perf_counter()
    with counted_passes(passes):
        results = test_engine.run_inference(
            args, output_dir=args.out_dir, batch_size=ENGINE_BATCH,
            device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    canvases = sorted({c for counts in passes.values() for c in counts})
    print("{} TTA engine path (run_inference, {} images): {:.3f} s per "
          "image ({:.3f} s in all); passes per image {}; canvases visited "
          "{}; K1-K3 launches per image {}".format(
              label, n_images, wall / n_images, wall,
              {k: sum(v.values()) / n_images for k, v in passes.items()},
              canvases, {k: v / n_images for k, v in launches.items()}))
    missing = [k for k in ("nms_keep_mask", "roi_window_pool")
               if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the {} TTA path: {}"
                             .format(label, ", ".join(missing)))
    return results, launches, canvases


def run_tta_path(device, workdir):
    """Phase 19: test-time augmentation at full width, bf16. Mask R-CNN
    R-50-FPN over TTA_IMAGES synthetic images through run_inference
    (test_net routes TTA to im_detect_all): TEST.BBOX_AUG with H_FLIP and
    TTA_SCALES at TTA_MAX_SIZE, each flipped too, UNION / UNION, and
    TEST.MASK_AUG SOFT_AVG over the same scales and flips (18 detect and
    18 mask passes an image), to COCO box and mask AP; first a check that
    TTA on with no scale and no flip gives the plain im_detect_all's
    boxes and RLEs bit for bit. Then Keypoint R-CNN with TEST.KPS_AUG
    HM_AVG over the same scales and flips, to keypoint AP. Returns the
    launch counts of both runs."""
    import types

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import image_io
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.logging import setup_logging

    setup_logging(__name__)
    t0 = time.perf_counter()
    make_valset(workdir, TTA_IMAGES)
    data = ["DATA_DIR", workdir, "TEST.DATASETS", "('coco_2017_val',)"]
    set_cfg(tiny=False, dtype="bfloat16", extra=data)
    # The synthetic images are uniform 0-255 noise: 74 about the means.
    tree = calibrate_scores(make_tree(), device, pixel_std=74.0)
    args = types.SimpleNamespace(
        load_ckpt=net_utils.save_ckpt(workdir + "/train", 0, tree),
        load_detectron=None, out_dir=workdir + "/eval")
    del tree
    roidb = JsonDataset("coco_2017_val").get_roidb(gt=True)
    print("TTA set-up: {} images, checkpoint, in {:.3f} s".format(
        TTA_IMAGES, time.perf_counter() - t0))

    # TTA with no pass but the base one: the plain path's results, bit for
    # bit.
    params = test_engine.initialize_model_from_cfg(args, device=device)
    im = image_io.imread(roidb[0]["image"])
    plain = det.im_detect_all(params, im, device)
    set_cfg(tiny=False, dtype="bfloat16", extra=data + [
        "TEST.BBOX_AUG.ENABLED", "True", "TEST.MASK_AUG.ENABLED", "True"])
    tta = det.im_detect_all(params, im, device)
    n = sum(len(b) for b in plain[0][1:])
    same = all(np.array_equal(a, b) for a, b in zip(plain[0][1:],
                                                     tta[0][1:])) and \
        plain[1] == tta[1]
    print("TTA without scales or flips against the plain im_detect_all: {} "
          "detections, boxes and RLEs bit-equal: {}".format(n, same))
    if not same or n == 0:
        raise AssertionError("TTA with no pass but the base one differs "
                             "from the plain path ({} detections)".format(n))
    del params

    set_cfg(tiny=False, dtype="bfloat16", extra=data + tta_keys(
        "BBOX_AUG") + tta_keys("MASK_AUG") + [
            "TEST.BBOX_AUG.SCORE_HEUR", "UNION",
            "TEST.BBOX_AUG.COORD_HEUR", "UNION",
            "TEST.MASK_AUG.HEUR", "SOFT_AVG"])
    results, launches, canvases = _tta_engine_run(device, args, "Mask R-CNN",
                                                  TTA_IMAGES)
    with open(args.out_dir + "/detections.pkl", "rb") as f:
        dets = pickle.load(f)
    n_dets = _check_engine_results(dets, roidb, cfg.MODEL.NUM_CLASSES,
                                   slack=1.0)
    ap = {task: results["coco_2017_val"][task]["AP"]
          for task in ("box", "mask")}
    print("Mask R-CNN TTA: {} detections, box AP {}, mask AP {} (random "
          "weights)".format(n_dets, ap["box"], ap["mask"]))
    largest = blob_canvas(max(TTA_SCALES), TTA_MAX_SIZE)
    if largest not in canvases or not all(np.isfinite(list(ap.values()))) \
            or n_dets == 0:
        raise AssertionError("the TTA path missed the {} canvas, or gave no "
                             "detections or a non-finite AP".format(largest))

    kdir = workdir + "/kps"
    make_valset(kdir, TTA_IMAGES, keypoints=True)
    set_cfg(tiny=False, dtype="bfloat16", keypoints=True)
    tree = calibrate_person_class(make_tree(), device)
    set_cfg(tiny=False, dtype="bfloat16", keypoints=True, extra=[
        "DATA_DIR", kdir, "TEST.DATASETS", "('{}',)".format(KPS_VAL)]
        + tta_keys("KPS_AUG") + ["TEST.KPS_AUG.HEUR", "HM_AVG"])
    kargs = types.SimpleNamespace(
        load_ckpt=net_utils.save_ckpt(kdir + "/train", 0, tree),
        load_detectron=None, out_dir=kdir + "/eval")
    del tree
    results, k_launches, _ = _tta_engine_run(device, kargs, "Keypoint R-CNN",
                                             TTA_IMAGES)
    with open(kargs.out_dir + "/detections.pkl", "rb") as f:
        dets = pickle.load(f)
    n_dets = _check_keypoint_results(dets, JsonDataset(KPS_VAL).get_roidb(
        gt=True))
    kp_ap = results[KPS_VAL]["keypoint"]["AP"]
    print("Keypoint R-CNN TTA (KPS_AUG HM_AVG): {} detections, keypoint AP "
          "{} (random weights)".format(n_dets, kp_ap))
    if n_dets == 0 or not np.isfinite(kp_ap):
        raise AssertionError("the keypoint TTA path gave no detections or a "
                             "non-finite AP")
    return launches, k_launches


def blob_canvas(scale, max_size):
    from detectron_tpu_torch.utils import blob as blob_utils

    return tuple(blob_utils.static_canvas(scale, max_size))


# ---------------------------------------------------------------------------
# Phase 20: the rest of the model cfg surface
# ---------------------------------------------------------------------------

# (key, label, set_cfg's model arguments, cfg keys, the tree it shares,
# kernels its inference must launch). The trees: the FPN preset's for
# RoICrop, the s2d stems and the FPN RoIAlign routes (their params are the
# plain model's), the C4
# preset's for RoIPoolF and the dilated res5, and one each for the extra
# levels and the FC mask output. The FC output runs class-agnostic: at
# MRCNN.RESOLUTION 28 with 81 class-specific masks its FC would be
# 200704 x 63504 (1.27e10 weights, ~51 GB in float32); class-agnostic it
# is 200704 x 784 (1.6e8).
VARIANTS = (
    ("roipoolf", "C4 RoIPoolF", dict(c4=True),
     ["FAST_RCNN.ROI_XFORM_METHOD", "RoIPoolF",
      "MRCNN.ROI_XFORM_METHOD", "RoIPoolF"], "c4", ("nms_keep_mask",)),
    ("res5_dilation", "C4 RES5_DILATION 2", dict(c4=True),
     ["RESNETS.RES5_DILATION", "2", "MRCNN.RESOLUTION", "28"], "c4",
     ("nms_keep_mask", "roi_window_pool")),
    ("roicrop", "FPN RoICrop", {},
     ["FAST_RCNN.ROI_XFORM_METHOD", "RoICrop",
      "MRCNN.ROI_XFORM_METHOD", "RoICrop"], "fpn", ("nms_keep_mask",)),
    ("s2d_stem", "TPU.S2D_STEM", {}, ["TPU.S2D_STEM", "True"], "fpn",
     ("nms_keep_mask", "roi_window_pool")),
    ("s2d_input", "TPU.S2D_INPUT", {}, ["TPU.S2D_INPUT", "True"], "fpn",
     ("nms_keep_mask", "roi_window_pool")),
    ("roi_windowed", "TPU.ROI_IMPL windowed", {},
     ["TPU.ROI_IMPL", "windowed"], "fpn",
     ("nms_keep_mask", "roi_window_pool")),
    ("roi_gather", "TPU.ROI_IMPL gather", {}, ["TPU.ROI_IMPL", "gather"],
     "fpn", ("nms_keep_mask",)),
    ("roi_single_window", "TPU.ROI_LADDER False", {},
     ["TPU.ROI_LADDER", "False"], "fpn",
     ("nms_keep_mask", "roi_window_pool")),
    ("roi_narrow", "TPU.ROI_LADDER_NARROW True", {},
     ["TPU.ROI_LADDER_NARROW", "True"], "fpn",
     ("nms_keep_mask", "roi_window_pool", "roi_window_pool_seg")),
    ("extra_levels", "FPN EXTRA_CONV_LEVELS + ZERO_INIT_LATERAL", {},
     ["FPN.EXTRA_CONV_LEVELS", "True", "FPN.ZERO_INIT_LATERAL", "True",
      "FPN.RPN_MAX_LEVEL", "7"], "extra", ("nms_keep_mask",
                                           "roi_window_pool")),
    ("fc_mask", "v1up mask head + MRCNN.USE_FC_OUTPUT", {},
     ["MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v1up",
      "MRCNN.USE_FC_OUTPUT", "True", "MRCNN.CLS_SPECIFIC_MASK", "False"],
     "fc", ("nms_keep_mask", "roi_window_pool")),
)


# The FPN RoIAlign routes of phase 20 (TPU.ROI_IMPL 'windowed' and
# 'gather', TPU.ROI_LADDER False, TPU.ROI_LADDER_NARROW): their RoI
# transform's device time is read from a profiled batch, and those that
# compute exact RoIAlign must give the default ladder's detections.
ROI_ROUTES = ("roi_windowed", "roi_gather", "roi_single_window",
              "roi_narrow")
EXACT_ROUTES = ("roi_windowed", "roi_gather", "roi_narrow")


def roi_transform_device_ms(fn):
    """Device milliseconds of the RoI transforms of one fn() call (a
    batch): the kernels launched inside model_builder.roi_feature_transform
    (box and mask heads), from torch.profiler's events under a
    record_function range around each of its calls. Returns (ms, calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from detectron_tpu_torch.models import model_builder as mb

    real = mb.roi_feature_transform
    label = "chip_smoke.roi_feature_transform"

    def ranged(*args, **kwargs):
        with record_function(label):
            return real(*args, **kwargs)

    mb.roi_feature_transform = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        mb.roi_feature_transform = real
    ranges = [e for e in prof.events()
              if e.name == label and e.device_type == DeviceType.CPU]
    return sum(e.device_time_total for e in ranges) / 1e3, len(ranges)


def check_roi_ops_on_the_card(device):
    """Phase 20: RoIPoolF and RoICrop (plain torch) on the card against
    the CPU on the same float32 inputs, values and gradients: RoIPoolF's
    forward exactly (a max picks an input), its gradient within 1e-6 of
    max|cpu| (index_put_'s accumulation order); RoICrop's within 1e-5 of
    max|cpu| (float32 products in other orders)."""
    import torch

    from detectron_tpu_torch.ops import roi_crop, roi_pool

    rng = np.random.RandomState(7)
    feats = rng.randn(2, 26, 42, 64).astype(np.float32)
    xy = rng.uniform(-30, 600, (2, 64, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 300, (2, 64, 2))],
                          -1).astype(np.float32)
    g = rng.randn(2, 64, 7, 7, 64).astype(np.float32)
    for name, fn in (("RoIPoolF", lambda f, r: roi_pool.roi_pool_batched(
            f, r, 1 / 16, 7)), ("RoICrop", lambda f, r: roi_crop
                                .roi_crop_batched(f, r, 1 / 16, 7, True))):
        res = {}
        for dev in ("cpu", device):
            f = torch.from_numpy(feats).to(dev).requires_grad_()
            out = fn(f, torch.from_numpy(rois).to(dev))
            (out * torch.from_numpy(g).to(dev)).sum().backward()
            res[dev] = (out.detach().cpu(), f.grad.cpu())
        (o_cpu, g_cpu), (o_gpu, g_gpu) = res["cpu"], res[device]
        o_err = float((o_gpu - o_cpu).abs().max() / o_cpu.abs().max())
        g_err = float((g_gpu - g_cpu).abs().max() / g_cpu.abs().max())
        tol = (0.0, 1e-6) if name == "RoIPoolF" else (1e-5, 1e-5)
        print("{} on the card against the CPU (float32, (2, 26, 42, 64), "
              "64 RoIs an image, P=7): output err / max {:.3e}, gradient "
              "err / max {:.3e}".format(name, o_err, g_err))
        if o_err > tol[0] or g_err > tol[1]:
            raise AssertionError("{} on the card disagrees with the CPU"
                                 .format(name))


def check_s2d_stem(device, params, images):
    """The s2d stem (with TPU.S2D_STEM or S2D_INPUT in the cfg) against
    the plain 7x7/s2 stem conv on the same bf16 inputs: within bf16
    rounding (an ulp of each value, 2^-7 |ref|, plus 2^-7 of max|ref| for
    sums that cancel). images: the main inputs as the cfg feeds them."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import layers, resnet

    conv1 = params["body"]["conv1"]
    with torch.no_grad():
        got = resnet.stem_conv(conv1, images).float()
        plain = main_inputs(device, params=False, blocked=False)[1]
        ref = layers.conv2d(conv1, plain, stride=2, padding=3).float()
    err = (got - ref).abs()
    tol = ref.abs() / 128 + float(ref.abs().max()) / 128
    print("{} stem against the plain stem conv (bf16, {}): max_abs_err "
          "{:.4e}, max|ref| {:.4e}, {:.4f}% of outputs differ".format(
              "S2D_INPUT" if cfg.TPU.S2D_INPUT else "S2D_STEM",
              tuple(ref.shape), float(err.max()), float(ref.abs().max()),
              100.0 * float((err > 0).float().mean())))
    if got.shape != ref.shape or bool((err > tol).any()):
        raise AssertionError("the s2d stem disagrees with the plain stem")


def compare_with_ladder(device, label, keys, model, tree, params, out,
                        ladder_ref):
    """An exact FPN RoIAlign route's detections against the default
    ladder's on phase 4's images and calibrated weights, by phase 3's
    criterion (95% matched, counts within 5%), in float32: the gather route
    multiplies and adds in the features' dtype, as the JAX package's does,
    so in bfloat16 its scores move past match_detections' 1e-3 (10% matched
    on an H100) while the windowed slices and the ladder's kernels sum in
    float32. The bfloat16 batch's match (out, params: the route's) is
    printed beside it. ladder_ref keeps the ladder's detections from one
    route to the next. Returns the text to print."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.models import bridge

    def as_float(d):
        return {k: v.float() if v.is_floating_point() else v
                for k, v in d.items()}

    _, images, im_info = main_inputs(device, params=False)
    if "bf16" not in ladder_ref:
        set_cfg(tiny=False, dtype="bfloat16", **model)
        ladder_ref["bf16"] = as_float(det.detect_graph(params, images,
                                                       im_info))
    frac16 = match_detections(as_float(out), ladder_ref["bf16"])
    params32 = bridge.to_torch(tree, device, torch.float32)
    _, images, _ = main_inputs(device, params=False, dtype=torch.float32)
    if "f32" not in ladder_ref:
        set_cfg(tiny=False, dtype="float32", **model)
        ladder_ref["f32"] = det.detect_graph(params32, images, im_info)
    set_cfg(tiny=False, dtype="float32", extra=keys, **model)
    got = det.detect_graph(params32, images, im_info)
    ref = ladder_ref["f32"]
    frac = match_detections(got, ref)
    n_ref, n_got = int(ref["valid"].sum()), int(got["valid"].sum())
    text = (", against the default ladder's detections: float32 valid "
            "ladder={} route={} matched={:.4f}; bf16 matched={:.4f}".format(
                n_ref, n_got, frac, frac16))
    if n_ref == 0 or frac < 0.95 or abs(n_ref - n_got) > 0.05 * n_ref:
        raise AssertionError("variant {}: the detections differ from the "
                             "default ladder's{}".format(label, text))
    return text


def run_variant(device, spec, base, ladder_ref=None):
    """One variant at full width: one inference batch (after a warm-up
    batch) and one training step (bf16 compute, f32 params) on phase 4's
    and phase 5's inputs; for RoIPoolF / RoICrop the transform alone on
    the batch's features and proposals, timed, with its peak memory; for
    the FPN RoIAlign routes (ROI_ROUTES) the device time of the batch's
    RoI transforms in one profiled batch, and for the exact ones
    (EXACT_ROUTES) the detections against the default ladder's
    (compare_with_ladder). Returns the launches of each run."""
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import bridge, train_graph
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    key, label, model, keys, _, required = spec
    set_cfg(tiny=False, dtype="bfloat16", extra=keys, **model)
    tree = calibrate_scores(base, device) if model.get("c4") else base
    params = bridge.to_torch(tree, device, torch.bfloat16)
    _, images, im_info = main_inputs(device, params=False)
    if cfg.TPU.S2D_STEM or cfg.TPU.S2D_INPUT:
        check_s2d_stem(device, params, images)
    det.detect_graph(params, images, im_info)   # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    wrappers = kernel_wrappers(accum=True)
    t0 = time.perf_counter()
    out = det.detect_graph(params, images, im_info)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    infer = {name: fn.launches for name, fn in wrappers.items()}
    check_outputs(out, label)
    per_image = out["valid"].sum(1).tolist()
    method = cfg.FAST_RCNN.ROI_XFORM_METHOD
    extra_info = ""
    if method != "RoIAlign":
        with torch.no_grad():
            feats, scales = mb.forward_features(params, images)
            rois, _, _ = mb.generate_proposals(
                mb.forward_rpn(params, feats), feats, im_info, False)
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pooled = mb.roi_feature_transform(
                feats, scales, rois, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO, method)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
            ms = cuda_ms(lambda: mb.roi_feature_transform(
                feats, scales, rois, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO, method), 3)
        extra_info = (", {} of the box head alone ({} RoIs, P={}, {}): "
                      "{:.3f} ms, peak memory {:.3f} GiB over the inputs "
                      "(output {:.3f} GiB)".format(
                          method, rois.shape[0] * rois.shape[1],
                          pooled.shape[2], "features " + " ".join(
                              str(tuple(f.shape)) for f in feats), ms, peak,
                          pooled.numel() * pooled.element_size() / 2 ** 30))
        del feats, pooled
    if key in ROI_ROUTES:
        roi_ms, calls = roi_transform_device_ms(
            lambda: det.detect_graph(params, images, im_info))
        extra_info = (", RoI transforms' device time in one profiled "
                      "batch {:.4f} ms ({} calls)".format(roi_ms, calls))
    if key in EXACT_ROUTES:
        extra_info += compare_with_ladder(device, label, keys, model, tree,
                                          params, out, ladder_ref)
    print("variant {} inference (bf16, {} x {} x {}): {:.3f} ms for one "
          "batch after a warm-up, valid detections per image {}, launches "
          "{}{}".format(label, BATCH, *CANVAS, dt * 1e3, per_image, infer,
                        extra_info))
    if sum(per_image) == 0:
        raise AssertionError("variant {}: no detections".format(label))
    del params, out

    set_cfg(tiny=False, dtype="bfloat16",
            extra=keys + ["SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)],
            **model)
    params = bridge.to_torch(tree, device, torch.float32)
    p0 = [t.clone() for t in _flat(params)]
    batch = synthetic_train_batch(BATCH, *CANVAS, device,
                                  np.random.RandomState(0))
    draws = train_graph.make_draws(torch.Generator().manual_seed(0), BATCH,
                                   CANVAS, cfg.TPU.MAX_GT_BOXES, device)
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _, stats = ts.train_step(params, opt.init_opt_state(params),
                                     batch, draws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train = {name: fn.launches for name, fn in wrappers.items()}
    stats = {k: round(float(v), 4) for k, v in stats.items()}
    moved = sum(not torch.equal(a, b) for a, b in zip(p0, _flat(params)))
    print("variant {} training step (bf16 compute / f32 params, {} x {} x "
          "{}, the first step): {:.3f} ms, peak memory {:.3f} GiB, {} of {} "
          "param leaves moved, launches {}, stats {}".format(
              label, BATCH, *CANVAS, dt * 1e3,
              torch.cuda.max_memory_allocated() / 2 ** 30, moved, len(p0),
              train, stats))
    if not all(np.isfinite(list(stats.values()))) or "loss_mask" not in \
            stats or moved == 0:
        raise AssertionError("variant {}: a bad training step".format(label))
    # Training runs K4 in the backward wherever K2 pools.
    trained = required + (("roi_window_accum",) if "roi_window_pool" in
                          required else ())
    missing = [k for k in required if infer[k] == 0] + \
        [k for k in trained if train[k] == 0]
    if missing:
        raise AssertionError("variant {}: kernels not launched: {}".format(
            label, missing))
    return infer, train


def run_variant_paths(device):
    """Phase 20: each of VARIANTS at full width (run_variant), after its
    small GPU-against-CPU check (phase 3's check_small_input at the tiny
    sizes, the FC mask head narrowed to 64 channels there); RoIPoolF and
    RoICrop also alone on the card against the CPU. Returns the launches
    of every run, by path name."""
    check_roi_ops_on_the_card(device)
    paths, trees, ladder_ref = {}, {}, {}
    for spec in VARIANTS:
        key, label, model, keys, tree_key, _ = spec
        t0 = time.perf_counter()
        small = keys + (["MRCNN.DIM_REDUCED", "64"] if key == "fc_mask"
                        else [])
        check_small_input(device, small, c4=bool(model.get("c4")))
        if tree_key not in trees:
            trees.clear()
            ladder_ref.clear()
            set_cfg(tiny=False, dtype="bfloat16", extra=keys, **model)
            trees[tree_key] = make_tree()
        paths["variant_{}_infer".format(key)], \
            paths["variant_{}_train".format(key)] = run_variant(
                device, spec, trees[tree_key], ladder_ref)
        print("variant {}: {:.3f} s with its checks".format(
            label, time.perf_counter() - t0))
    return paths


# ---------------------------------------------------------------------------
# Phase 14: deterministic training steps on the card (K4 without atomics)
# ---------------------------------------------------------------------------

def run_det_train_check(device, label="Mask R-CNN R-50-FPN", c4=False):
    """Phase 14: two identical full-width training steps of `label`
    (phase 5's cfg, or with `c4` the mask_rcnn_r50_c4 preset's; phase 5's
    params' seed, batch and one set of sampling draws: loss and gradients,
    no update) under torch.use_deterministic_algorithms give bit-equal
    losses and gradients, through the deterministic K4
    (roi_window_accum_det) only; torch raises for any op of the step that
    has no deterministic implementation on the card. Then the same two
    steps with the switch off, for comparison (the atomic K4). Returns the
    kernels' launch counts under the switch."""
    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    set_cfg(tiny=False, dtype="bfloat16", c4=c4,
            extra=["SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)])
    params = make_params(device, torch.float32)
    batch = synthetic_train_batch(BATCH, *CANVAS, device,
                                  np.random.RandomState(0))
    draws = train_graph.make_draws(torch.Generator().manual_seed(0), BATCH,
                                   CANVAS, cfg.TPU.MAX_GT_BOXES, device)
    wrappers = reset_launches(MAIN_WRAPPERS + ("roi_window_accum",
                                               "roi_window_accum_det"))

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
    reset_launches(wrappers)
    same_loss, differ, n, times = two_steps(True)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    off_loss, off_differ, _, off_times = two_steps(False)
    print("deterministic training ({}, bf16 / f32 params, {} x {} x {}, "
          "loss and gradients twice on the same inputs; "
          "CUBLAS_WORKSPACE_CONFIG {}): under "
          "torch.use_deterministic_algorithms losses equal {}, {} of {} "
          "gradient leaves differ, step ms {}, launches {}; with the switch "
          "off losses equal {}, {} leaves differ, step ms {}".format(
              label, BATCH, *CANVAS,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"), same_loss, differ,
              n, [round(t, 3) for t in times], launches, off_loss,
              off_differ, [round(t, 3) for t in off_times]))
    if not same_loss or differ:
        raise AssertionError("two {} training steps under the deterministic "
                             "switch differ: {} of {} gradient leaves"
                             .format(label, differ, n))
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
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.tools import train_net_step
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.synthetic import calibrate_detector_params

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
    wrappers = reset_launches(MAIN_WRAPPERS + ("roi_window_accum",
                                               "roi_window_accum_det"))

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


# ---------------------------------------------------------------------------
# Phases 21-24: infer_simple, the epoch trainer and VOC, Cityscapes, and the
# native host ops
# ---------------------------------------------------------------------------

MASK_YAML = "configs/baselines/e2e_mask_rcnn_R-50-FPN_1x.yaml"
KPS_YAML = "configs/baselines/e2e_keypoint_rcnn_R-50-FPN_1x.yaml"
FASTER_YAML = "configs/baselines/e2e_faster_rcnn_R-50-FPN_1x.yaml"
DEMO_DIR = "demo"
# Phase 21's --thresh: the tool's default.
VIS_THRESH = 0.7
# Phase 22: the synthetic VOC2007's splits (trainval 16 images: 8 steps an
# epoch at --bs 2, no flips; test 8 images).
VOC_TRAINVAL, VOC_TEST = 16, 8
# Phase 23: the synthetic Cityscapes val set, at Cityscapes' size.
CITYSCAPES_IMAGES = 8
CITYSCAPES_SIZE = (1024, 2048)
CITYSCAPES_VAL = "cityscapes_fine_instanceonly_seg_val"
# Phase 24: the image size of the native ops' masks (an 800 x 1333 image,
# as the engines paste masks into).
NATIVE_HW = (800, 1333)


def kernel_wrappers(accum=False):
    """K1-K3's wrappers (and K4's with accum), their counts set to 0."""
    return reset_launches(MAIN_WRAPPERS + (("roi_window_accum",) if accum
                                           else ()))


def all_kernel_wrappers():
    """K1-K6's wrappers, K4's deterministic variant among them, their
    counts set to 0."""
    return reset_launches()


def require_launches(launches, names, path):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError("kernels not launched on the {} path: {}"
                             .format(path, ", ".join(missing)))


def run_infer_simple_path(device, workdir):
    """Phase 21. Returns K1-K3's launch counts over infer_simple.main for
    Mask R-CNN and for Keypoint R-CNN."""
    import importlib.util

    import cv2
    import torch

    from detectron_tpu_torch.core import test as det
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.tools import infer_simple
    from detectron_tpu_torch.utils import blob as blob_utils
    from detectron_tpu_torch.utils import net as net_utils

    # matplotlib writes the tool's default PDFs; where the host has none,
    # the tool draws with OpenCV and cv2.imwrite, which writes no PDF.
    if importlib.util.find_spec("matplotlib") is None:
        print("phase 21: matplotlib is not installed on this host: the tool "
              "draws with vis_one_image_opencv, written by cv2.imwrite (png)")
        vis = ["--ext", "png"]
    else:
        vis = ["--ext", "pdf"]
    images = sorted(glob.glob(os.path.join(DEMO_DIR, "*.jpg")))
    paths = {}
    for key, keypoints, yaml, dataset, sets in (
            ("infer_simple", False, MASK_YAML, "coco", []),
            # The yaml's 7 x 7 keypoint RoIs give 28 x 28 heatmaps against
            # its HEATMAP_SIZE 56 (ROADMAP Queue C): phase 9's preset's 14.
            ("keypoint_infer_simple", True, KPS_YAML, "keypoints_coco",
             ["KRCNN.ROI_XFORM_RESOLUTION", "14"])):
        set_cfg(tiny=False, dtype="bfloat16", keypoints=keypoints)
        tree = make_tree()
        if keypoints:
            # Phase 9's calibration, on the demo images' blobs: on them the
            # main inputs' calibration leaves no person detection.
            blobs = [blob_utils.get_image_blob(cv2.imread(im))
                     for im in images]
            tree = calibrate_person_class(tree, device, batches=[
                (torch.from_numpy(b.copy()).to(device, torch.bfloat16),
                 torch.from_numpy(info).to(device)) for b, _, info in blobs])
        ckpt = net_utils.save_ckpt(os.path.join(workdir, key), 0, tree)
        del tree
        out_dir = os.path.join(workdir, key + "_vis")
        argv = ["--cfg", yaml, "--dataset", dataset, "--load_ckpt", ckpt,
                "--image_dir", DEMO_DIR, "--output_dir", out_dir,
                "--device", device, "--thresh", str(VIS_THRESH)] + vis + [
                    "--set", "TPU.COMPUTE_DTYPE", "bfloat16"] + sets
        wrappers = kernel_wrappers()
        t0 = time.perf_counter()
        res = infer_simple.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        if [r["image"] for r in res] != images:
            raise AssertionError("infer_simple detected {}, not {}".format(
                [r["image"] for r in res], images))

        # Each image's results against detect_graph and
        # device_outputs_to_image_results on the same blob, bit for bit;
        # a non-empty file per image, something above --thresh.
        params = test_engine.initialize_model_from_cfg(
            infer_simple.parse_args(argv), device=device)
        C = cfg.MODEL.NUM_CLASSES
        per_image = []
        for r in res:
            out = det.detect_graph(
                params, torch.from_numpy(r["blob"]).to(device,
                                                       mb.compute_dtype()),
                torch.from_numpy(r["im_info"]).to(device))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            hw = cv2.imread(r["image"]).shape[:2]
            ref = test_engine.device_outputs_to_image_results(
                out, 0, r["im_info"], C, hw)
            for j in range(1, C):
                if not np.array_equal(r["cls_boxes"][j], ref[0][j]):
                    raise AssertionError("{} class {}: infer_simple's boxes "
                                         "differ".format(r["image"], j))
                if keypoints:
                    same = len(r["cls_keyps"][j]) == len(ref[2][j]) and all(
                        np.array_equal(a, b)
                        for a, b in zip(r["cls_keyps"][j], ref[2][j]))
                else:
                    same = r["cls_segms"][j] == ref[1][j]
                if not same:
                    raise AssertionError("{} class {}: infer_simple's {} "
                                         "differ".format(r["image"], j,
                                                         "keypoints" if
                                                         keypoints else
                                                         "RLEs"))
            n = sum(len(b) for b in r["cls_boxes"][1:])
            if n == 0 or r["output"] is None or \
                    os.path.getsize(r["output"]) == 0:
                raise AssertionError("{}: {} detections, file {}: nothing "
                                     "drawn".format(r["image"], n,
                                                    r["output"]))
            per_image.append((os.path.basename(r["image"]), n,
                              max(float(b[:, 4].max()) for b in
                                  r["cls_boxes"][1:] if len(b)),
                              os.path.getsize(r["output"]),
                              round(r["seconds"], 3)))
        secs = [r["seconds"] for r in res]
        print("{} path (infer_simple.main, {}, bf16, TEST.SCALE {} / "
              "MAX_SIZE {}, {} images of demo/): {:.3f} s in all (model "
              "load included), seconds per image {} (median {:.3f}, first "
              "one's cuDNN plans included); per image (name, detections, "
              "top score, bytes written, s) {}; equal to detect_graph + "
              "device_outputs_to_image_results on the same blobs; K1-K3 "
              "launches per image {}".format(
                  key, "Keypoint R-CNN R-50-FPN" if keypoints else
                  "Mask R-CNN R-50-FPN", cfg.TEST.SCALE, cfg.TEST.MAX_SIZE,
                  len(res), wall, [round(s, 3) for s in secs],
                  statistics.median(secs), per_image,
                  {k: v / len(res) for k, v in launches.items()}))
        require_launches(launches, ("nms_keep_mask", "roi_window_pool"), key)
        paths[key] = launches
        del params
    return paths


def _voc_detections_as_written(all_boxes):
    """all_boxes rounded as the devkit's comp4 files write them (1-based
    coordinates to 0.1 px, scores to 1e-6), back in 0-based coordinates:
    the devkit-XML and json routes then score the same numbers."""
    out = []
    for cls in all_boxes:
        out.append([np.array(
            [[float("{:.1f}".format(v + 1)) - 1 for v in row[:4]]
             + [float("{:.6f}".format(row[4]))] for row in b],
            np.float64).reshape(-1, 5) for b in cls])
    return out


def _gt_as_detections(dataset):
    """The dataset's non-crowd ground truth as [cls][img] (N, 5) boxes of
    score 1 (Detectron's +1 convention) and, where it has polygons, the
    [cls][img] RLEs."""
    from detectron_tpu_torch.data import rle

    ids = sorted(dataset.COCO.getImgIds())
    boxes = [[np.zeros((0, 5), np.float32) for _ in ids]
             for _ in dataset.classes]
    segms = [[[] for _ in ids] for _ in dataset.classes]
    for i, img_id in enumerate(ids):
        info = dataset.COCO.imgs[img_id]
        for a in dataset.COCO.img_to_anns.get(img_id, []):
            if a.get("iscrowd", 0):
                continue
            j = dataset.json_category_id_to_contiguous_id[a["category_id"]]
            x, y, w, h = a["bbox"]
            boxes[j][i] = np.vstack([boxes[j][i], np.array(
                [[x, y, x + w - 1, y + h - 1, 1.0]], np.float32)])
            if "segmentation" in a:
                segms[j][i].append(rle.merge(rle.frPyObjects(
                    a["segmentation"], info["height"], info["width"])))
    return boxes, segms


def run_voc_path(device, workdir):
    """Phase 22. Returns K1-K4's launch counts over the epoch trainer (and
    its --resume) and K1-K3's over test_net."""
    import logging
    import shutil

    import torch

    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.data import dataset_catalog
    from detectron_tpu_torch.data import voc_dataset_evaluator as voc
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.tools import test_net, train_net
    from detectron_tpu_torch.tools.make_synthetic_valset import make_vocset
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh

    # The per-class AP lines (20 classes, four evaluations) stay out of
    # stdout; the phase prints the mAPs.
    logging.getLogger("detectron_tpu_torch.data.voc_dataset_evaluator"
                      ).setLevel(logging.WARNING)
    t0 = time.perf_counter()
    n_ann = make_vocset(workdir, VOC_TRAINVAL, VOC_TEST)
    set_cfg(tiny=False, dtype="bfloat16", yaml=FASTER_YAML,
            extra=["MODEL.NUM_CLASSES", "21"])
    pkl = os.path.join(workdir, "voc_init.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(make_tree())}, f,
                    pickle.HIGHEST_PROTOCOL)
    print("VOC set-up: VOC2007 of {} trainval and {} test images ({} "
          "annotations, 20 classes, devkit tree), calibrated Faster R-CNN "
          "weights as a Detectron .pkl, in {:.3f} s".format(
              VOC_TRAINVAL, VOC_TEST, n_ann, time.perf_counter() - t0))

    lr = 0.0025   # the yaml's 0.02 for 16 images a step, scaled to 2
    common = ["--dataset", "voc2007", "--cfg", FASTER_YAML, "--bs",
              str(BATCH), "--nw", "4", "--epochs", "2", "--lr_decay_epochs",
              "1", "--lr", str(lr), "--disp_interval", "4", "--device",
              device]
    sets = ["DATA_DIR", workdir, "TPU.COMPUTE_DTYPE", "bfloat16",
            "TRAIN.USE_FLIPPED", "False",
            "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)]
    paths = {}
    runs = {}
    for key, flags, out in (
            ("voc_train_net", ["--load_detectron", pkl], "train"),
            ("voc_train_net_resume", None, "resume")):
        if flags is None:
            flags = ["--load_ckpt", runs["voc_train_net"]["ckpts"][0],
                     "--resume"]
        wrappers = kernel_wrappers(accum=True)
        t0 = time.perf_counter()
        run = train_net.main(common + flags + [
            "--set", "OUTPUT_DIR", os.path.join(workdir, out)] + sets)
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0
        paths[key] = {name: fn.launches for name, fn in wrappers.items()}
        runs[key] = run
    run, resumed = runs["voc_train_net"], runs["voc_train_net_resume"]
    spe = run["steps_per_epoch"]
    names = [os.path.basename(c) for c in run["ckpts"]]
    if spe != VOC_TRAINVAL // BATCH or names != ["model_epoch1",
                                                 "model_epoch2"]:
        raise AssertionError("epoch trainer: {} steps an epoch, checkpoints "
                             "{}".format(spe, names))
    lrs = [s["lr"] for s in run["stats"]]
    want = [lr] * spe + [lr * cfg.SOLVER.GAMMA] * spe
    if len(lrs) != 2 * spe or not np.allclose(lrs, want, rtol=1e-6,
                                              atol=0):
        raise AssertionError("epoch trainer lr per step {}, expected "
                             "{}".format(lrs, want))
    bad = [s for s in run["stats"] + resumed["stats"]
           if not all(np.isfinite(list(s.values())))]
    if bad:
        raise AssertionError("non-finite training stats: {}".format(bad))
    if resumed["start_epoch"] != 1 or len(resumed["stats"]) != spe or \
            os.path.basename(resumed["ckpts"][-1]) != "model_epoch2":
        raise AssertionError("--resume from model_epoch1 ran from epoch {} "
                             "for {} steps".format(resumed["start_epoch"],
                                                   len(resumed["stats"])))
    step_ms = [t * 1e3 for t in run["step_s"][1:]]
    print("voc epoch trainer (train_net.main --dataset voc2007, Faster "
          "R-CNN R-50-FPN yaml, bf16 compute / f32 params, --bs {} "
          "--epochs 2 --lr_decay_epochs 1 --lr {}, TRAIN.SCALES {} / "
          "MAX_SIZE {}, no flips): {} steps an epoch, {:.3f} s in all; "
          "median step {:.3f} ms after the first ({:.3f} img/s), first "
          "{:.3f} ms; lr epoch 1 {}, epoch 2 {} (BASE_LR x GAMMA); "
          "checkpoints {}; --resume from model_epoch1: epoch 2 only ({} "
          "steps, median {:.3f} ms); launches {}, resume {}".format(
              BATCH, lr, cfg.TRAIN.SCALES, cfg.TRAIN.MAX_SIZE, spe,
              run["wall"], statistics.median(step_ms),
              BATCH / statistics.median(step_ms) * 1e3,
              run["step_s"][0] * 1e3, lrs[0], lrs[-1], names,
              len(resumed["stats"]),
              statistics.median(resumed["step_s"]) * 1e3,
              paths["voc_train_net"], paths["voc_train_net_resume"]))
    for key in ("voc_train_net", "voc_train_net_resume"):
        require_launches(paths[key], ("nms_keep_mask", "roi_window_pool",
                                      "roi_window_accum"), key)

    # test_net from model_epoch2: the devkit-XML protocol through
    # task_evaluation.
    wrappers = kernel_wrappers()
    out_dir = os.path.join(workdir, "voc_eval")
    t0 = time.perf_counter()
    results = test_net.main([
        "--dataset", "voc2007", "--cfg", FASTER_YAML, "--load_ckpt",
        run["ckpts"][1], "--output_dir", out_dir, "--batch_size",
        str(ENGINE_BATCH), "--device", device, "--set", "DATA_DIR", workdir,
        "TPU.COMPUTE_DTYPE", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["voc_test_net"] = {name: fn.launches
                             for name, fn in wrappers.items()}
    with open(os.path.join(out_dir, "detections.pkl"), "rb") as f:
        dets = pickle.load(f)
    dataset = JsonDataset("voc_2007_test")
    n_dets = sum(len(b) for cls in dets["all_boxes"][1:] for b in cls)
    box = results["voc_2007_test"]["box"]
    if list(box) != ["AP", "AP50"] or not np.isfinite(box["AP"]):
        raise AssertionError("task_evaluation's VOC results: {}".format(box))

    # The two protocols on the same (rounded) detections: the engine's, the
    # ground truth fed back (mAP 1), and the ground truth jittered by N(0,
    # 6 px) with random scores and a false positive an image (an mAP
    # inside (0, 1) whatever the engine's random weights detect).
    gt, _ = _gt_as_detections(dataset)
    rng = np.random.RandomState(0)
    jittered = [[np.vstack([
        np.hstack([b[:, :4] + rng.randn(len(b), 4) * 6, rng.rand(len(b), 1)]),
        np.hstack([rng.uniform(0, 300, (1, 2)), rng.uniform(320, 400, (1, 2)),
                   rng.rand(1, 1)])]) for b in cls] for cls in gt]
    sets = {"engine": _voc_detections_as_written(dets["all_boxes"]),
            "ground truth": gt,
            "jittered": _voc_detections_as_written(jittered)}
    t0 = time.perf_counter()
    xml = {k: voc.evaluate_boxes(dataset, v, out_dir + "/xml")
           for k, v in sets.items()}
    eval_s = time.perf_counter() - t0
    devkit = dataset_catalog.DATASETS["voc_2007_test"][
        dataset_catalog.DEVKIT_DIR].resolve()
    shutil.move(devkit, devkit + ".away")
    try:
        js = {k: voc.evaluate_boxes(dataset, v, out_dir + "/json")
              for k, v in sets.items()}
    finally:
        shutil.move(devkit + ".away", devkit)
    for k in sets:
        if xml[k].get("protocol") != "devkit_xml" or "protocol" in js[k]:
            raise AssertionError("VOC protocols: {} / {}".format(
                xml[k].get("protocol"), js[k].get("protocol")))
        if xml[k]["map"] != js[k]["map"] or xml[k]["aps"] != js[k]["aps"]:
            raise AssertionError("{}: devkit-XML mAP {} != json mAP {}"
                                 .format(k, xml[k]["map"], js[k]["map"]))
    if abs(xml["ground truth"]["map"] - 1.0) > 1e-12:
        raise AssertionError("the ground truth as detections scores mAP {}"
                             ", not 1".format(xml["ground truth"]["map"]))
    if not 0 < xml["jittered"]["map"] < 1:
        raise AssertionError("the jittered ground truth scores mAP {}"
                             .format(xml["jittered"]["map"]))
    print("voc test_net path (test_net.main --dataset voc2007 from "
          "model_epoch2, batch {}): {} images, {} detections in {:.3f} s "
          "({:.3f} img/s, model load and evaluation included); "
          "task_evaluation box AP {} (devkit XML, 11-point; random-init "
          "training); devkit-XML mAP == json mAP on the detections as the "
          "comp4 files round them: engine {}, ground truth fed back {}, "
          "jittered ground truth {}; the three devkit-XML evaluations "
          "{:.3f} s; launches {}".format(
              ENGINE_BATCH, VOC_TEST, n_dets, wall, VOC_TEST / wall,
              box["AP"], xml["engine"]["map"], xml["ground truth"]["map"],
              xml["jittered"]["map"], eval_s, paths["voc_test_net"]))
    require_launches(paths["voc_test_net"], ("nms_keep_mask",
                                             "roi_window_pool"),
                     "voc_test_net")
    return paths


def run_cityscapes_path(device, workdir):
    """Phase 23. Returns K1-K3's launch counts over test_net."""
    import torch

    from detectron_tpu_torch.data import cityscapes_json_dataset_evaluator \
        as cs
    from detectron_tpu_torch.data.json_dataset import JsonDataset
    from detectron_tpu_torch.tools import test_net
    from detectron_tpu_torch.tools.make_synthetic_valset import \
        make_cityscapes_set
    from detectron_tpu_torch.utils import net as net_utils

    t0 = time.perf_counter()
    n_ann = make_cityscapes_set(workdir, CITYSCAPES_IMAGES,
                                size=CITYSCAPES_SIZE)
    set_cfg(tiny=False, dtype="bfloat16", yaml=MASK_YAML,
            extra=["MODEL.NUM_CLASSES", "9"])
    ckpt = net_utils.save_ckpt(os.path.join(workdir, "cs"), 0, make_tree())
    print("Cityscapes set-up: {} images of {} x {}, {} annotations (8 "
          "classes, crowd regions, instances under {} px), calibrated 9-class "
          "Mask R-CNN checkpoint, in {:.3f} s".format(
              CITYSCAPES_IMAGES, *CITYSCAPES_SIZE, n_ann, cs.MIN_REGION_SIZE,
              time.perf_counter() - t0))
    wrappers = kernel_wrappers()
    out_dir = os.path.join(workdir, "cs_eval")
    t0 = time.perf_counter()
    results = test_net.main([
        "--dataset", CITYSCAPES_VAL, "--cfg", MASK_YAML, "--load_ckpt",
        ckpt, "--output_dir", out_dir, "--batch_size", str(ENGINE_BATCH),
        "--device", device, "--set", "DATA_DIR", workdir,
        "MODEL.NUM_CLASSES", "9", "TPU.COMPUTE_DTYPE", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    res = results[CITYSCAPES_VAL]
    if list(res) != ["box", "mask"] or not all(
            np.isfinite(res[t]["AP"]) for t in res):
        raise AssertionError("Cityscapes results: {}".format(res))
    with open(os.path.join(out_dir, "detections.pkl"), "rb") as f:
        dets = pickle.load(f)
    dataset = JsonDataset(CITYSCAPES_VAL)
    roidb = dataset.get_roidb(gt=True)
    n_dets = _check_engine_results(dets, roidb, 9)
    t0 = time.perf_counter()
    official = cs.evaluate_masks_official(dataset, dets["all_boxes"],
                                          dets["all_segms"])
    official_s = time.perf_counter() - t0
    gt_boxes, gt_segms = _gt_as_detections(dataset)
    perfect = cs.evaluate_masks_official(dataset, gt_boxes, gt_segms)
    if perfect["ap_official"] != 1.0 or perfect["ap50_official"] != 1.0:
        raise AssertionError("the ground truth fed back scores {} in the "
                             "official protocol, not 1".format(perfect))
    print("cityscapes test_net path (test_net.main on {}, Mask R-CNN "
          "R-50-FPN yaml, MODEL.NUM_CLASSES 9, bf16, batch {}): {} images "
          "of {} x {}, {} detections in {:.3f} s ({:.3f} img/s, model load "
          "and evaluation included); COCO protocol box AP {}, mask AP {} "
          "(random weights); official instance-level protocol on the "
          "engine's detections AP {} / AP50 {} in {:.3f} s; the ground "
          "truth fed back scores {} / {}; launches {}".format(
              CITYSCAPES_VAL, ENGINE_BATCH, CITYSCAPES_IMAGES,
              *CITYSCAPES_SIZE, n_dets, wall, CITYSCAPES_IMAGES / wall,
              res["box"]["AP"], res["mask"]["AP"], official["ap_official"],
              official["ap50_official"], official_s,
              perfect["ap_official"], perfect["ap50_official"], launches))
    if n_dets == 0:
        raise AssertionError("the Cityscapes engine produced no detections")
    require_launches(launches, ("nms_keep_mask", "roi_window_pool"),
                     "cityscapes_test_net")
    return launches


def _best_ms(fn, reps=3):
    """The least wall ms of reps calls of fn (host code), and its result."""
    best, out = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        best = ms if best is None else min(best, ms)
    return best, out


def run_native_ops_check():
    """Phase 24: the native host ops built with g++ on this host, each
    against its numpy twin at engine sizes, bit for bit, with both times
    (the least of 3 runs)."""
    from detectron_tpu_torch import native
    from detectron_tpu_torch.data import rle
    from detectron_tpu_torch.utils import boxes as box_utils

    # A fresh build of the source, timed (the package's own library was
    # built at the first native call of an earlier phase).
    with tempfile.TemporaryDirectory() as build_dir:
        t0 = time.perf_counter()
        built = native.build(build_dir=build_dir)
        print("native host ops: g++ built {} in {:.3f} s; the package "
              "loads {}".format(os.path.basename(str(built)),
                                time.perf_counter() - t0,
                                os.path.basename(native.lib()._name)))
    rng = np.random.RandomState(0)
    h, w = NATIVE_HW

    def check(name, native_fn, plain_fn, size, plain_reps=3):
        ms, got = _best_ms(native_fn)
        plain_ms, ref = _best_ms(plain_fn, plain_reps)
        same = all(np.array_equal(a, b) for a, b in zip(got, ref)) and \
            len(got) == len(ref)
        if not same:
            raise AssertionError("native {} differs from its numpy twin"
                                 .format(name))
        print("native {} ({}): {:.3f} ms, numpy twin {:.3f} ms ({:.1f}x), "
              "bit for bit".format(name, size, ms, plain_ms, plain_ms / ms))

    # NMS: 80 classes of up to 1000 detections (the host path's shapes).
    dets = []
    for c in range(80):
        n = int(rng.randint(100, 1001))
        xy = rng.uniform(0, [w - 60, h - 60], (n, 2))
        wh = rng.uniform(8, 300, (n, 2))
        dets.append(np.hstack([xy, xy + wh, rng.rand(n, 1)]).astype(
            np.float32))
    check("nms", lambda: [native.nms(d, 0.5) for d in dets],
          lambda: [box_utils.nms_plain(d, 0.5) for d in dets],
          "80 classes, {} detections, IoU 0.5".format(
              sum(len(d) for d in dets)))
    # RLE encode / decode of 100 masks at 800 x 1333.
    masks = []
    for _ in range(100):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h - 300), rng.randint(0, w - 300)
        m[y0:y0 + rng.randint(20, 300), x0:x0 + rng.randint(20, 300)] = 1
        masks.append(m)
    counts = [rle.encode_counts_plain(m) for m in masks]
    check("rle_encode", lambda: [native.rle_encode(m) for m in masks],
          lambda: [rle.encode_counts_plain(m) for m in masks],
          "100 masks of {} x {}".format(h, w))
    check("rle_decode", lambda: [native.rle_decode(c, h, w) for c in counts],
          lambda: [rle.decode_counts_plain(c, h, w) for c in counts],
          "100 masks of {} x {}".format(h, w))
    # Polygons: 200 seeded star-shaped polygons of 5-12 vertices.
    polys = []
    for _ in range(200):
        k = rng.randint(5, 13)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(10, 200, k)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        polys.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                              1).reshape(-1).tolist())
    check("poly_to_counts",
          lambda: [native.poly_to_counts(p, h, w) for p in polys],
          lambda: [rle.poly_to_counts_plain(p, h, w) for p in polys],
          "200 polygons on {} x {}".format(h, w))
    # Mask IoU of 100 detections against 50 ground truths.
    rles = [rle.encode(m) for m in masks]
    gts = rles[:50]
    crowd = [i % 7 == 0 for i in range(50)]
    check("rle_intersection / iou", lambda: [rle.iou(rles, gts, crowd)],
          lambda: [rle.iou_plain(rles, gts, crowd)],
          "100 x 50 RLEs of {} x {}, crowd every 7th".format(h, w),
          plain_reps=1)


def run_new_phases(device, paths):
    """Phases 21-24, each timed; their launch counts go into paths."""
    for phase, run in ((21, run_infer_simple_path), (22, run_voc_path),
                       (23, run_cityscapes_path)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            got = run(device, workdir)
        paths.update(got if phase != 23 else {"cityscapes_test_net": got})
        print("phase {}: {:.3f} s".format(phase, time.perf_counter() - t0))
    t0 = time.perf_counter()
    run_native_ops_check()
    print("phase 24: {:.3f} s".format(time.perf_counter() - t0))


# ---------------------------------------------------------------------------
# Phase 30: the measuring tools at full width (detectron_tpu_torch/tools)
# ---------------------------------------------------------------------------

# The trace's device self time a step against profile_call's busy time for
# one call of the same step, relative (two profiler sessions).
TRACE_BUSY_REL = 0.10
# The trace's device self time against its own profiler session's device
# total (key_averages()), relative: the same events summed two ways.
TRACE_SESSION_REL = 0.005
# Kernels listed by how far their per-step device time in profile_net's
# session lies from profile_call's.
GAP_KERNELS = 8
# Where the profiled kernels must be attributed (trace_summary's stage:
# the deepest package frame outside the kernel wrappers).
# The kernels each tool's run must launch (K1, K2, K4's wrappers).
TOOL_KERNELS = {
    "profile_net_infer": ("nms_keep_mask", "roi_window_pool"),
    "profile_net_train": ("nms_keep_mask", "roi_window_pool",
                          "roi_window_accum"),
    "stage_bench": ("nms_keep_mask", "roi_window_pool"),
    "roi_bench_p7": ("roi_window_pool",),
    "roi_bench_p14": ("roi_window_pool",),
    "golden_compare": ("nms_keep_mask", "roi_window_pool"),
    "golden_compare_pkl": ("nms_keep_mask", "roi_window_pool")}
KERNEL_STAGES = {"nms_iou_mask_kernel": {"ops/nms.py"},
                 "nms_scan": {"ops/nms.py"},
                 "roi_window_pool_kernel": {"ops/windowed_roi.py"}}


def _tool_run(paths, key, fn):
    """fn() with the counts of all seven wrappers (K1-K6, K4's
    deterministic variant) zeroed before and read into paths[key] after;
    returns fn's result."""
    wrappers = all_kernel_wrappers()
    t0 = time.perf_counter()
    got = fn()
    paths[key] = {name: w.launches for name, w in wrappers.items()}
    print("{}: {:.3f} s, launches {}".format(key, time.perf_counter() - t0,
                                             paths[key]))
    return got


def _print_session_gap(sess_by, steps, call_by):
    """The kernels behind the gap between profile_net's session (stacks,
    shapes, FLOPs on; `steps` steps) and profile_call's (one step): per
    kernel, calls and device ms a step in each, by |difference|."""
    rows = []
    for k in set(sess_by) | set(call_by):
        n_s, ms_s = sess_by.get(k, (0, 0.0))
        n_c, ms_c = call_by.get(k, (0, 0.0))
        rows.append((ms_s / steps - ms_c, n_s / steps, ms_s / steps, n_c,
                     ms_c, k))
    rows.sort(key=lambda r: -abs(r[0]))
    gap = sum(r[0] for r in rows)
    same = sum(r[0] for r in rows if r[1] == r[3])
    print("session gap: {:.3f} ms a step, {:.3f} of it in kernels with the "
          "same calls in both sessions; the {} largest:".format(
              gap, same, GAP_KERNELS))
    for d, n_s, ms_s, n_c, ms_c, k in rows[:GAP_KERNELS]:
        print("  {:+8.3f} ms  profile_net {:7.1f} calls {:8.3f} ms  "
              "profile_call {:5d} calls {:8.3f} ms  {}".format(
                  d, n_s, ms_s, n_c, ms_c, k[:70]))


def _check_kernel_stages(summary, label):
    """Every K1-K3 kernel of the trace is attributed to its stage."""
    seen = {}
    for name, stages in summary["kernel_stages"].items():
        for k in KERNEL_STAGES:
            if k in name:
                got = seen.setdefault(k, {})
                for st, n in stages.items():
                    got[st] = got.get(st, 0) + n
    print("{}: the port's kernels by stage: {}".format(label, seen))
    for k, want in KERNEL_STAGES.items():
        if k not in seen or set(seen[k]) - want:
            raise AssertionError("{}: {} attributed to {}, expected {}"
                                 .format(label, k, seen.get(k), want))


def run_measuring_tools(device, workdir, paths):
    """Phase 30, less multiscale_bench (which runs in the X-152 block,
    run_multiscale_bench): profile_net (2 inference steps, 1 training
    step; R-50-FPN, batch 2, bf16, calibrated) with trace_summary on both
    traces, stage_bench at batch 2, roi_bench at P = 7 / 1000 RoIs and P =
    14 / 100 RoIs, and golden_compare (a dump of the calibrated tree, a
    dump through --pkl of it, their --diff). Each tool's K1-K6 launches go
    into paths."""
    import torch

    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.tools import (golden_compare, profile_net,
                                           roi_bench, stage_bench,
                                           trace_summary)
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import image_io

    # profile_net + trace_summary: inference, then one training step.
    set_cfg(tiny=False, dtype="bfloat16")
    got = _tool_run(paths, "profile_net_infer", lambda: profile_net.main([
        "--batch_size", str(BATCH), "--steps", "2", "--calibrate",
        "--out", workdir + "/infer"]))
    summary = trace_summary.main([got["trace"], "--steps", "2", "--top",
                                  "25"])
    rel = abs(summary["total"] - got["device_ms"]) / got["device_ms"]
    print("trace_summary device self time {:.3f} ms, its profiler "
          "session's key_averages {:.3f} ms: {:.5f} apart (limit {})".format(
              summary["total"], got["device_ms"], rel, TRACE_SESSION_REL))
    if not rel <= TRACE_SESSION_REL:
        raise AssertionError("trace_summary's device total is {:.5f} away "
                             "from its session's own".format(rel))
    trace_ms = summary["total"] / 2
    # A profile can miss some of a call's kernels (device_kernels): the
    # median of three profile_call runs of the step.
    runs = []
    for _ in range(3):
        by_name = {}
        runs.append((profile_call("one profile_net inference step",
                                  got["step"], n_kernels=0, n_ops=0,
                                  by_name=by_name)[1], by_name))
    busy, call_by = sorted(runs, key=lambda r: r[0])[1]
    rel = abs(trace_ms - busy) / busy
    print("trace_summary device self time {:.3f} ms a step, profile_call "
          "busy {:.3f} ms (median of 3): {:.4f} apart (limit {})".format(
              trace_ms, busy, rel, TRACE_BUSY_REL))
    _print_session_gap(got["device_by_name"], 2, call_by)
    if not rel <= TRACE_BUSY_REL:
        raise AssertionError("trace_summary's device total is {:.4f} away "
                             "from profile_call's busy time".format(rel))
    _check_kernel_stages(summary, "profile_net inference")

    set_cfg(tiny=False, dtype="bfloat16")
    got = _tool_run(paths, "profile_net_train", lambda: profile_net.main([
        "--mode", "train", "--batch_size", str(BATCH), "--steps", "1",
        "--calibrate", "--out", workdir + "/train", "--set",
        "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)]))
    summary = trace_summary.main([got["trace"], "--steps", "1", "--top",
                                  "25"])
    k4 = {n: dict(st) for n, st in summary["kernel_stages"].items()
          if "roi_window_accum_kernel" in n}
    print("profile_net training: K4 by stage: {}".format(k4))
    if not k4:
        raise AssertionError("no K4 kernel in the training trace")

    set_cfg(tiny=False, dtype="bfloat16")
    _tool_run(paths, "stage_bench", lambda: stage_bench.main([
        "--batch_size", str(BATCH), "--iters", "2", "--calibrate"]))

    for P, R in ((7, 1000), (14, 100)):
        set_cfg(tiny=False, dtype="bfloat16")
        res = _tool_run(paths, "roi_bench_p{}".format(P),
                        lambda: roi_bench.main([
                            "--batch", str(BATCH), "--rois", str(R),
                            "--pooled", str(P), "--iters", "2"]))
        ref = res["gather (exact, plain)"]["out"]
        for name in ("ladder (K2 + K3 rungs + gather)",
                     "level sweep (K2 a level)"):
            ok, d = bf16_within(res[name]["out"], ref)
            if not ok:
                raise AssertionError("roi_bench P={}: {} is not within "
                                     "bf16_close's limit of the gather "
                                     "(max abs difference {:.3e})".format(
                                         P, name, float(d.max())))
        del res

    # golden_compare: the calibrated tree dumped in process and through a
    # Detectron .pkl of it, on one 800 x 1333 noise image, then --diff.
    set_cfg(tiny=False, dtype="bfloat16", yaml=MASK_YAML)
    tree = make_tree()
    im = (np.random.RandomState(7).rand(800, 1333, 3) * 255).astype(np.uint8)
    image_io.write_ppm(workdir + "/golden.ppm", im)
    pkl = workdir + "/golden.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f,
                    pickle.HIGHEST_PROTOCOL)
    a = _tool_run(paths, "golden_compare", lambda: golden_compare.dump_stages(
        bridge.to_torch(tree, device, torch.bfloat16),
        image_io.imread(workdir + "/golden.ppm")))
    np.savez(workdir + "/a.npz", **a)
    _tool_run(paths, "golden_compare_pkl", lambda: golden_compare.main([
        "--cfg", MASK_YAML, "--set", "TPU.COMPUTE_DTYPE", "bfloat16",
        "--pkl", pkl, "--image", workdir + "/golden.ppm", "--out",
        workdir + "/b.npz"]))
    rc = golden_compare.main(["--diff", workdir + "/a.npz",
                              workdir + "/b.npz"])
    print("golden_compare --diff of the two dumps: exit {}".format(rc))
    if rc != 0:
        raise AssertionError("golden_compare --diff of the in-process and "
                             "the --pkl dump exits {}".format(rc))
    for key, names in TOOL_KERNELS.items():
        require_launches(paths[key], names, key)


def run_multiscale_bench(device, base, paths):
    """Phase 30's multiscale_bench: the X-152 yaml's training step at
    TRAIN.SCALES 640 and 800 (2 steps each after the first), from the
    X-152 block's base tree."""
    from detectron_tpu_torch.tools import multiscale_bench

    rows = _tool_run(paths, "multiscale_bench", lambda: multiscale_bench.main(
        ["--scales", "640", "800", "--iters", "2", "--set",
         "SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)], params=base))
    bad = [r for r in rows[:-1] if not np.isfinite(r["loss0"])]
    if bad:
        raise AssertionError("multiscale_bench: non-finite loss {}".format(
            bad))
    require_launches(paths["multiscale_bench"],
                     ("nms_keep_mask", "roi_window_pool",
                      "roi_window_accum"), "multiscale_bench")


# ---------------------------------------------------------------------------
# Phases 25-28: parallelism (one process per device; on one card the ranks
# share cuda:0 over gloo, which reduces CUDA tensors through the host)
# ---------------------------------------------------------------------------

# Phase 25's one-step comparison: losses within PAR_LOSS_RTOL of the
# one-process step's, params within PAR_PARAM_REL of each leaf's largest
# value (float32, TF32 off, convolutions without cuDNN in both, so that an
# image's forward does not depend on the batch it is in; what is left is
# the order of float sums: the box head's matmul over 1 or 2 images of
# RoIs, the gradients' sum over the ranks, K4's atomics).
PAR_LOSS_RTOL = 1e-4
PAR_PARAM_REL = 1e-4
# Phase 25 and 26's world: 2 ranks, one image each.
PAR_RANKS = 2
PAR_STEPS = 2
PAR_TIMEOUT_S = 600
# The card the ranks of phases 25-28 share, and the sizes phase 26 trains
# at (phase 8's).
PAR_DEVICE = "cuda:0"
PAR_TRAIN_KEYS = ["TRAIN.SCALES", "(800,)", "TRAIN.MAX_SIZE", "1333"]
PAR_TEST_KEYS = []


def _par_spec(dtype, cudnn, steps):
    """run_rank's spec for phase 25's full-width step: the training main
    path's cfg (phase 5's, compute dtype `dtype`), its calibrated weights,
    its synthetic 2-image batch and one set of global draws."""
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.parallel import dryrun
    from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

    set_cfg(tiny=False, dtype=dtype,
            extra=["SOLVER.CLIP_GRADIENTS", str(CLIP_GRADIENTS)])
    batch = {k: v.numpy() for k, v in synthetic_train_batch(
        BATCH, *CANVAS, "cpu", np.random.RandomState(0)).items()}
    assert cfg.TRAIN.IMS_PER_BATCH == BATCH
    return {"cfg": dryrun.cfg_snapshot(), "tree": make_tree(),
            "batch": batch, "draws": dryrun.global_draws(0, batch),
            "mesh": (PAR_RANKS, 1), "steps": steps, "cudnn": cudnn}


def _one_process_step(spec, steps=1):
    """The spec's step in this process on both images: (stats of each
    step, params after the first in the JAX layout, host ms of the steps
    after the first)."""
    import torch

    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.parallel import dryrun
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts

    dryrun.set_cfg(spec["cfg"])
    torch.backends.cudnn.enabled = spec["cudnn"]
    try:
        params = bridge.to_torch(spec["tree"], PAR_DEVICE, torch.float32)
        opt_state = opt.init_opt_state(params)
        batch = {k: torch.as_tensor(v).to(PAR_DEVICE) for k, v in
                 spec["batch"].items()}
        draws = {k: torch.as_tensor(v).to(PAR_DEVICE) for k, v in
                 spec["draws"].items()}
        stats, first, ms = [], None, []
        for i in range(steps):
            _sync()
            t0 = time.perf_counter()
            params, opt_state, st = ts.train_step(params, opt_state, batch,
                                                  draws)
            stats.append({k: float(v) for k, v in st.items()})
            _sync()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
            else:
                first = bridge.to_jax_layout(params)
        return stats, first, ms
    finally:
        torch.backends.cudnn.enabled = True


def _sync():
    import torch

    if PAR_DEVICE.startswith("cuda"):
        torch.cuda.synchronize()


def _compare_steps(label, got_stats, got_params, ref_stats, ref_params):
    """Losses and params of a mesh step against the one-process step's."""
    from detectron_tpu_torch.parallel import optimizer as opt

    worst_loss = max(abs(got_stats[k] - v) / max(abs(v), 1e-12)
                     for k, v in ref_stats.items() if k != "lr")
    ref = dict(opt.flatten(ref_params))
    got = dict(opt.flatten(got_params))
    if set(ref) != set(got):
        raise AssertionError(label + ": the gathered params have other "
                             "leaves than the model's")
    worst, at = 0.0, None
    for path, r in ref.items():
        rel = float(np.abs(got[path] - r).max()) / max(
            float(np.abs(r).max()), 1e-12)
        if rel > worst:
            worst, at = rel, path
    print("{}: losses within {:.3g} relative of the one-process step's "
          "(bound {}), params within {:.3g} of each leaf's largest value "
          "(worst {}; bound {})".format(label, worst_loss, PAR_LOSS_RTOL,
                                        worst, at, PAR_PARAM_REL))
    if worst_loss > PAR_LOSS_RTOL or worst > PAR_PARAM_REL:
        raise AssertionError("{} differs from the one-process step: losses "
                             "{:.3g}, params {:.3g} at {}".format(
                                 label, worst_loss, worst, at))


def par_rank(device, spec, time_allreduce=False):
    """A rank of phase 25: dryrun.run_rank's steps, then, where asked, 3
    timed runs (after a warm-up) of comm.all_reduce_tree over the world
    on a list of tensors of the trainable leaves' sizes."""
    import torch

    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.parallel import comm, dryrun
    from detectron_tpu_torch.parallel import optimizer as opt

    out = dryrun.run_rank(device, spec)
    if not time_allreduce:
        return out
    leaves = [p for path, p in opt.flatten(bridge.to_torch(
        spec["tree"], device, torch.float32))
        if opt.param_kind(path) not in opt.FROZEN_KINDS]
    world = torch.distributed.group.WORLD
    comm.all_reduce_tree(leaves, world)   # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = comm.all_reduce_tree(leaves, world)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce"] = {"ms": times, "calls": calls,
                        "numel": sum(t.numel() for t in leaves)}
    return out


def _spawn_ranks(devices, spec, backend, time_allreduce=False):
    from detectron_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as logs:
        try:
            return launch.spawn(
                "chip_smoke:par_rank", devices, (spec, time_allreduce),
                backend=backend, timeout_s=PAR_TIMEOUT_S, log_dir=logs)
        finally:
            for name in sorted(os.listdir(logs)):
                with open(os.path.join(logs, name)) as f:
                    tail = [x for x in f.read().splitlines()
                            if "socket.cpp" not in x][-5:]
                if tail:
                    print("  {} (last lines): {}".format(name, " | ".join(
                        tail)))


def _allreduce_line(label, got):
    a = got["allreduce"]
    print("{}: bucketed all-reduce of the trainable gradient tree ({} "
          "values, float32, {} calls): {} ms (3 runs after a warm-up)".format(
              label, a["numel"], a["calls"],
              [round(t, 3) for t in a["ms"]]))


def run_data_parallel_path():
    """Phase 25. Returns the launch counts of each rank's steps."""
    import torch

    paths = {}
    # The one-step comparison, float32 without cuDNN.
    spec = _par_spec("float32", cudnn=False, steps=1)
    ref_stats, ref_params, _ = _one_process_step(spec)
    t0 = time.perf_counter()
    ranks = _spawn_ranks([PAR_DEVICE] * PAR_RANKS, spec, "gloo")
    print("data-parallel check: {} gloo ranks on {} (1 image each) in "
          "{:.3f} s".format(PAR_RANKS, PAR_DEVICE, time.perf_counter() - t0))
    if any(r["stats"] != ranks[0]["stats"] for r in ranks):
        raise AssertionError("the ranks logged different stats")
    _compare_steps("data-parallel step (Mask R-CNN R-50-FPN, float32, {} x "
                   "{} x {}, {} ranks)".format(BATCH, *CANVAS, PAR_RANKS),
                   ranks[0]["stats"][0], ranks[0]["params"], ref_stats[0],
                   ref_params)
    del ref_params, ranks
    # The main path's setting (bf16, cuDNN) timed: one process on both
    # images, then 2 ranks sharing the card.
    spec = _par_spec("bfloat16", cudnn=True, steps=1 + PAR_STEPS)
    one_stats, _, one_ms = _one_process_step(spec, 1 + PAR_STEPS)
    ranks = _spawn_ranks([PAR_DEVICE] * PAR_RANKS, spec, "gloo",
                         time_allreduce=True)
    for r in ranks:
        paths["dp_train_rank{}".format(r["rank"])] = r["launches"]
        require_launches(r["launches"], ("nms_keep_mask", "roi_window_pool",
                                         "roi_window_accum"),
                         "dp_train rank {}".format(r["rank"]))
    bad = [s for r in ranks for s in r["stats"]
           if not all(np.isfinite(list(s.values())))]
    if bad:
        raise AssertionError("non-finite data-parallel stats: {}".format(bad))
    med = [statistics.median(r["step_ms"]) for r in ranks]
    print("data-parallel train path (bf16, {} ranks sharing one card's SMs "
          "over gloo: not a multi-card speed): median step {} ms per rank "
          "over {} steps after 1 warm-up; one process on both images: "
          "median {:.3f} ms; first-step loss {} (ranks) / {} (one process); "
          "launches {}".format(
              PAR_RANKS, [round(m, 3) for m in med], PAR_STEPS,
              statistics.median(one_ms), round(ranks[0]["stats"][0]["loss"],
                                               4),
              round(one_stats[0]["loss"], 4),
              [r["launches"] for r in ranks]))
    _allreduce_line("gloo through the host, {} ranks on cuda:0".format(
        PAR_RANKS), ranks[0])
    # NCCL on the card: a world of 1 (init, the bucketed all-reduce, steps).
    spec["mesh"] = (1, 1)
    spec["batch"] = {k: v[:1] for k, v in spec["batch"].items()}
    spec["draws"] = {k: v[:1] for k, v in spec["draws"].items()}
    nccl = _spawn_ranks([PAR_DEVICE], spec, None, time_allreduce=True)[0]
    paths["nccl_world1_train"] = nccl["launches"]
    require_launches(nccl["launches"], ("nms_keep_mask", "roi_window_pool",
                                        "roi_window_accum"),
                     "nccl_world1_train")
    print("NCCL world of 1 on cuda:0 (1 image, bf16): median step {:.3f} ms "
          "over {} steps, loss {}".format(
              statistics.median(nccl["step_ms"]), PAR_STEPS,
              round(nccl["stats"][0]["loss"], 4)))
    _allreduce_line("NCCL, world of 1", nccl)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2 and PAR_DEVICE.startswith("cuda"):
        spec = _par_spec("float32", cudnn=False, steps=1)
        ranks = _spawn_ranks(["cuda:0", "cuda:1"], spec, None)
        _compare_steps("cross-card NCCL step (2 cards)", ranks[0]["stats"][0],
                       ranks[0]["params"], ref_stats[0],
                       _one_process_step(spec)[1])
    else:
        print("cross-card NCCL: not run: torch.cuda.device_count() is {} "
              "(NCCL takes one rank per card)".format(n_cards))
    return paths


def cli_rank(argv):
    """A rank of phases 26-27: `python -c "import chip_smoke, sys;
    chip_smoke.cli_rank(sys.argv[1:])" MODULE OUT_PREFIX ARGS...` runs the
    CLI's main(ARGS) in that process, K1-K4's launch counters set to 0
    before, and writes the counts to OUT_PREFIX_rank<--host_rank>.json."""
    import importlib

    module, prefix, args = argv[0], argv[1], argv[2:]
    wrappers = kernel_wrappers(accum=True)
    importlib.import_module(module).main(args)
    rank = args[args.index("--host_rank") + 1]
    with open("{}_rank{}.json".format(prefix, rank), "w") as f:
        json.dump({k: fn.launches for k, fn in wrappers.items()}, f)


def _cli_ranks(workdir, tag, module, argv, backend="gloo"):
    """Two ranks of a CLI on cuda:0 in one world (launch.spawn_cli:
    --multihost_coordinator localhost:<free port> --num_hosts 2
    --host_rank r), each run through cli_rank. Returns each rank's (log,
    launch counts)."""
    from detectron_tpu_torch.parallel import launch

    prefix = os.path.join(workdir, tag)
    logs = ["{}_rank{}.log".format(prefix, r) for r in range(PAR_RANKS)]
    launch.spawn_cli(
        module, argv, [PAR_DEVICE] * PAR_RANKS, backend=backend, logs=logs,
        timeout_s=PAR_TIMEOUT_S,
        command=[sys.executable, "-c", "import chip_smoke, sys; "
                 "chip_smoke.cli_rank(sys.argv[1:])", module, prefix])
    got = []
    for r, log in enumerate(logs):
        with open(log) as f, open("{}_rank{}.json".format(prefix, r)) as g:
            got.append((f.read(), json.load(g)))
    return got


def _json_stats(text):
    import re

    return [json.loads(x) for x in re.findall(r"json_stats: (\{.*\})", text)]


def run_multihost_path(workdir):
    """Phase 26. Returns each rank's launch counts."""
    import re

    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import net as net_utils

    n_ann = make_valset(workdir, TRAIN_NET_IMAGES, "train2017")
    set_cfg(tiny=False, dtype="bfloat16")
    weights = net_utils.save_ckpt(os.path.join(workdir, "weights"), 0,
                                  make_tree())
    paths = {}

    def flags(steps, extra):
        return lambda r: [
            "--dataset", "coco2017", "--cfg", MASK_YAML, "--bs",
            str(BATCH), "--nw", "2", "--disp_interval", "1"] + extra + [
            "--set", "DATA_DIR", workdir, "OUTPUT_DIR",
            os.path.join(workdir, "out_rank{}".format(r)), "NUM_GPUS", "1",
            "SOLVER.MAX_ITER", str(steps), "SOLVER.CLIP_GRADIENTS",
            str(CLIP_GRADIENTS), "TPU.COMPUTE_DTYPE", "bfloat16"] + \
            PAR_TRAIN_KEYS

    ckpt_dir = os.path.join(workdir, "out_rank0", "e2e_mask_rcnn_R-50-FPN_1x",
                            "ckpt")
    runs = {}
    t0 = time.perf_counter()
    runs["multihost_train"] = _cli_ranks(
        workdir, "train", "detectron_tpu_torch.tools.train_net_step",
        flags(2, ["--load_ckpt", weights]))
    first_ckpts = sorted(os.listdir(ckpt_dir))
    runs["multihost_resume"] = _cli_ranks(
        workdir, "resume", "detectron_tpu_torch.tools.train_net_step",
        flags(3, ["--load_ckpt", os.path.join(ckpt_dir, "model_step2"),
                  "--resume"]))
    wall = time.perf_counter() - t0
    for name, ranks in runs.items():
        texts = [t for t, _ in ranks]
        for r, (text, launches) in enumerate(ranks):
            if not re.search(r"multi-host: process {}/{}, 1 local / {} global"
                             .format(r, PAR_RANKS, PAR_RANKS), text):
                raise AssertionError("{} rank {} did not join the world of "
                                     "{}".format(name, r, PAR_RANKS))
            paths["{}_rank{}".format(name, r)] = launches
            require_launches(launches, ("nms_keep_mask", "roi_window_pool",
                                        "roi_window_accum"),
                             "{} rank {}".format(name, r))
        seeds = [re.search(r"loader stream seed (\d+) \(host {}/".format(r),
                           t).group(1) for r, t in enumerate(texts)]
        stats = [_json_stats(t) for t in texts]
        mine = ("time", "eta")
        same = [[{k: v for k, v in s.items() if k not in mine} for s in st]
                for st in stats]
        want_iters = [0, 1] if name == "multihost_train" else [2]
        if len(set(seeds)) != PAR_RANKS or any(s != same[0] for s in same) \
                or [s["iter"] for s in stats[0]] != want_iters or not all(
                    np.isfinite(v) for s in stats[0] for k, v in s.items()
                    if k != "eta"):
            raise AssertionError("{}: seeds {}, stats {}".format(
                name, seeds, stats))
        print("{} (train_net_step, {} processes on cuda:0 over gloo, global "
              "batch {}, bf16): loader seeds {}, identical json_stats on "
              "every rank, iters {}, losses {}".format(
                  name, PAR_RANKS, BATCH, seeds, want_iters,
                  [round(s["loss"], 4) for s in stats[0]]))
    rank1 = [p for p in glob.glob(os.path.join(workdir, "out_rank1", "**"),
                                  recursive=True) if "model_step" in p]
    last_ckpts = sorted(os.listdir(ckpt_dir))
    if "model_step2" not in first_ckpts or "model_step3" not in last_ckpts \
            or rank1:
        raise AssertionError("checkpoints: rank 0 {} then {}, rank 1 {}"
                             .format(first_ckpts, last_ckpts, rank1))
    print("multi-host CLI: {} annotations on {} images; rank 0 wrote {} then "
          "{}, rank 1 nothing; --resume continued at step 2; {:.3f} s for "
          "both runs".format(n_ann, TRAIN_NET_IMAGES, first_ckpts,
                             last_ckpts, wall))
    return paths


def _detections_equal(a, b, num_classes):
    """Largest |box or score difference| and whether every class and
    image has the same count and identical RLE strings."""
    worst, same = 0.0, True
    for j in range(1, num_classes):
        for i in range(len(a["all_boxes"][j])):
            x, y = a["all_boxes"][j][i], b["all_boxes"][j][i]
            if x.shape != y.shape:
                return float("inf"), False
            if len(x):
                worst = max(worst, float(np.abs(x - y).max()))
            same &= [r["counts"] for r in a["all_segms"][j][i]] == \
                [r["counts"] for r in b["all_segms"][j][i]]
    return worst, same


def run_sharded_eval_path(workdir):
    """Phase 27. Returns each rank's launch counts."""
    import re
    import types

    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.tools.make_synthetic_valset import make_valset
    from detectron_tpu_torch.utils import net as net_utils

    make_valset(workdir, ENGINE_IMAGES)
    keys = ["DATA_DIR", workdir, "TEST.DATASETS",
            "('coco_2017_val',)"] + PAR_TEST_KEYS
    set_cfg(tiny=False, dtype="bfloat16", extra=keys, yaml=MASK_YAML)
    ckpt = net_utils.save_ckpt(os.path.join(workdir, "train"), 0,
                               make_tree())
    # The reference: one process, batches of each rank's rows.
    ref_dir = os.path.join(workdir, "one")
    t0 = time.perf_counter()
    ref_res = test_engine.run_inference(
        types.SimpleNamespace(load_ckpt=ckpt, load_detectron=None),
        dataset_name="coco_2017_val", output_dir=ref_dir,
        batch_size=ENGINE_BATCH // PAR_RANKS, device=PAR_DEVICE)
    one_s = time.perf_counter() - t0
    out_dir = os.path.join(workdir, "sharded")
    t0 = time.perf_counter()
    ranks = _cli_ranks(workdir, "test_net",
                       "detectron_tpu_torch.tools.test_net",
                       lambda r: ["--cfg", MASK_YAML, "--load_ckpt", ckpt,
                                  "--output_dir", out_dir, "--batch_size",
                                  str(ENGINE_BATCH), "--set"] + keys + [
                                      "TPU.COMPUTE_DTYPE", "bfloat16"])
    wall = time.perf_counter() - t0
    paths = {}
    for r, (text, launches) in enumerate(ranks):
        if not re.search(r"rank {} of {}, its rows of each batch".format(
                r, PAR_RANKS), text):
            raise AssertionError("rank {} did not run its rows".format(r))
        paths["sharded_test_net_rank{}".format(r)] = launches
        require_launches(launches, ("nms_keep_mask", "roi_window_pool"),
                         "sharded_test_net rank {}".format(r))
    rate = re.search(r"\(([0-9.]+) img/s end-to-end", ranks[0][0]).group(1)
    with open(os.path.join(out_dir, "detections.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(ref_dir, "detections.pkl"), "rb") as f:
        ref = pickle.load(f)
    worst, same_rles = _detections_equal(got, ref, cfg.MODEL.NUM_CLASSES)
    ap = re.findall(r"copypaste: ([-0-9.,]+)$", ranks[0][0], re.M)
    ref_ap = [",".join("{:.4f}".format(v) for v in m.values())
              for m in ref_res["coco_2017_val"].values()]
    print("sharded test_net (test_net.main on {} ranks sharing cuda:0 over "
          "gloo: not a multi-card speed; Mask R-CNN R-50-FPN yaml, bf16, "
          "batch {} = {} rows a rank): {} images in {:.3f} s with model load "
          "and evaluation, engine {} img/s (rank 0's log); one process, "
          "batches of {}: {:.3f} s; boxes and scores within {} of the one "
          "process's (bound 1e-3), RLEs {}; copypaste AP lines {} against "
          "{}".format(PAR_RANKS, ENGINE_BATCH, ENGINE_BATCH // PAR_RANKS,
                      ENGINE_IMAGES, wall, rate, ENGINE_BATCH // PAR_RANKS,
                      one_s, worst, "identical" if same_rles else "differ",
                      ap, ref_ap))
    if worst > 1e-3 or not same_rles or ap != ref_ap:
        raise AssertionError("the sharded engine differs from the one-"
                             "process engine on the same 4-image batches")
    return paths


def run_dryrun_path():
    """Phase 28. Returns each rank's launch counts."""
    from detectron_tpu_torch.core.config import cfg
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    ranks = dryrun.dryrun_multichip(4, device=PAR_DEVICE, backend="gloo",
                                    timeout_s=PAR_TIMEOUT_S, cudnn=False)
    wall = time.perf_counter() - t0
    n_data, n_model = dryrun.mesh_shape(4)
    dryrun.tiny_cfg(batch=n_data)
    batch = dryrun.dryrun_batch(n_data)
    spec = {"cfg": dryrun.cfg_snapshot(), "tree": init.init_model(0),
            "batch": batch, "draws": dryrun.global_draws(1, batch),
            "cudnn": False}
    ref_stats, ref_params, _ = _one_process_step(spec)
    _compare_steps("dryrun_multichip(4) ({} data x {} model, the box head "
                   "split, float32, global batch {}, 4 ranks on {} over "
                   "gloo, {:.3f} s)".format(n_data, n_model,
                                            cfg.TRAIN.IMS_PER_BATCH,
                                            PAR_DEVICE, wall),
                   ranks[0]["stats"][0], ranks[0]["params"], ref_stats[0],
                   ref_params)
    paths = {}
    for r in ranks:
        paths["dryrun_rank{}".format(r["rank"])] = r["launches"]
        require_launches(r["launches"], ("nms_keep_mask", "roi_window_pool",
                                         "roi_window_accum"),
                         "dryrun rank {}".format(r["rank"]))
    return paths


def run_parallel_phases(paths):
    """Phases 25-28, each timed; their launch counts go into paths."""
    import torch

    for phase, run, workdir in ((25, run_data_parallel_path, False),
                                (26, run_multihost_path, True),
                                (27, run_sharded_eval_path, True),
                                (28, run_dryrun_path, False)):
        if PAR_DEVICE.startswith("cuda"):
            # The ranks are processes of their own: give them the memory
            # this process's allocator holds from the earlier phases.
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if workdir:
            with tempfile.TemporaryDirectory() as wd:
                paths.update(run(wd))
        else:
            paths.update(run())
        print("phase {}: {:.3f} s".format(phase, time.perf_counter() - t0))


# ---------------------------------------------------------------------------
# Phase 31: the twin of bench.py in fresh processes
# ---------------------------------------------------------------------------

# (launches_by_path key, environment, the metric, the kernels that must
# launch, the kernels the path can launch). Each run takes one timed
# window (BENCH_WINDOWS 1: 12 batches of 64, or 10 training steps after
# the twin's 50 warm-up steps).
BENCH_RUNS = (
    ("bench_infer", {}, "inference",
     ("nms_keep_mask", "roi_window_pool"),
     ("nms_keep_mask", "roi_window_pool", "roi_window_pool_seg")),
    ("bench_infer_fused_res2", {"BENCH_SET": "TPU.FUSED_RES2 True"},
     "inference", ("nms_keep_mask", "roi_window_pool", "stem_pool",
                   "fused_res2"),
     ("nms_keep_mask", "roi_window_pool", "roi_window_pool_seg",
      "stem_pool", "fused_res2")),
    ("bench_train", {"BENCH_MODE": "train"}, "train",
     ("nms_keep_mask", "roi_window_pool", "roi_window_accum"),
     ("nms_keep_mask", "roi_window_pool", "roi_window_pool_seg",
      "roi_window_accum")))
BENCH_WINDOWS = "1"
BENCH_TIMEOUT_S = 600


def bench_twin_runs(keys):
    """Phase 31's fresh process: `python -c "import chip_smoke, sys;
    chip_smoke.bench_twin_runs(sys.argv[1:])" KEY...` runs the twin
    (tools/bench.main) for each BENCH_RUNS key in turn, with that run's
    environment, and writes each line it prints as "KEY\tout\tLINE" or
    "KEY\terr\tLINE" on stdout, then "KEY\trc\t0" (1, with the traceback
    among its err lines, where the run raised)."""
    import contextlib
    import io
    import traceback

    from detectron_tpu_torch.tools import bench

    runs = {key: env for key, env, *_ in BENCH_RUNS}
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    for key in keys:
        os.environ.clear()
        os.environ.update(base, BENCH_WINDOWS=BENCH_WINDOWS, **runs[key])
        out, err = io.StringIO(), io.StringIO()
        rc = 0
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                bench.main([])
            except Exception:
                traceback.print_exc()
                rc = 1
        for stream, text in (("out", out), ("err", err)):
            for line in text.getvalue().splitlines():
                print("{}\t{}\t{}".format(key, stream, line))
        print("{}\trc\t{}".format(key, rc), flush=True)
        if rc:
            break


def run_bench_twin(paths):
    """Phase 31: the twin's runs (BENCH_RUNS), one after another, in one
    fresh process (bench_twin_runs). Returns nothing; each run's launch
    counts go into paths."""
    import torch

    from detectron_tpu_torch.tools import bench

    torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; "
         "chip_smoke.bench_twin_runs(sys.argv[1:])"]
        + [key for key, *_ in BENCH_RUNS],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    print("twin: {} runs in one fresh process, {:.3f} s".format(
        len(BENCH_RUNS), time.perf_counter() - t0))
    lines = {}
    for line in proc.stdout.splitlines():
        key, stream, text = (line.split("\t", 2) + ["", ""])[:3]
        lines.setdefault(key, {}).setdefault(stream, []).append(text)
    for key, env, mode, need, can in BENCH_RUNS:
        got = lines.get(key, {})
        err = got.get("err", [])
        for line in err:
            print("{}: {}".format(key, line))
        out = got.get("out", [])
        if proc.returncode != 0 or got.get("rc") != ["0"] or len(out) != 1:
            raise AssertionError(
                "{}: exit {}, run status {}, {} stdout lines; stderr "
                "ends:\n{}".format(key, proc.returncode, got.get("rc"),
                                    len(out), "\n".join(
                                        (err or proc.stderr.splitlines())
                                        [-20:])))
        print("{}: {}".format(key, out[0]))
        rec = json.loads(out[0])
        metric = bench.TRAIN_METRIC if mode == "train" else bench.INFER_METRIC
        nums = [rec.get(k) for k in ("value", "median", "mfu",
                                     "tflops_per_image")]
        if rec.get("metric") != metric or rec.get("unit") != \
                "images/sec/chip" or rec.get("device") != kind or not all(
                    isinstance(v, (int, float)) and np.isfinite(v) and v > 0
                    for v in nums):
            raise AssertionError("{}: bad record {}".format(key, rec))
        run = bench.parse_stderr("\n".join(err))
        paths[key] = {k: run["timed"][k] for k in can}
        print("{}: launches over {} timed calls {}, per call {}".format(
            key, run["calls"], paths[key], run["per_call"]))
        missing = [k for k in need if paths[key][k] == 0]
        if missing:
            raise AssertionError("{}: kernels not launched: {}".format(
                key, ", ".join(missing)))


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

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    # The CPU-bound phases (3's plain paths, the parallel ranks) vary most
    # between hosts: print what the process may use.
    print("env: python {} torch {} cuda {}; CPU threads {}, os.cpu_count "
          "{}, affinity {}, cgroup quota {}".format(
              sys.version.split()[0], torch.__version__, torch.version.cuda,
              torch.get_num_threads(), os.cpu_count(),
              len(os.sched_getaffinity(0)), cpu_quota()))
    with phase_timer("phase 1"):
        t0 = time.perf_counter()
        libs = build.build_all()
        print("build: {} kernels in {:.1f} s ({})".format(
            len(libs), time.perf_counter() - t0,
            ", ".join(p.name for p in libs.values())))
        for source, log in build.LOGS.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas {}: {}".format(source, line.strip()))
        sass = build.sass_counts("fused_res2.cu", "fused_res2_f32_kernel",
                                 ("HMMA.1688.F32.TF32", "FFMA"))
        print("sass fused_res2_f32_kernel: {}".format(sass))
        if sass["HMMA.1688.F32.TF32"] == 0:
            raise AssertionError("K6's float32 route has no TF32 "
                                 "tensor-core product in its SASS")

    set_cfg(tiny=False, dtype="bfloat16")
    with phase_timer("phase 2"):
        entries = check_kernels(device)
    with phase_timer("phase 3"):
        check_ladder_grad(device)
        check_small_input(device)
        check_small_input(device, FUSED_RES2)
        check_small_train(device)
        check_small_input(device, keypoints=True)
        check_small_train(device, keypoints=True)
        check_small_input(device, c4=True)
        check_small_train(device, c4=True)
        check_small_input(device, RESNEXT_TINY, pixel_scale=20.0,
                          cls_scale=30.0)
        check_small_train(device, extra=RESNEXT_TINY)
        check_small_input(device, GN_TINY, pixel_scale=20.0,
                          cls_scale=100.0)
        check_small_train(device, extra=GN_TINY)
    with phase_timer("phase 4"):
        paths = {"inference": run_main_path(device)}
    with phase_timer("phase 5"):
        paths["training"] = run_train_path(device, args.profile_train,
                                           args.clip_gradients)
    with phase_timer("phase 6"):
        paths["inference_fused_res2"] = run_main_path(device, FUSED_RES2)
        compare_fused_inference(device)
    with phase_timer("phase 29"):
        paths.update(run_fused_f32_paths(device, args.clip_gradients))
    with phase_timer("phase 7"), tempfile.TemporaryDirectory() as workdir:
        paths["test_net"] = run_engine_path(device, workdir)
    with phase_timer("phase 8"), tempfile.TemporaryDirectory() as workdir:
        paths["train_net"] = run_train_net_path(device, workdir)
    with phase_timer("phase 9"), tempfile.TemporaryDirectory() as workdir:
        paths["keypoint_infer"], paths["keypoint_test_net"] = \
            run_keypoint_infer_path(device, workdir)
    with phase_timer("phase 10"), tempfile.TemporaryDirectory() as workdir:
        paths["keypoint_train"] = run_keypoint_train_net_path(device,
                                                              workdir)
    for model, key, engine, phases in ((C4_MODEL, "c4", True, "11-13"),
                                       (X152_MODEL, "x152", True, "15-17"),
                                       (GN_MODEL, "gn", False, "18")):
        if key == "x152":
            with phase_timer("phase 14"):
                paths["deterministic_train"] = run_det_train_check(device)
                paths["deterministic_c4_train"] = run_det_train_check(
                    device, "Mask R-CNN R-50-C4", c4=True)
                with tempfile.TemporaryDirectory() as workdir:
                    paths["deterministic_resume"] = run_det_resume_check(
                        device, workdir)
        t_model = time.perf_counter()
        set_cfg(tiny=False, dtype="bfloat16", **model["cfg"])
        base = make_tree()
        print("{} set-up: init_model and calibrate_detector_params in "
              "{:.3f} s".format(model["label"],
                                time.perf_counter() - t_model))
        paths[key + "_infer"] = run_model_infer_path(device, model, base)
        if engine:
            with tempfile.TemporaryDirectory() as workdir:
                paths[key + "_test_net"] = run_model_engine_path(
                    device, workdir, model, base)
        with tempfile.TemporaryDirectory() as workdir:
            paths[key + "_train"] = run_model_train_net_path(
                device, workdir, model, base)
        print("phase {}: {:.3f} s".format(phases,
                                          time.perf_counter() - t_model))
        if key == "x152":
            with phase_timer("phase 30, multiscale_bench"):
                run_multiscale_bench(device, base, paths)
        del base
    with phase_timer("phase 19"), tempfile.TemporaryDirectory() as workdir:
        paths["tta_test_net"], paths["tta_keypoint_test_net"] = \
            run_tta_path(device, workdir)
    with phase_timer("phase 20"):
        paths.update(run_variant_paths(device))
    run_new_phases(device, paths)
    with phase_timer("phase 30"), tempfile.TemporaryDirectory() as workdir:
        run_measuring_tools(device, workdir, paths)
    run_parallel_phases(paths)
    with phase_timer("phase 31"):
        run_bench_twin(paths)
    print("chip_smoke: {:.3f} s".format(time.perf_counter() - t_start))

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
        "channel_epilogue": ("detectron_tpu_torch/csrc/channel_epilogue.cu",
                             "none (XLA's fusion)"),
    }
    # The path each kernel's launches are read from: the main (inference)
    # path for K1-K3, training for K4, the deterministic training steps
    # for K4's deterministic variant, TPU.FUSED_RES2 inference for K5/K6,
    # the main (inference) path for the conv epilogue.
    path_of = {"nms_keep_mask": "inference", "roi_window_pool": "inference",
               "roi_window_pool_seg": "inference",
               "roi_window_accum": "training",
               "roi_window_accum_det": "deterministic_train",
               "stem_pool": "inference_fused_res2",
               "fused_res2": "inference_fused_res2",
               "channel_epilogue": "inference"}
    kernels = []
    for name, (src, rep) in meta.items():
        e = entries[name]
        by_path = {path: counts[name] for path, counts in paths.items()
                   if name in counts}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_path[path_of[name]],
            "launches_by_path": by_path,
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "device_ms": e["device_ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None, "shape": e["shape"],
            **{k: v for k, v in e.items() if k.startswith((
                "atomic_", "det_over_atomic", "other_") + tuple(
                    d + "_" for d in DET_KERNELS))},
            **{k: dict(v, library_ms=None) for k, v in e.items()
               if k.startswith(("c4", "tta", "f32", "narrow", "branch1"))}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
