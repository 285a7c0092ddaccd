"""Global config tree for detectron_tpu_torch.

The port's own copy of detectron_tpu/core/config.py: the same keys,
defaults, merge rules and assert_and_infer_cfg, in a `cfg` object of its
own, so merging a key here leaves the JAX package's cfg as it is. The
`TPU.*` keys keep their names (the cfg surface is shared with the JAX
package and its yaml files); the port reads those that set values
(COMPUTE_DTYPE, ROI_RUNGS, MAX_GT_BOXES, ...) and rejects the TPU-only
paths it does not run.

`yaml` is imported only by load_cfg, so the presets and
merge_cfg_from_list work on a host without PyYAML.
"""

import copy
import os

import numpy as np

from detectron_tpu_torch.utils.collections import AttrDict

__C = AttrDict()
cfg = __C

# ---------------------------------------------------------------------------
# Training options
# ---------------------------------------------------------------------------
__C.TRAIN = AttrDict()
__C.TRAIN.DATASETS = ()
__C.TRAIN.SCALES = (600,)
__C.TRAIN.MAX_SIZE = 1000
__C.TRAIN.IMS_PER_BATCH = 2
__C.TRAIN.BATCH_SIZE_PER_IM = 64
__C.TRAIN.FG_FRACTION = 0.25
__C.TRAIN.FG_THRESH = 0.5
__C.TRAIN.BG_THRESH_HI = 0.5
__C.TRAIN.BG_THRESH_LO = 0.0
__C.TRAIN.USE_FLIPPED = True
__C.TRAIN.BBOX_THRESH = 0.5
__C.TRAIN.SNAPSHOT_ITERS = 20000
__C.TRAIN.PROPOSAL_FILES = ()
__C.TRAIN.CROWD_FILTER_THRESH = 0.7
__C.TRAIN.GT_MIN_AREA = -1
__C.TRAIN.FREEZE_CONV_BODY = False
# RPN training options
__C.TRAIN.RPN_POSITIVE_OVERLAP = 0.7
__C.TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
__C.TRAIN.RPN_FG_FRACTION = 0.5
__C.TRAIN.RPN_BATCH_SIZE_PER_IM = 256
__C.TRAIN.RPN_NMS_THRESH = 0.7
__C.TRAIN.RPN_PRE_NMS_TOP_N = 12000
__C.TRAIN.RPN_POST_NMS_TOP_N = 2000
__C.TRAIN.RPN_STRADDLE_THRESH = 0
__C.TRAIN.RPN_MIN_SIZE = 0
__C.TRAIN.ASPECT_GROUPING = True
__C.TRAIN.ASPECT_CROPPING = False
__C.TRAIN.ASPECT_HI = 2
__C.TRAIN.ASPECT_LO = 0.5

# ---------------------------------------------------------------------------
# Inference ('test') options
# ---------------------------------------------------------------------------
__C.TEST = AttrDict()
__C.TEST.DATASETS = ()
__C.TEST.SCALE = 600
__C.TEST.MAX_SIZE = 1000
__C.TEST.NMS = 0.3
__C.TEST.BBOX_REG = True
__C.TEST.PROPOSAL_FILES = ()
__C.TEST.PROPOSAL_LIMIT = 2000
__C.TEST.RPN_NMS_THRESH = 0.7
__C.TEST.RPN_PRE_NMS_TOP_N = 12000
__C.TEST.RPN_POST_NMS_TOP_N = 2000
__C.TEST.RPN_MIN_SIZE = 0
__C.TEST.DETECTIONS_PER_IM = 100
__C.TEST.SCORE_THRESH = 0.05
__C.TEST.COMPETITION_MODE = True
__C.TEST.FORCE_JSON_DATASET_EVAL = False
__C.TEST.PRECOMPUTED_PROPOSALS = False

# Soft NMS
__C.TEST.SOFT_NMS = AttrDict()
__C.TEST.SOFT_NMS.ENABLED = False
__C.TEST.SOFT_NMS.METHOD = "linear"
__C.TEST.SOFT_NMS.SIGMA = 0.5

# Box voting
__C.TEST.BBOX_VOTE = AttrDict()
__C.TEST.BBOX_VOTE.ENABLED = False
__C.TEST.BBOX_VOTE.VOTE_TH = 0.8
__C.TEST.BBOX_VOTE.SCORING_METHOD = "ID"
__C.TEST.BBOX_VOTE.SCORING_METHOD_BETA = 1.0

# Test-time augmentation for bbox detection
__C.TEST.BBOX_AUG = AttrDict()
__C.TEST.BBOX_AUG.ENABLED = False
__C.TEST.BBOX_AUG.SCORE_HEUR = "UNION"
__C.TEST.BBOX_AUG.COORD_HEUR = "UNION"
__C.TEST.BBOX_AUG.H_FLIP = False
__C.TEST.BBOX_AUG.SCALES = ()
__C.TEST.BBOX_AUG.MAX_SIZE = 4000
__C.TEST.BBOX_AUG.SCALE_H_FLIP = False
__C.TEST.BBOX_AUG.SCALE_SIZE_DEP = False
__C.TEST.BBOX_AUG.AREA_TH_LO = 50**2
__C.TEST.BBOX_AUG.AREA_TH_HI = 180**2
__C.TEST.BBOX_AUG.ASPECT_RATIOS = ()
__C.TEST.BBOX_AUG.ASPECT_RATIO_H_FLIP = False

# Test-time augmentation for masks
__C.TEST.MASK_AUG = AttrDict()
__C.TEST.MASK_AUG.ENABLED = False
__C.TEST.MASK_AUG.HEUR = "SOFT_AVG"
__C.TEST.MASK_AUG.H_FLIP = False
__C.TEST.MASK_AUG.SCALES = ()
__C.TEST.MASK_AUG.MAX_SIZE = 4000
__C.TEST.MASK_AUG.SCALE_H_FLIP = False
__C.TEST.MASK_AUG.SCALE_SIZE_DEP = False
__C.TEST.MASK_AUG.AREA_TH = 180**2
__C.TEST.MASK_AUG.ASPECT_RATIOS = ()
__C.TEST.MASK_AUG.ASPECT_RATIO_H_FLIP = False

# Test-time augmentation for keypoints
__C.TEST.KPS_AUG = AttrDict()
__C.TEST.KPS_AUG.ENABLED = False
__C.TEST.KPS_AUG.HEUR = "HM_AVG"
__C.TEST.KPS_AUG.H_FLIP = False
__C.TEST.KPS_AUG.SCALES = ()
__C.TEST.KPS_AUG.MAX_SIZE = 4000
__C.TEST.KPS_AUG.SCALE_H_FLIP = False
__C.TEST.KPS_AUG.SCALE_SIZE_DEP = False
__C.TEST.KPS_AUG.AREA_TH = 180**2
__C.TEST.KPS_AUG.ASPECT_RATIOS = ()
__C.TEST.KPS_AUG.ASPECT_RATIO_H_FLIP = False

# ---------------------------------------------------------------------------
# Model options
# ---------------------------------------------------------------------------
__C.MODEL = AttrDict()
__C.MODEL.TYPE = "generalized_rcnn"
__C.MODEL.CONV_BODY = ""
__C.MODEL.NUM_CLASSES = -1
__C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
__C.MODEL.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
__C.MODEL.FASTER_RCNN = False
__C.MODEL.MASK_ON = False
__C.MODEL.KEYPOINTS_ON = False
__C.MODEL.RPN_ONLY = False
__C.MODEL.EXECUTION_TYPE = "DAG"  # accepted, ignored (Caffe2 legacy)
__C.MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS = False
# Caffe2-era key accepted for yaml compatibility
__C.MODEL.SHARE_RES5 = False
__C.MODEL.UNSUPERVISED_POSE = False

# ---------------------------------------------------------------------------
# RetinaNet placeholder tree (reference declares it; not a supported model
# type there either — accepted for yaml compatibility)
# ---------------------------------------------------------------------------
__C.RETINANET = AttrDict()
__C.RETINANET.RETINANET_ON = False

# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
__C.SOLVER = AttrDict()
__C.SOLVER.TYPE = "SGD"
__C.SOLVER.BASE_LR = 0.001
__C.SOLVER.LR_POLICY = "step"
__C.SOLVER.GAMMA = 0.1
__C.SOLVER.STEP_SIZE = 30000
__C.SOLVER.STEPS = ()
__C.SOLVER.LRS = ()
__C.SOLVER.MAX_ITER = 40000
__C.SOLVER.MOMENTUM = 0.9
__C.SOLVER.WEIGHT_DECAY = 0.0005
__C.SOLVER.WEIGHT_DECAY_GN = 0.0
__C.SOLVER.BIAS_DOUBLE_LR = True
__C.SOLVER.BIAS_WEIGHT_DECAY = False
__C.SOLVER.WARM_UP_ITERS = 500
__C.SOLVER.WARM_UP_FACTOR = 1.0 / 3.0
__C.SOLVER.WARM_UP_METHOD = "linear"
__C.SOLVER.SCALE_MOMENTUM = True
__C.SOLVER.SCALE_MOMENTUM_THRESHOLD = 1.1
__C.SOLVER.LOG_LR_CHANGE_THRESHOLD = 1.1
# Global-norm gradient clipping (0 = off). The reference ships a
# clip_gradient helper (lib/utils/net.py); this is its global-norm form,
# needed for from-scratch training without normalization layers.
__C.SOLVER.CLIP_GRADIENTS = 0.0

# ---------------------------------------------------------------------------
# Fast R-CNN (box head)
# ---------------------------------------------------------------------------
__C.FAST_RCNN = AttrDict()
__C.FAST_RCNN.ROI_BOX_HEAD = ""
__C.FAST_RCNN.MLP_HEAD_DIM = 1024
__C.FAST_RCNN.CONV_HEAD_DIM = 256
__C.FAST_RCNN.NUM_STACKED_CONVS = 4
__C.FAST_RCNN.ROI_XFORM_METHOD = "RoIPoolF"
__C.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO = 0
__C.FAST_RCNN.ROI_XFORM_RESOLUTION = 14

# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------
__C.RPN = AttrDict()
__C.RPN.RPN_ON = False
__C.RPN.OUT_DIM_AS_IN_DIM = True
__C.RPN.OUT_DIM = 512
__C.RPN.CLS_ACTIVATION = "sigmoid"
__C.RPN.SIZES = (64, 128, 256, 512)
__C.RPN.STRIDE = 16
__C.RPN.ASPECT_RATIOS = (0.5, 1, 2)

# ---------------------------------------------------------------------------
# FPN
# ---------------------------------------------------------------------------
__C.FPN = AttrDict()
__C.FPN.FPN_ON = False
__C.FPN.DIM = 256
__C.FPN.ZERO_INIT_LATERAL = False
__C.FPN.COARSEST_STRIDE = 32
__C.FPN.MULTILEVEL_ROIS = False
__C.FPN.ROI_CANONICAL_SCALE = 224
__C.FPN.ROI_CANONICAL_LEVEL = 4
__C.FPN.ROI_MAX_LEVEL = 5
__C.FPN.ROI_MIN_LEVEL = 2
__C.FPN.MULTILEVEL_RPN = False
__C.FPN.RPN_MAX_LEVEL = 6
__C.FPN.RPN_MIN_LEVEL = 2
__C.FPN.RPN_ASPECT_RATIOS = (0.5, 1, 2)
__C.FPN.RPN_ANCHOR_START_SIZE = 32
__C.FPN.RPN_COLLECT_SCALE = 1
__C.FPN.EXTRA_CONV_LEVELS = False
__C.FPN.USE_GN = False

# ---------------------------------------------------------------------------
# Mask R-CNN head
# ---------------------------------------------------------------------------
__C.MRCNN = AttrDict()
__C.MRCNN.ROI_MASK_HEAD = ""
__C.MRCNN.RESOLUTION = 14
__C.MRCNN.ROI_XFORM_METHOD = "RoIAlign"
__C.MRCNN.ROI_XFORM_RESOLUTION = 7
__C.MRCNN.ROI_XFORM_SAMPLING_RATIO = 0
__C.MRCNN.DIM_REDUCED = 256
__C.MRCNN.DILATION = 2
__C.MRCNN.UPSAMPLE_RATIO = 1
__C.MRCNN.USE_FC_OUTPUT = False
__C.MRCNN.CONV_INIT = "GaussianFill"
__C.MRCNN.CLS_SPECIFIC_MASK = True
__C.MRCNN.WEIGHT_LOSS_MASK = 1.0
__C.MRCNN.THRESH_BINARIZE = 0.5
__C.MRCNN.MEMORY_EFFICIENT_LOSS = True  # accepted, ignored

# ---------------------------------------------------------------------------
# Keypoint R-CNN head
# ---------------------------------------------------------------------------
__C.KRCNN = AttrDict()
__C.KRCNN.ROI_KEYPOINTS_HEAD = ""
__C.KRCNN.HEATMAP_SIZE = -1
__C.KRCNN.UP_SCALE = -1
__C.KRCNN.USE_DECONV = False
__C.KRCNN.DECONV_DIM = 256
__C.KRCNN.USE_DECONV_OUTPUT = False
__C.KRCNN.DILATION = 1
__C.KRCNN.DECONV_KERNEL = 4
__C.KRCNN.NUM_KEYPOINTS = -1
__C.KRCNN.NUM_STACKED_CONVS = 8
__C.KRCNN.CONV_HEAD_DIM = 256
__C.KRCNN.CONV_HEAD_KERNEL = 3
__C.KRCNN.CONV_INIT = "GaussianFill"
__C.KRCNN.USE_FC_OUTPUT = False
__C.KRCNN.ROI_XFORM_METHOD = "RoIAlign"
__C.KRCNN.ROI_XFORM_RESOLUTION = 7
__C.KRCNN.ROI_XFORM_SAMPLING_RATIO = 0
__C.KRCNN.MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH = 20
__C.KRCNN.NMS_OKS = False
__C.KRCNN.KEYPOINT_CONFIDENCE = "bbox"
__C.KRCNN.LOSS_WEIGHT = 1.0
__C.KRCNN.NORMALIZE_BY_VISIBLE_KEYPOINTS = True
__C.KRCNN.INFERENCE_MIN_SIZE = 0

# ---------------------------------------------------------------------------
# ResNets / ResNeXts
# ---------------------------------------------------------------------------
__C.RESNETS = AttrDict()
__C.RESNETS.NUM_GROUPS = 1
__C.RESNETS.WIDTH_PER_GROUP = 64
__C.RESNETS.STRIDE_1X1 = True
__C.RESNETS.TRANS_FUNC = "bottleneck_transformation"
__C.RESNETS.STEM_FUNC = "basic_bn_stem"
__C.RESNETS.SHORTCUT_FUNC = "basic_bn_shortcut"
__C.RESNETS.RES5_DILATION = 1
__C.RESNETS.FREEZE_AT = 2
__C.RESNETS.USE_GN = False
__C.RESNETS.IMAGENET_PRETRAINED_WEIGHTS = ""

# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------
__C.GROUP_NORM = AttrDict()
__C.GROUP_NORM.DIM_PER_GP = -1
__C.GROUP_NORM.NUM_GROUPS = 32
__C.GROUP_NORM.EPSILON = 1e-5

# ---------------------------------------------------------------------------
# Data loader
# ---------------------------------------------------------------------------
__C.DATA_LOADER = AttrDict()
__C.DATA_LOADER.NUM_THREADS = 4

# ---------------------------------------------------------------------------
# TPU-specific options (additions over the reference surface)
# ---------------------------------------------------------------------------
__C.TPU = AttrDict()
# Compute dtype for conv bodies/heads ('bfloat16' or 'float32'). Params are
# always float32; activations are cast. bfloat16 keeps the MXU fed at 2x rate.
__C.TPU.COMPUTE_DTYPE = "float32"
# Mesh axis names for data parallelism.
__C.TPU.MESH_AXES = ("data",)
# Proposals kept per image after in-graph NMS at train/test time equal the
# RPN_POST_NMS_TOP_N keys; pre-NMS top-k preselection size is clamped to this
# to bound the O(K^2/tile) NMS cost on TPU.
__C.TPU.NMS_TILE_SIZE = 256
# Max ground-truth boxes per image (static padding of gt arrays).
__C.TPU.MAX_GT_BOXES = 100
# Per-gt dense mask crop resolution rasterized by the loader (the in-graph
# mask-target op crop-resizes these to MRCNN.RESOLUTION per sampled RoI).
__C.TPU.GT_MASK_SIZE = 112
# Pad per-image proposals to this many RoIs at inference (post-NMS cap).
# -1 => use TEST.RPN_POST_NMS_TOP_N.
__C.TPU.TEST_ROIS_PER_IM = -1
# Static per-image cap on precomputed proposals fed to TRAINING in Fast
# R-CNN mode (TRAIN.PROPOSAL_FILES, RPN off). The loader pads/truncates the
# entry's proposal boxes to this many.
__C.TPU.MAX_TRAIN_PROPOSALS = 1000
# RoI chunk size for RoIAlign / head evaluation (bounds the per-chunk
# gather/matmul intermediates; see ops/multilevel_roi.py).
__C.TPU.ROI_CHUNK = 128
# FPN RoIAlign implementation: 'windowed' (one window slice per RoI + MXU
# interpolation matmuls — fastest on TPU) ("pallas": per-RoI DMA kernel), "windowed" (XLA dynamic_slice), or "gather" (point gathers;
# exact for arbitrarily extreme aspect ratios, slower).
__C.TPU.ROI_IMPL = "pallas"
# Batched NMS implementation: 'pallas' (TPU kernel) or 'xla' (tiled lax).
__C.TPU.NMS_IMPL = "pallas"
# Rematerialize (jax.checkpoint) each backbone stage in the train graph —
# trades ~30% more FLOPs for O(stage) activation memory; enables big-batch /
# X-152 multi-scale training on 16 GB chips.
__C.TPU.REMAT_BODY = False
# Window size (feature cells) for the windowed/pallas RoIAlign below the
# top FPN level. 32 is exact for every unclamped level at the default
# canonical scale/level (extent < 28 cells + borders); RoIs clamped to the
# top level are handled exactly by dense whole-level interpolation (the
# hybrid path in ops/windowed_roi.py), so no RoI ever clamps its samples.
__C.TPU.ROI_WINDOW = 32
# Window-shape rung LADDER for the pallas RoI path: RoIs are rung-sorted and
# each rung runs a segmented kernel sweep with exactly the window shape it
# needs (ops/windowed_roi.py :: multilevel_roi_align_pallas_ladder). The
# common case pays a smaller (32, 40) window than the single-window path's
# uniform full-canvas width, and elongated mid-level RoIs (which the
# single-window path CLAMPS) become exact. Matches the reference CUDA
# RoIAlign exactness (lib/modeling/roi_xfrom/roi_align) for every practical
# RoI shape.
__C.TPU.ROI_LADDER = True
# The mid-level rung shapes (window_y, window_x), tried in order; a
# whole-top-level rung is appended automatically. Defaults cover one-axis
# feature extents to ~61 tall / ~86 wide (aspect ratios ~5-9 at band-top
# sizes). window_x must be a multiple of 8 (sublane alignment).
# (16, 96) ahead of (32, 96): measured on v5e (round 5), the wide RoIs a
# trained-calibrated workload produces are clipped anchors with ey 9.5-14,
# so the short-wide rung takes ALL of that traffic at half the window DMA
# (+2.1 img/s end-to-end); (32, 96) stays as an exactness backstop for
# taller wide RoIs (ey 15-30) and is skipped for free when its count is
# zero (per-rung tier dispatch).
__C.TPU.ROI_RUNGS = ((32, 40), (64, 48), (16, 96), (32, 96))
# Narrow-base ladder: keep the BASE sweep at ROI_RUNGS[0] instead of
# widening it to whole-top-level x coverage (a ~17% cut of the dominant
# base-sweep window DMA at the 832x1344 canvas: (32, 40) vs (32, 48));
# top-level RoIs route through an auto-appended whole-top-level fixup rung
# with a generous n/4 compaction capacity (full-capacity lax.cond escape
# beyond that). Exactness is identical either way — this only moves DMA.
# Default off pending hardware A/B (see PERF.md).
__C.TPU.ROI_LADDER_NARROW = False
# RoIs pooled per kernel grid step (J) in the ladder sweeps. The base sweep
# runs ceil(n/J) grid steps; each step pays fixed costs (per-RoI DMA issue,
# latency-bound interpolation matmuls, bookkeeping) on top of its window
# DMA, so at small windows the sweep is STEP-bound, not DMA-bound (measured
# round 5: shrinking the base window (32,48)->(24,40), -37% DMA, changed
# throughput by -1 img/s). Larger J amortizes the fixed costs; VMEM bounds
# it — J=16 double-buffered needs the elevated per-kernel scope and only
# fits at window_y <= 24 (roi_align_kernel._pick_layout degrades to
# single-slot otherwise, which measured SLOWER in round 2).
__C.TPU.ROI_ROIS_PER_STEP = 8
# Space-to-depth stem: compute the 7x7/s2 stem conv as the mathematically
# identical 4x4/s1 conv on 2x2-blocked input (12 channels) — the MLPerf-era
# TPU trick. MEASURED SLOWER here (v5e, 832x1344 batch 32: +4.6 ms vs the
# direct conv — XLA's native C=3 conv handling already wins and the blocked
# reshape costs an extra HBM round trip), so off by default; kept as a
# tested, toggleable experiment (see PERF.md).
__C.TPU.S2D_STEM = False
# HOST-side space-to-depth input: the loader / serving host emits images
# already padded-by-4 and 2x2-blocked to (B, H/2+4, W/2+4, 12)
# (utils/blob.space_to_depth), and the stem runs the mathematically
# identical 4x4/s1 VALID conv directly — no in-graph blocked reshape (the
# HBM round trip that made TPU.S2D_STEM lose). Consumers must feed blocked
# images when this is on (loader, test_engine, bench do).
__C.TPU.S2D_INPUT = False
# Fused res2 Pallas kernel: run all three res2 bottleneck blocks on a y-tile
# of the image per grid step (frozen-BN affines folded into the conv
# weights), cutting the stage's HBM traffic ~5x — round-4 xprof measured
# ~40 ms/step of stem+res2 convs pinned at 565-700 GB/s / 2-60 TF/s at
# batch 48 (PERF.md). Forward-only; applies when the stage is frozen
# (FREEZE_AT >= 2, every reference config), affine-normed, ungrouped, and
# the canvas is tile-legal — models/resnet.py falls back to the XLA stage
# otherwise (ops/pallas/fused_stem_kernel.py).
__C.TPU.FUSED_RES2 = False

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
__C.NUM_GPUS = 1  # reference-schedule descriptor; here: #chips in the mesh
__C.DEDUP_BOXES = 1.0 / 16.0
__C.BBOX_XFORM_CLIP = np.log(1000.0 / 16.0)
__C.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
__C.RNG_SEED = 3
__C.EPS = 1e-14
__C.ROOT_DIR = os.getcwd()
__C.OUTPUT_DIR = "Outputs"
__C.MATLAB = "matlab"  # accepted, ignored (VOC devkit legacy)
__C.VIS = False
__C.VIS_TH = 0.9
__C.EXPECTED_RESULTS = []
__C.EXPECTED_RESULTS_RTOL = 0.1
__C.EXPECTED_RESULTS_ATOL = 0.005
__C.EXPECTED_RESULTS_EMAIL = ""
__C.DATA_DIR = os.path.join(os.getcwd(), "data")
__C.POOLING_MODE = "crop"  # legacy key, accepted
__C.POOLING_SIZE = 7
__C.CROP_RESIZE_WITH_MAX_POOL = True
__C.CUDA = False  # legacy, accepted & ignored
__C.DEBUG = False
__C.PYTORCH_VERSION_LESS_THAN_040 = False  # legacy, accepted & ignored


# ---------------------------------------------------------------------------
# Deprecated / renamed key handling (mirrors the reference's behavior of
# warning-and-ignoring known-stale yaml keys)
# ---------------------------------------------------------------------------
_DEPRECATED_KEYS = {
    "FINAL_MSG",
    "MODEL.DILATION",
    "ROOT_GPU_ID",
    "RPN.ON",
    "TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED",
    "TRAIN.DROPOUT",
    "USE_GPU_NMS",
    "TEST.NUM_TEST_IMAGES",
}

_RENAMED_KEYS = {
    "EXAMPLE.RENAMED.KEY": "EXAMPLE.KEY",
    "PIXEL_MEAN": "PIXEL_MEANS",
}


def load_cfg(cfg_to_load):
    """Parse a yaml config string or file object into an AttrDict."""
    import yaml

    if hasattr(cfg_to_load, "read"):
        cfg_to_load = cfg_to_load.read()
    return _to_attr_dict(yaml.safe_load(cfg_to_load))


def _to_attr_dict(d):
    if isinstance(d, dict):
        out = AttrDict()
        for k, v in d.items():
            out[k] = _to_attr_dict(v)
        return out
    return d


def merge_cfg_from_file(cfg_filename):
    """Load a yaml config file and merge it into the global config."""
    with open(cfg_filename, "r") as f:
        yaml_cfg = load_cfg(f)
    _merge_a_into_b(yaml_cfg, __C)


def merge_cfg_from_cfg(cfg_other):
    """Merge `cfg_other` into the global config."""
    _merge_a_into_b(cfg_other, __C)


def merge_cfg_from_list(cfg_list):
    """Merge config keys/values in a list (e.g. from `--set K V ...`)."""
    assert len(cfg_list) % 2 == 0
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        if _key_is_deprecated(full_key):
            continue
        if _key_is_renamed(full_key):
            _raise_key_rename_error(full_key)
        key_list = full_key.split(".")
        d = __C
        for subkey in key_list[:-1]:
            assert subkey in d, "Non-existent key: {}".format(full_key)
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, "Non-existent key: {}".format(full_key)
        value = _decode_cfg_value(v)
        value = _check_and_coerce_cfg_value_type(value, d[subkey], subkey, full_key)
        d[subkey] = value


def _merge_a_into_b(a, b, stack=None):
    """Merge config dictionary a into config dictionary b, clobbering the
    options in b whenever they are also specified in a."""
    assert isinstance(a, AttrDict), "`a` must be an AttrDict"
    assert isinstance(b, AttrDict), "`b` must be an AttrDict"

    for k, v_ in a.items():
        full_key = ".".join(stack) + "." + k if stack is not None else k
        if k not in b:
            if _key_is_deprecated(full_key):
                continue
            elif _key_is_renamed(full_key):
                _raise_key_rename_error(full_key)
            else:
                raise KeyError("Non-existent config key: {}".format(full_key))

        v = copy.deepcopy(v_)
        v = _decode_cfg_value(v)
        v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)

        if isinstance(v, AttrDict):
            stack_push = [k] if stack is None else stack + [k]
            _merge_a_into_b(v, b[k], stack=stack_push)
        else:
            b[k] = v


def _key_is_deprecated(full_key):
    if full_key in _DEPRECATED_KEYS:
        import logging

        logging.getLogger(__name__).warning(
            "Deprecated config key (ignoring): %s", full_key
        )
        return True
    return False


def _key_is_renamed(full_key):
    return full_key in _RENAMED_KEYS


def _raise_key_rename_error(full_key):
    new_key = _RENAMED_KEYS[full_key]
    raise KeyError(
        "Key {} was renamed to {}; please update your config.".format(
            full_key, new_key
        )
    )


def _decode_cfg_value(v):
    """Decode a raw config value (e.g. from yaml or a string) into a Python
    object."""
    if isinstance(v, dict):
        return AttrDict(v)
    if not isinstance(v, str):
        return v
    try:
        import ast

        v = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    return v


def _check_and_coerce_cfg_value_type(value_a, value_b, key, full_key):
    """Check that value_a (the replacement) matches value_b's (default) type,
    coercing tuple<->list and str<->unicode-style mismatches."""
    type_a, type_b = type(value_a), type(value_b)
    if type_a is type_b:
        return value_a
    # numpy arrays can absorb lists
    if isinstance(value_b, np.ndarray):
        return np.array(value_a, dtype=value_b.dtype)
    if isinstance(value_a, tuple) and isinstance(value_b, list):
        return list(value_a)
    if isinstance(value_a, list) and isinstance(value_b, tuple):
        return tuple(value_a)
    if isinstance(value_a, int) and isinstance(value_b, float):
        return float(value_a)
    # bools are ints in yaml sometimes
    if isinstance(value_a, int) and isinstance(value_b, bool):
        return bool(value_a)
    if value_b is None:
        return value_a
    raise ValueError(
        "Type mismatch ({} vs. {}) with values ({} vs. {}) for config "
        "key: {}".format(type_b, type_a, value_b, value_a, full_key)
    )


_assert_inferred = False


def assert_and_infer_cfg(make_immutable=True):
    """Validate config options and infer derived ones. Call once after all
    merges (mirrors the reference's assert_and_infer_cfg)."""
    global _assert_inferred
    if __C.MODEL.RPN_ONLY or __C.MODEL.FASTER_RCNN:
        __C.RPN.RPN_ON = True
    if __C.RPN.RPN_ON or __C.RETINANET.RETINANET_ON:
        __C.TEST.PRECOMPUTED_PROPOSALS = False
    if __C.MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS:
        assert __C.RESNETS.IMAGENET_PRETRAINED_WEIGHTS, (
            "Path to the weight file must not be empty to load imagenet "
            "pretrained resnets."
        )
    if __C.TPU.TEST_ROIS_PER_IM < 0:
        __C.TPU.TEST_ROIS_PER_IM = __C.TEST.RPN_POST_NMS_TOP_N
    if make_immutable:
        cfg.immutable(True)
    _assert_inferred = True


def reset_cfg():
    """Reset the global cfg to defaults (test helper; not in the reference)."""
    global _assert_inferred
    cfg.immutable(False)
    defaults = _build_defaults()
    for k in list(cfg.keys()):
        del cfg[k]
    for k, v in defaults.items():
        cfg[k] = v
    _assert_inferred = False


_DEFAULT_SNAPSHOT = None


def _build_defaults():
    global _DEFAULT_SNAPSHOT
    if _DEFAULT_SNAPSHOT is None:
        # Deep-copy the pristine tree at first use (module import time state).
        _DEFAULT_SNAPSHOT = copy.deepcopy(dict(__C))
    return copy.deepcopy(_DEFAULT_SNAPSHOT)


# Snapshot the defaults at import time, before any merge can mutate them.
_build_defaults()
