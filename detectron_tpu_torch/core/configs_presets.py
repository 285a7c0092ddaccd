"""Programmatic config presets for benchmarks and harness entry points
(equivalent to loading the corresponding configs/baselines yaml); a copy of
detectron_tpu/core/configs_presets.py merging into the port's own cfg, plus
the Keypoint R-CNN and R-50-C4 presets."""

from detectron_tpu_torch.core import config


def mask_rcnn_r50_fpn(num_classes=81, train_scale=800, max_size=1333):
    config.merge_cfg_from_list([
        "MODEL.TYPE", "generalized_rcnn",
        "MODEL.CONV_BODY", "FPN.fpn_ResNet50_conv5_body",
        "MODEL.FASTER_RCNN", "True",
        "MODEL.MASK_ON", "True",
        "MODEL.NUM_CLASSES", str(num_classes),
        "FPN.FPN_ON", "True",
        "FPN.MULTILEVEL_ROIS", "True",
        "FPN.MULTILEVEL_RPN", "True",
        "FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_2mlp_head",
        "FAST_RCNN.ROI_XFORM_METHOD", "RoIAlign",
        "FAST_RCNN.ROI_XFORM_RESOLUTION", "7",
        "FAST_RCNN.ROI_XFORM_SAMPLING_RATIO", "2",
        "MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs",
        "MRCNN.RESOLUTION", "28",
        "MRCNN.ROI_XFORM_METHOD", "RoIAlign",
        "MRCNN.ROI_XFORM_RESOLUTION", "14",
        "MRCNN.ROI_XFORM_SAMPLING_RATIO", "2",
        "MRCNN.DILATION", "1",
        "MRCNN.CONV_INIT", "MSRAFill",
        "TRAIN.SCALES", "({},)".format(train_scale),
        "TRAIN.MAX_SIZE", str(max_size),
        "TRAIN.IMS_PER_BATCH", "2",
        "TRAIN.BATCH_SIZE_PER_IM", "512",
        "TRAIN.RPN_PRE_NMS_TOP_N", "2000",
        "TRAIN.RPN_POST_NMS_TOP_N", "2000",
        "TEST.SCALE", str(train_scale),
        "TEST.MAX_SIZE", str(max_size),
        "TEST.NMS", "0.5",
        "TEST.RPN_PRE_NMS_TOP_N", "1000",
        "TEST.RPN_POST_NMS_TOP_N", "1000",
        "SOLVER.BASE_LR", "0.02",
        "SOLVER.LR_POLICY", "steps_with_decay",
        "SOLVER.GAMMA", "0.1",
        "SOLVER.MAX_ITER", "90000",
        "SOLVER.STEPS", "[0, 60000, 80000]",
        "SOLVER.WEIGHT_DECAY", "0.0001",
        "SOLVER.WARM_UP_ITERS", "500",
        "NUM_GPUS", "8",
    ])


def keypoint_rcnn_r50_fpn_keys(train_scale=800, max_size=1333):
    """The cfg keys of Detectron's e2e_keypoint_rcnn_R-50-FPN_1x.yaml, as a
    list for merge_cfg_from_list (tests merge it into both packages' cfgs).

    KRCNN.ROI_XFORM_RESOLUTION is Detectron's published 14, not the 7 of
    configs/baselines/e2e_keypoint_rcnn_R-50-FPN_1x.yaml: with 7 the head
    puts out 28 x 28 heatmaps while the targets are binned on
    HEATMAP_SIZE 56, which no loss can take (the port's train graph
    raises; the JAX package's loss goes NaN). TRAIN.SCALES is one scale,
    as in mask_rcnn_r50_fpn (the yaml samples 640-800)."""
    return [
        "MODEL.TYPE", "generalized_rcnn",
        "MODEL.CONV_BODY", "FPN.fpn_ResNet50_conv5_body",
        "MODEL.FASTER_RCNN", "True",
        "MODEL.MASK_ON", "False",
        "MODEL.KEYPOINTS_ON", "True",
        "MODEL.NUM_CLASSES", "2",
        "FPN.FPN_ON", "True",
        "FPN.MULTILEVEL_ROIS", "True",
        "FPN.MULTILEVEL_RPN", "True",
        "FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_2mlp_head",
        "FAST_RCNN.ROI_XFORM_METHOD", "RoIAlign",
        "FAST_RCNN.ROI_XFORM_RESOLUTION", "7",
        "FAST_RCNN.ROI_XFORM_SAMPLING_RATIO", "2",
        "KRCNN.ROI_KEYPOINTS_HEAD", "keypoint_rcnn_heads.roi_pose_head_v1convX",
        "KRCNN.NUM_STACKED_CONVS", "8",
        "KRCNN.NUM_KEYPOINTS", "17",
        "KRCNN.USE_DECONV_OUTPUT", "True",
        "KRCNN.CONV_INIT", "MSRAFill",
        "KRCNN.CONV_HEAD_DIM", "512",
        "KRCNN.UP_SCALE", "2",
        "KRCNN.HEATMAP_SIZE", "56",
        "KRCNN.ROI_XFORM_METHOD", "RoIAlign",
        "KRCNN.ROI_XFORM_RESOLUTION", "14",
        "KRCNN.ROI_XFORM_SAMPLING_RATIO", "2",
        "KRCNN.KEYPOINT_CONFIDENCE", "bbox",
        "TRAIN.SCALES", "({},)".format(train_scale),
        "TRAIN.MAX_SIZE", str(max_size),
        "TRAIN.IMS_PER_BATCH", "2",
        "TRAIN.BATCH_SIZE_PER_IM", "512",
        "TRAIN.RPN_PRE_NMS_TOP_N", "2000",
        "TEST.SCALE", str(train_scale),
        "TEST.MAX_SIZE", str(max_size),
        "TEST.NMS", "0.5",
        "TEST.RPN_PRE_NMS_TOP_N", "1000",
        "TEST.RPN_POST_NMS_TOP_N", "1000",
        "SOLVER.BASE_LR", "0.02",
        "SOLVER.LR_POLICY", "steps_with_decay",
        "SOLVER.GAMMA", "0.1",
        "SOLVER.MAX_ITER", "90000",
        "SOLVER.STEPS", "[0, 60000, 80000]",
        "SOLVER.WEIGHT_DECAY", "0.0001",
        "NUM_GPUS", "8",
    ]


def keypoint_rcnn_r50_fpn(train_scale=800, max_size=1333):
    config.merge_cfg_from_list(keypoint_rcnn_r50_fpn_keys(train_scale,
                                                          max_size))


def mask_rcnn_r50_c4_keys(mask_on=True):
    """The cfg keys of Detectron's e2e_mask_rcnn_R-50-C4_1x.yaml
    (configs/baselines/e2e_mask_rcnn_R-50-C4_1x.yaml), as a list for
    merge_cfg_from_list; with mask_on False, e2e_faster_rcnn_R-50-C4_1x's
    (the same model without the mask branch). Merged onto a fresh cfg they
    give what loading the yaml gives; the keys that the yaml leaves at
    their defaults but the FPN presets set (FPN on, the sampling ratios,
    the RPN top-n, the warm-up, ...) are listed with their default values,
    so the list also turns an FPN preset into the C4 model. The ResNet50
    conv4 body (res2-res4, stride 16) feeds a single-level RPN of
    len(RPN.SIZES) x len(RPN.ASPECT_RATIOS) anchors per cell and, through
    RoIAlign 14 x 14 at the adaptive sampling ratio 0, the res5 RoI head;
    the mask head shares that res5 (v0upshare) and puts out 14 x 14
    masks."""
    keys = [
        "MODEL.TYPE", "generalized_rcnn",
        "MODEL.CONV_BODY", "ResNet.ResNet50_conv4_body",
        "MODEL.FASTER_RCNN", "True",
        "MODEL.MASK_ON", str(bool(mask_on)),
        "MODEL.NUM_CLASSES", "81",
        "NUM_GPUS", "8",
        "FPN.FPN_ON", "False",
        "FPN.MULTILEVEL_ROIS", "False",
        "FPN.MULTILEVEL_RPN", "False",
        "SOLVER.WEIGHT_DECAY", "0.0001",
        "SOLVER.LR_POLICY", "steps_with_decay",
        "SOLVER.BASE_LR", "0.01",
        "SOLVER.GAMMA", "0.1",
        "SOLVER.MAX_ITER", "180000",
        "SOLVER.STEPS", "[0, 120000, 160000]",
        "SOLVER.WARM_UP_ITERS", "500",
        "RESNETS.IMAGENET_PRETRAINED_WEIGHTS",
        "data/pretrained_model/R-50.pkl",
        "FAST_RCNN.ROI_BOX_HEAD", "ResNet.ResNet_roi_conv5_head",
        "FAST_RCNN.ROI_XFORM_METHOD", "RoIAlign",
        "FAST_RCNN.ROI_XFORM_RESOLUTION", "14",
        "FAST_RCNN.ROI_XFORM_SAMPLING_RATIO", "0",
        "TRAIN.SCALES", "(800,)",
        "TRAIN.MAX_SIZE", "1333",
        "TRAIN.IMS_PER_BATCH", "1",
        "TRAIN.BATCH_SIZE_PER_IM", "512",
        "TRAIN.RPN_PRE_NMS_TOP_N", "12000",
        "TRAIN.RPN_POST_NMS_TOP_N", "2000",
        "TEST.SCALE", "800",
        "TEST.MAX_SIZE", "1333",
        "TEST.NMS", "0.5",
        "TEST.RPN_PRE_NMS_TOP_N", "6000",
        "TEST.RPN_POST_NMS_TOP_N", "1000",
    ]
    if mask_on:
        keys += [
            "MRCNN.ROI_MASK_HEAD",
            "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare",
            "MRCNN.RESOLUTION", "14",
            "MRCNN.ROI_XFORM_METHOD", "RoIAlign",
            "MRCNN.ROI_XFORM_RESOLUTION", "14",
            "MRCNN.ROI_XFORM_SAMPLING_RATIO", "0",
            "MRCNN.DILATION", "1",
            "MRCNN.CONV_INIT", "MSRAFill",
        ]
    return keys


def mask_rcnn_r50_c4():
    config.merge_cfg_from_list(mask_rcnn_r50_c4_keys())


def faster_rcnn_r50_c4():
    config.merge_cfg_from_list(mask_rcnn_r50_c4_keys(mask_on=False))
