"""Programmatic config presets for benchmarks and harness entry points
(equivalent to loading the corresponding configs/baselines yaml); a copy of
detectron_tpu/core/configs_presets.py merging into the port's own cfg."""

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
