"""Numpy weight init: the R-50-FPN Mask / Keypoint R-CNN params tree
without JAX.

Same fills as detectron_tpu/models/init.py (Caffe2 fan semantics on HWIO
conv kernels and (in, out) dense kernels):

- XavierFill: uniform(-s, s), s = sqrt(3 / fan_in)
- MSRAFill:   normal(0, sqrt(2 / fan_out))
- GaussianFill(std): normal(0, std)
- AffineChannel: s = 1, b = 0; biases 0

init_model(seed) builds the tree with the same keys and shapes as
detectron_tpu.models.model_builder.init_model, in the JAX layout (HWIO conv
kernels, flipped deconv kernels, Caffe2 (C, P, P) fc6 rows); the values come
from a numpy RandomState, not JAX's random bits. models/bridge.py turns the
tree into torch tensors. bilinear_upsample_kernel is the keypoint head's
frozen upsampling kernel, a constant of the graph, not a param.
"""

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import resnet

_NOT_PORTED = "not ported yet (ROADMAP Queue A, A7): "
# The one keypoint head the port runs ("" selects it too, as in the JAX
# package's model_builder.py:107-109).
POSE_HEAD = "keypoint_rcnn_heads.roi_pose_head_v1convX"


def _fans(shape):
    if len(shape) == 4:
        kh, kw, in_c, out_c = shape
        return in_c * kh * kw, out_c * kh * kw
    if len(shape) == 2:
        return shape[0], shape[1]
    raise ValueError("Unsupported kernel shape {}".format(shape))


def xavier_fill(rng, shape):
    scale = np.sqrt(3.0 / _fans(shape)[0])
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def msra_fill(rng, shape):
    std = np.sqrt(2.0 / _fans(shape)[1])
    return (std * rng.standard_normal(shape)).astype(np.float32)


def gaussian_fill(rng, shape, std):
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _fill(rng, shape, weight_init, std=0.01):
    if weight_init == "MSRAFill":
        return msra_fill(rng, shape)
    if weight_init == "XavierFill":
        return xavier_fill(rng, shape)
    if weight_init == "GaussianFill":
        return gaussian_fill(rng, shape, std)
    raise ValueError(weight_init)


def init_conv(rng, kh, kw, in_c, out_c, weight_init="MSRAFill", bias=True,
              std=0.01):
    p = {"w": _fill(rng, (kh, kw, in_c, out_c), weight_init, std)}
    if bias:
        p["b"] = np.zeros((out_c,), np.float32)
    return p


def init_fc(rng, in_dim, out_dim, weight_init="XavierFill", std=0.01):
    return {"w": _fill(rng, (in_dim, out_dim), weight_init, std),
            "b": np.zeros((out_dim,), np.float32)}


def init_affine(channels):
    return {"s": np.ones((channels,), np.float32),
            "b": np.zeros((channels,), np.float32)}


def _init_bottleneck(rng, in_c, out_c, inner_c, has_shortcut):
    p = {
        "branch2a": init_conv(rng, 1, 1, in_c, inner_c, bias=False),
        "branch2a_bn": init_affine(inner_c),
        "branch2b": init_conv(rng, 3, 3, inner_c, inner_c, bias=False),
        "branch2b_bn": init_affine(inner_c),
        "branch2c": init_conv(rng, 1, 1, inner_c, out_c, bias=False),
        "branch2c_bn": init_affine(out_c),
    }
    if has_shortcut:
        p["branch1"] = init_conv(rng, 1, 1, in_c, out_c, bias=False)
        p["branch1_bn"] = init_affine(out_c)
    return p


def init_body(rng, depth, num_stages):
    counts = resnet.BLOCK_COUNTS[depth]
    inner = [64 * 2 ** i for i in range(4)]
    outer = [256 * 2 ** i for i in range(4)]
    p = {"conv1": init_conv(rng, 7, 7, 3, 64, bias=False),
         "res_conv1_bn": init_affine(64)}
    in_c = 64
    for s in range(num_stages):
        p["res{}".format(s + 2)] = [
            _init_bottleneck(rng, in_c if i == 0 else outer[s], outer[s],
                             inner[s], has_shortcut=(i == 0))
            for i in range(counts[s])]
        in_c = outer[s]
    return p


def init_fpn(rng):
    dims = [256, 512, 1024, 2048]
    p = {}
    for i, d in enumerate(dims):
        lvl = i + 2
        p["fpn_inner_res{}".format(lvl)] = init_conv(
            rng, 1, 1, d, cfg.FPN.DIM, weight_init="XavierFill")
        p["fpn_res{}".format(lvl)] = init_conv(
            rng, 3, 3, cfg.FPN.DIM, cfg.FPN.DIM, weight_init="XavierFill")
    return p


def init_rpn(rng, dim_in):
    A = len(cfg.FPN.RPN_ASPECT_RATIOS)
    return {
        "conv_rpn": init_conv(rng, 3, 3, dim_in, dim_in,
                              weight_init="GaussianFill", std=0.01),
        "rpn_cls_logits": init_conv(rng, 1, 1, dim_in, A,
                                    weight_init="GaussianFill", std=0.01),
        "rpn_bbox_pred": init_conv(rng, 1, 1, dim_in, 4 * A,
                                   weight_init="GaussianFill", std=0.01),
    }


def init_model(seed):
    """The R-50-FPN Mask / Keypoint R-CNN params tree for the current cfg,
    from a
    numpy RandomState(seed). Raises NotImplementedError for any model the
    port does not run yet."""
    resnet.check_body_supported()
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    if not (cfg.FPN.FPN_ON and cfg.FPN.MULTILEVEL_RPN):
        raise NotImplementedError(_NOT_PORTED + "bodies other than FPN with "
                                  "a multilevel RPN")
    if cfg.FPN.USE_GN or cfg.FPN.EXTRA_CONV_LEVELS or \
            cfg.FPN.ZERO_INIT_LATERAL:
        raise NotImplementedError(_NOT_PORTED + "FPN GN / extra conv levels"
                                  " / zero-init laterals")
    if cfg.FAST_RCNN.ROI_BOX_HEAD != "fast_rcnn_heads.roi_2mlp_head":
        raise NotImplementedError(_NOT_PORTED + cfg.FAST_RCNN.ROI_BOX_HEAD)
    if cfg.MODEL.KEYPOINTS_ON and cfg.KRCNN.ROI_KEYPOINTS_HEAD not in (
            "", POSE_HEAD):
        raise NotImplementedError(_NOT_PORTED + cfg.KRCNN.ROI_KEYPOINTS_HEAD)

    rng = np.random.RandomState(seed)
    params = {"body": init_body(rng, depth, num_stages),
              "fpn": init_fpn(rng)}
    if cfg.RPN.RPN_ON:  # off in Fast R-CNN mode (precomputed proposals)
        params["rpn"] = init_rpn(rng, cfg.FPN.DIM)
    res = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
    hidden = cfg.FAST_RCNN.MLP_HEAD_DIM
    params["box_head"] = {
        "fc6": init_fc(rng, cfg.FPN.DIM * res * res, hidden),
        "fc7": init_fc(rng, hidden, hidden)}
    n_cls = cfg.MODEL.NUM_CLASSES
    n_reg = 2 if cfg.MODEL.CLS_AGNOSTIC_BBOX_REG else n_cls
    params["box_outs"] = {
        "cls_score": init_fc(rng, hidden, n_cls, "GaussianFill", 0.01),
        "bbox_pred": init_fc(rng, hidden, 4 * n_reg, "GaussianFill", 0.001)}

    if cfg.MODEL.MASK_ON:
        head = cfg.MRCNN.ROI_MASK_HEAD
        if head != "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs":
            raise NotImplementedError(_NOT_PORTED + head)
        if cfg.MRCNN.USE_FC_OUTPUT:
            raise NotImplementedError(_NOT_PORTED + "MRCNN.USE_FC_OUTPUT")
        init = cfg.MRCNN.CONV_INIT
        dim = cfg.MRCNN.DIM_REDUCED
        d = cfg.FPN.DIM
        convs = []
        for _ in range(4):
            convs.append(init_conv(rng, 3, 3, d, dim, weight_init=init))
            d = dim
        params["mask_head"] = {
            "convs": convs,
            "deconv": init_conv(rng, 2, 2, d, dim, weight_init=init)}
        n_mask = n_cls if cfg.MRCNN.CLS_SPECIFIC_MASK else 1
        params["mask_outs"] = {"mask_fcn_logits": init_conv(
            rng, 1, 1, dim, n_mask, weight_init=init, std=0.001)}

    if cfg.MODEL.KEYPOINTS_ON:
        params["kps_head"], params["kps_outs"] = init_keypoint_heads(rng)
    return params


def init_keypoint_heads(rng):
    """roi_pose_head_v1convX and the keypoint outputs
    (detectron_tpu/models/keypoint_rcnn_heads.py:17-58): NUM_STACKED_CONVS
    kernel x kernel convs of CONV_HEAD_DIM, then with KRCNN.USE_DECONV a
    DECONV_KERNEL deconv to DECONV_DIM, and kps_score (a DECONV_KERNEL
    deconv with USE_DECONV_OUTPUT, else a 1x1 conv) to NUM_KEYPOINTS.
    CONV_INIT fills with std 0.01 (0.001 for kps_score), zero biases."""
    init = cfg.KRCNN.CONV_INIT
    k = cfg.KRCNN.CONV_HEAD_KERNEL
    dim = cfg.KRCNN.CONV_HEAD_DIM
    d = cfg.FPN.DIM
    convs = []
    for _ in range(cfg.KRCNN.NUM_STACKED_CONVS):
        convs.append(init_conv(rng, k, k, d, dim, weight_init=init))
        d = dim
    outs = {}
    kd = cfg.KRCNN.DECONV_KERNEL
    if cfg.KRCNN.USE_DECONV:
        outs["kps_deconv"] = init_conv(rng, kd, kd, d, cfg.KRCNN.DECONV_DIM,
                                       weight_init=init)
        d = cfg.KRCNN.DECONV_DIM
    ks = kd if cfg.KRCNN.USE_DECONV_OUTPUT else 1
    outs["kps_score"] = init_conv(rng, ks, ks, d, cfg.KRCNN.NUM_KEYPOINTS,
                                  weight_init=init, std=0.001)
    return {"convs": convs}, outs


def bilinear_upsample_kernel(factor, channels):
    """The frozen bilinear kernel (k, k, 1, channels), k = 2 * factor -
    factor % 2, of the keypoint head's x factor upsampling (JAX
    models/init.py:56-67; the reference's BilinearInterpolation2d)."""
    k = 2 * factor - factor % 2
    center = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    og = np.ogrid[:k, :k]
    filt = (1 - abs(og[0] / factor - center)) * \
        (1 - abs(og[1] / factor - center))
    return np.repeat(filt.astype(np.float32)[:, :, None, None], channels, 3)
