"""Numpy weight init: the Mask / Faster / Keypoint R-CNN params tree
(ResNet-50/101/152 and ResNeXt FPN bodies, R-50-C4 with its res5 RoI
head, AffineChannel or GroupNorm, the 2-MLP and Xconv1fc(_gn) box heads,
the v1up4convs(_gn) and v0up mask heads) without JAX.

Same fills as detectron_tpu/models/init.py (Caffe2 fan semantics on HWIO
conv kernels and (in, out) dense kernels):

- XavierFill: uniform(-s, s), s = sqrt(3 / fan_in)
- MSRAFill:   normal(0, sqrt(2 / fan_out))
- GaussianFill(std): normal(0, std)
- AffineChannel and GroupNorm: s = 1, b = 0; biases 0
- a grouped conv kernel is HWIO (kh, kw, in_c / groups, out_c), its fans
  taken from that shape, as the JAX package's L.init_conv(groups=...)

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
from detectron_tpu_torch.models import rpn as rpn_mod

_NOT_PORTED = "not ported yet (ROADMAP Queue A, A7): "
# The one keypoint head the port runs ("" selects it too, as in the JAX
# package's model_builder.py:107-109).
POSE_HEAD = "keypoint_rcnn_heads.roi_pose_head_v1convX"
# The box heads: the 2-MLP head of an FPN model, and the res5 head of a C4
# model ("" selects it, as in the JAX package's model_builder.py:83-84).
MLP_HEAD = "fast_rcnn_heads.roi_2mlp_head"
C4_HEAD = "ResNet.ResNet_roi_conv5_head"
# NUM_STACKED_CONVS 3x3 convs, then fc6: without and with GroupNorm.
XCONV_HEADS = ("fast_rcnn_heads.roi_Xconv1fc_head",
               "fast_rcnn_heads.roi_Xconv1fc_gn_head")
# The mask heads: four 3x3 convs and a deconv on the RoI features, or a
# deconv on res5 of the RoI features, res5 shared with the C4 box head
# (v0upshare) or its own (v0up).
MASK_HEAD_V1UP4CONVS = "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs"
MASK_HEAD_V1UP4CONVS_GN = MASK_HEAD_V1UP4CONVS + "_gn"
MASK_HEADS_V0UP = ("mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare",
                   "mask_rcnn_heads.mask_rcnn_fcn_head_v0up")


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
              std=0.01, groups=1):
    p = {"w": _fill(rng, (kh, kw, in_c // groups, out_c), weight_init, std)}
    if bias:
        p["b"] = np.zeros((out_c,), np.float32)
    return p


def init_fc(rng, in_dim, out_dim, weight_init="XavierFill", std=0.01):
    return {"w": _fill(rng, (in_dim, out_dim), weight_init, std),
            "b": np.zeros((out_dim,), np.float32)}


def init_affine(channels):
    return {"s": np.ones((channels,), np.float32),
            "b": np.zeros((channels,), np.float32)}


def _init_bottleneck(rng, in_c, out_c, inner_c, has_shortcut, groups):
    """A bottleneck's params; the `*_bn` norms are AffineChannel or, with
    RESNETS.USE_GN, GroupNorm (the same s = 1, b = 0)."""
    p = {
        "branch2a": init_conv(rng, 1, 1, in_c, inner_c, bias=False),
        "branch2a_bn": init_affine(inner_c),
        "branch2b": init_conv(rng, 3, 3, inner_c, inner_c, bias=False,
                              groups=groups),
        "branch2b_bn": init_affine(inner_c),
        "branch2c": init_conv(rng, 1, 1, inner_c, out_c, bias=False),
        "branch2c_bn": init_affine(out_c),
    }
    if has_shortcut:
        p["branch1"] = init_conv(rng, 1, 1, in_c, out_c, bias=False)
        p["branch1_bn"] = init_affine(out_c)
    return p


def init_body(rng, depth, num_stages):
    """The stem and num_stages stages of a ResNet-{depth} body on the
    channel plan of resnet.inner_dims (ResNeXt's grouped 3x3 convs)."""
    counts = resnet.BLOCK_COUNTS[depth]
    inner, outer, groups = resnet.inner_dims()
    p = {"conv1": init_conv(rng, 7, 7, 3, 64, bias=False),
         "res_conv1_bn": init_affine(64)}
    in_c = 64
    for s in range(num_stages):
        p["res{}".format(s + 2)] = [
            _init_bottleneck(rng, in_c if i == 0 else outer[s], outer[s],
                             inner[s], (i == 0), groups)
            for i in range(counts[s])]
        in_c = outer[s]
    return p


def init_fpn(rng):
    """Laterals and posthoc convs; with FPN.USE_GN they lose their bias and
    each gains a GroupNorm, `<conv>_gn` (JAX fpn.py:42-63)."""
    dims = [256, 512, 1024, 2048]
    use_gn = cfg.FPN.USE_GN
    p = {}
    for i, d in enumerate(dims):
        lvl = i + 2
        for name, k, c_in in (("fpn_inner_res{}", 1, d),
                              ("fpn_res{}", 3, cfg.FPN.DIM)):
            name = name.format(lvl)
            p[name] = init_conv(rng, k, k, c_in, cfg.FPN.DIM,
                                weight_init="XavierFill", bias=not use_gn)
            if use_gn:
                p[name + "_gn"] = init_affine(cfg.FPN.DIM)
    return p


def init_rpn(rng, dim_in):
    """The RPN head (JAX rpn.init_single_scale_rpn, rpn.py:39-51, which the
    FPN's shared head reuses)."""
    A = rpn_mod.num_cell_anchors()
    dim_out = dim_in if cfg.RPN.OUT_DIM_AS_IN_DIM else cfg.RPN.OUT_DIM
    return {
        "conv_rpn": init_conv(rng, 3, 3, dim_in, dim_out,
                              weight_init="GaussianFill", std=0.01),
        "rpn_cls_logits": init_conv(rng, 1, 1, dim_out, A,
                                    weight_init="GaussianFill", std=0.01),
        "rpn_bbox_pred": init_conv(rng, 1, 1, dim_out, 4 * A,
                                   weight_init="GaussianFill", std=0.01),
    }


def init_res5_head(rng, in_c=1024):
    """res5 of the C4 RoI head (JAX resnet.init_roi_conv5_head,
    resnet.py:307-310): three bottlenecks, in_c -> 2048, inner 512 x
    NUM_GROUPS x WIDTH_PER_GROUP / 64."""
    n = resnet.BLOCK_COUNTS[50][3]
    inner, outer, groups = resnet.inner_dims()
    return [_init_bottleneck(rng, in_c if i == 0 else outer[3], outer[3],
                             inner[3], (i == 0), groups) for i in range(n)]


def roi_feat_dim():
    """Channels of the RoI features: the FPN's, or res4's for a C4
    model."""
    return cfg.FPN.DIM if cfg.FPN.FPN_ON else 1024


def check_model_supported():
    """Raise NotImplementedError, naming what is missing, for a model the
    port does not run yet."""
    resnet.check_body_supported()
    _, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    if cfg.FPN.FPN_ON:
        if not cfg.FPN.MULTILEVEL_RPN or num_stages != 4:
            raise NotImplementedError(
                _NOT_PORTED + "an FPN on a conv4 body or with a "
                "single-level RPN")
        if cfg.FPN.EXTRA_CONV_LEVELS or cfg.FPN.ZERO_INIT_LATERAL:
            raise NotImplementedError(_NOT_PORTED + "FPN extra conv levels "
                                      "/ zero-init laterals (A7.4)")
        box_heads = (MLP_HEAD,) + XCONV_HEADS
    else:
        if num_stages != 3:
            raise NotImplementedError(
                _NOT_PORTED + "a conv5 body without an FPN (res5 dilation "
                "and the other single-level bodies)")
        box_heads = ("", C4_HEAD)
    if cfg.FAST_RCNN.ROI_BOX_HEAD not in box_heads:
        raise NotImplementedError(
            _NOT_PORTED + "box head {!r} on an {} body (the dotted-name "
            "registry, A7.3)".format(
                cfg.FAST_RCNN.ROI_BOX_HEAD,
                "FPN" if cfg.FPN.FPN_ON else "C4"))
    if cfg.MODEL.MASK_ON:
        head = cfg.MRCNN.ROI_MASK_HEAD
        if head not in (MASK_HEAD_V1UP4CONVS, MASK_HEAD_V1UP4CONVS_GN) + \
                MASK_HEADS_V0UP:
            raise NotImplementedError(
                _NOT_PORTED + "mask head {!r} (v1up, the dotted-name "
                "registry)".format(head))
        if head == MASK_HEADS_V0UP[0] and cfg.FPN.FPN_ON:
            raise ValueError(head + " shares the res5 of the C4 box head, "
                             "which an FPN model does not have")
        if cfg.MRCNN.USE_FC_OUTPUT:
            raise NotImplementedError(_NOT_PORTED + "MRCNN.USE_FC_OUTPUT")
    if cfg.MODEL.KEYPOINTS_ON and cfg.KRCNN.ROI_KEYPOINTS_HEAD not in (
            "", POSE_HEAD):
        raise NotImplementedError(_NOT_PORTED + cfg.KRCNN.ROI_KEYPOINTS_HEAD)


def init_model(seed):
    """The params tree for the current cfg (ResNet / ResNeXt FPN bodies or
    R-50-C4; Mask, Faster or Keypoint R-CNN), from a numpy
    RandomState(seed). Raises NotImplementedError for any model the port
    does not run yet."""
    check_model_supported()
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    rng = np.random.RandomState(seed)
    params = {"body": init_body(rng, depth, num_stages)}
    if cfg.FPN.FPN_ON:
        params["fpn"] = init_fpn(rng)
    d = roi_feat_dim()
    if cfg.RPN.RPN_ON:  # off in Fast R-CNN mode (precomputed proposals)
        params["rpn"] = init_rpn(rng, d)
    if cfg.FPN.FPN_ON:
        res = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
        hidden = cfg.FAST_RCNN.MLP_HEAD_DIM
        if cfg.FAST_RCNN.ROI_BOX_HEAD in XCONV_HEADS:
            params["box_head"] = init_xconv1fc_head(rng, d, res, hidden)
        else:
            params["box_head"] = {
                "fc6": init_fc(rng, d * res * res, hidden),
                "fc7": init_fc(rng, hidden, hidden)}
    else:
        hidden = 2048
        params["box_head"] = {"res5": init_res5_head(rng, d)}
    n_cls = cfg.MODEL.NUM_CLASSES
    n_reg = 2 if cfg.MODEL.CLS_AGNOSTIC_BBOX_REG else n_cls
    params["box_outs"] = {
        "cls_score": init_fc(rng, hidden, n_cls, "GaussianFill", 0.01),
        "bbox_pred": init_fc(rng, hidden, 4 * n_reg, "GaussianFill", 0.001)}

    if cfg.MODEL.MASK_ON:
        init = cfg.MRCNN.CONV_INIT
        dim = cfg.MRCNN.DIM_REDUCED
        if cfg.MRCNN.ROI_MASK_HEAD in MASK_HEADS_V0UP:
            params["mask_head"] = {
                "deconv": init_conv(rng, 2, 2, 2048, dim, weight_init=init)}
            if cfg.MRCNN.ROI_MASK_HEAD == MASK_HEADS_V0UP[1]:
                params["mask_head"]["res5"] = init_res5_head(rng, d)
        else:
            params["mask_head"] = _init_conv_stack(
                rng, 4, d, dim, init,
                cfg.MRCNN.ROI_MASK_HEAD == MASK_HEAD_V1UP4CONVS_GN)
            params["mask_head"]["deconv"] = init_conv(rng, 2, 2, dim, dim,
                                                      weight_init=init)
        n_mask = n_cls if cfg.MRCNN.CLS_SPECIFIC_MASK else 1
        params["mask_outs"] = {"mask_fcn_logits": init_conv(
            rng, 1, 1, dim, n_mask, weight_init=init, std=0.001)}

    if cfg.MODEL.KEYPOINTS_ON:
        params["kps_head"], params["kps_outs"] = init_keypoint_heads(rng)
    return params


def _init_conv_stack(rng, n, dim_in, dim, weight_init, use_gn):
    """n 3x3 convs of `dim` channels ("convs"), without bias and each with a
    GroupNorm ("gns") under `use_gn`."""
    p = {"convs": [], "gns": []}
    for _ in range(n):
        p["convs"].append(init_conv(rng, 3, 3, dim_in, dim,
                                    weight_init=weight_init,
                                    bias=not use_gn))
        if use_gn:
            p["gns"].append(init_affine(dim))
        dim_in = dim
    if not use_gn:
        del p["gns"]
    return p


def init_xconv1fc_head(rng, dim_in, res, hidden):
    """roi_Xconv1fc_head / roi_Xconv1fc_gn_head (JAX fast_rcnn_heads.py:
    63-80): FAST_RCNN.NUM_STACKED_CONVS MSRAFill 3x3 convs of
    CONV_HEAD_DIM, then fc6 over their (C, P, P) output to `hidden`."""
    dim = cfg.FAST_RCNN.CONV_HEAD_DIM
    p = _init_conv_stack(rng, cfg.FAST_RCNN.NUM_STACKED_CONVS, dim_in, dim,
                         "MSRAFill",
                         cfg.FAST_RCNN.ROI_BOX_HEAD == XCONV_HEADS[1])
    p["fc6"] = init_fc(rng, dim * res * res, hidden)
    return p


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
    d = roi_feat_dim()
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
