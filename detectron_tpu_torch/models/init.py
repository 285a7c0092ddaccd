"""Numpy weight init: the Mask / Faster / Keypoint R-CNN params tree
(ResNet-50/101/152 and ResNeXt bodies, FPN or C4, AffineChannel or
GroupNorm, every head of models/registry.py) without JAX.

Same fills as detectron_tpu/models/init.py (Caffe2 fan semantics on HWIO
conv kernels and (in, out) dense kernels):

- XavierFill: uniform(-s, s), s = sqrt(3 / fan_in)
- MSRAFill:   normal(0, sqrt(2 / fan_out))
- GaussianFill(std): normal(0, std)
- Zero: zeros (FPN.ZERO_INIT_LATERAL's laterals)
- AffineChannel and GroupNorm: s = 1, b = 0; biases 0
- a grouped conv kernel is HWIO (kh, kw, in_c / groups, out_c), its fans
  taken from that shape, as the JAX package's L.init_conv(groups=...)

init_model(seed) builds the tree with the same keys and shapes as
detectron_tpu.models.model_builder.init_model, in the JAX layout (HWIO conv
kernels, flipped deconv kernels, Caffe2 (C, P, P) fc6 rows); the values come
from a numpy RandomState, not JAX's random bits. The box, mask and keypoint
heads come from their cfg names through models/registry.py, as in the JAX
package (model_builder.py:66-113). models/bridge.py turns the tree into
torch tensors. bilinear_upsample_kernel is the keypoint head's frozen
upsampling kernel, a constant of the graph, not a param.
"""

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import registry
from detectron_tpu_torch.models import resnet
from detectron_tpu_torch.models import rpn as rpn_mod

# The message of a cfg the JAX package cannot run either (ROADMAP, "not a
# feature of the reference").
NOT_IN_REFERENCE = ("not a feature of the reference: the JAX package "
                    "cannot run this cfg either: ")


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
    if weight_init == "Zero":
        return np.zeros(shape, np.float32)
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
    each gains a GroupNorm, `<conv>_gn` (JAX fpn.py:42-63). With
    FPN.ZERO_INIT_LATERAL the laterals below res5 start at zero; with
    FPN.EXTRA_CONV_LEVELS, fpn_6 (a 3x3 conv on res5) and one more conv a
    level up to RPN_MAX_LEVEL (JAX fpn.py:60-66)."""
    dims = [256, 512, 1024, 2048]
    use_gn = cfg.FPN.USE_GN
    p = {}
    for i, d in enumerate(dims):
        lvl = i + 2
        lateral = "Zero" if cfg.FPN.ZERO_INIT_LATERAL and lvl != 5 \
            else "XavierFill"
        for name, k, c_in, fill in (("fpn_inner_res{}", 1, d, lateral),
                                    ("fpn_res{}", 3, cfg.FPN.DIM,
                                     "XavierFill")):
            name = name.format(lvl)
            p[name] = init_conv(rng, k, k, c_in, cfg.FPN.DIM,
                                weight_init=fill, bias=not use_gn)
            if use_gn:
                p[name + "_gn"] = init_affine(cfg.FPN.DIM)
    if cfg.FPN.EXTRA_CONV_LEVELS:
        in_d = dims[-1]
        for lvl in range(6, cfg.FPN.RPN_MAX_LEVEL + 1):
            p["fpn_{}".format(lvl)] = init_conv(rng, 3, 3, in_d, cfg.FPN.DIM,
                                                weight_init="XavierFill")
            in_d = cfg.FPN.DIM
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


def box_head_name():
    """FAST_RCNN.ROI_BOX_HEAD; "" selects the res5 head on a C4 body (JAX
    model_builder.py:88-89)."""
    if not cfg.FPN.FPN_ON:
        return cfg.FAST_RCNN.ROI_BOX_HEAD or registry.C4_HEAD
    return cfg.FAST_RCNN.ROI_BOX_HEAD


def mask_head_name():
    """MRCNN.ROI_MASK_HEAD; "" selects v1up4convs (JAX
    model_builder.py:98-100)."""
    return cfg.MRCNN.ROI_MASK_HEAD or registry.MASK_HEADS[0]


def keypoint_head_name():
    """KRCNN.ROI_KEYPOINTS_HEAD; "" selects roi_pose_head_v1convX."""
    return cfg.KRCNN.ROI_KEYPOINTS_HEAD or registry.POSE_HEAD


def _roi_methods():
    methods = [cfg.FAST_RCNN.ROI_XFORM_METHOD]
    if cfg.MODEL.MASK_ON:
        methods.append(cfg.MRCNN.ROI_XFORM_METHOD)
    if cfg.MODEL.KEYPOINTS_ON:
        methods.append(cfg.KRCNN.ROI_XFORM_METHOD)
    return methods


def check_model_supported():
    """Raise for a cfg the port does not run: NotImplementedError for a
    combination the JAX package cannot run either (ROADMAP lists them),
    ValueError for a head name no module resolves or an unknown RoI
    transform."""
    _, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    for method in _roi_methods():
        if method not in ("RoIAlign", "RoIPoolF", "RoICrop"):
            raise ValueError("Unknown ROI_XFORM_METHOD " + method)
    if cfg.FPN.FPN_ON:
        if not cfg.FPN.MULTILEVEL_RPN:
            raise NotImplementedError(
                NOT_IN_REFERENCE + "an FPN with FPN.MULTILEVEL_RPN False "
                "(its generate_proposals decodes every level with "
                "RPN.STRIDE's anchors, model_builder.py:172-186)")
        if "RoIPoolF" in _roi_methods():
            raise NotImplementedError(
                NOT_IN_REFERENCE + "RoIPoolF on an FPN (its "
                "roi_feature_transform asserts one feature map, "
                "model_builder.py:255)")
        if not box_head_name():
            raise ValueError("an FPN model needs FAST_RCNN.ROI_BOX_HEAD")
    else:
        if num_stages != 3:
            raise NotImplementedError(
                NOT_IN_REFERENCE + "a conv5 body without an FPN (its C4 "
                "path takes res5's 2048 channels as res4's 1024, "
                "model_builder.py:48-57)")
        if box_head_name() != registry.C4_HEAD:
            raise NotImplementedError(
                NOT_IN_REFERENCE + "box head {!r} on a C4 body (its "
                "init_model calls the head's init without roi_res, "
                "model_builder.py:86-90, and its C4 forward runs res5 "
                "whatever the name, :364-383)".format(box_head_name()))
    registry.get_func(box_head_name())
    if cfg.MODEL.MASK_ON:
        registry.get_func(mask_head_name())
        if mask_head_name().endswith("v0upshare") and cfg.FPN.FPN_ON:
            raise ValueError(mask_head_name() + " shares the res5 of the C4 "
                             "box head, which an FPN model does not have")
    if cfg.MODEL.KEYPOINTS_ON:
        registry.get_func(keypoint_head_name())


def init_model(seed):
    """The params tree for the current cfg from a numpy RandomState(seed);
    each head from its cfg name through the registry. Raises as
    check_model_supported does."""
    check_model_supported()
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    rng = np.random.RandomState(seed)
    params = {"body": init_body(rng, depth, num_stages)}
    if cfg.FPN.FPN_ON:
        params["fpn"] = init_fpn(rng)
    d = roi_feat_dim()
    if cfg.RPN.RPN_ON:  # off in Fast R-CNN mode (precomputed proposals)
        params["rpn"] = init_rpn(rng, d)
    box = registry.get_func(box_head_name())
    params["box_head"] = box.init(rng, d, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION)
    hidden = box.out_dim()
    n_cls = cfg.MODEL.NUM_CLASSES
    n_reg = 2 if cfg.MODEL.CLS_AGNOSTIC_BBOX_REG else n_cls
    params["box_outs"] = {
        "cls_score": init_fc(rng, hidden, n_cls, "GaussianFill", 0.01),
        "bbox_pred": init_fc(rng, hidden, 4 * n_reg, "GaussianFill", 0.001)}
    if cfg.MODEL.MASK_ON:
        mh = registry.get_func(mask_head_name())
        params["mask_head"] = mh.init(rng, d)
        params["mask_outs"] = init_mask_outputs(rng, mh.out_dim())
    if cfg.MODEL.KEYPOINTS_ON:
        kh = registry.get_func(keypoint_head_name())
        params["kps_head"] = kh.init(rng, d)
        params["kps_outs"] = init_keypoint_outputs(rng, kh.out_dim())
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


def init_roi_2mlp_head(rng, dim_in, roi_res):
    """roi_2mlp_head (JAX fast_rcnn_heads.py:15-22): fc6 over the (C, P, P)
    pooled block, fc7, both MLP_HEAD_DIM wide."""
    hidden = cfg.FAST_RCNN.MLP_HEAD_DIM
    return {"fc6": init_fc(rng, dim_in * roi_res * roi_res, hidden),
            "fc7": init_fc(rng, hidden, hidden)}


def init_xconv1fc_head(rng, dim_in, roi_res, use_gn):
    """roi_Xconv1fc_head / roi_Xconv1fc_gn_head (JAX fast_rcnn_heads.py:
    63-80): FAST_RCNN.NUM_STACKED_CONVS MSRAFill 3x3 convs of
    CONV_HEAD_DIM, then fc6 over their (C, P, P) output to MLP_HEAD_DIM."""
    dim = cfg.FAST_RCNN.CONV_HEAD_DIM
    p = _init_conv_stack(rng, cfg.FAST_RCNN.NUM_STACKED_CONVS, dim_in, dim,
                         "MSRAFill", use_gn)
    p["fc6"] = init_fc(rng, dim * roi_res * roi_res,
                       cfg.FAST_RCNN.MLP_HEAD_DIM)
    return p


def mask_head_convs(head_name):
    """The 3x3 convs of a v1up mask head: 4 (v1up4convs, its GN twin) or 2
    (v1up); 0 for the res5 heads (JAX mask_rcnn_heads.py:17-22)."""
    if "v1up4convs" in head_name:
        return 4
    return 2 if "v1up" in head_name else 0


def init_mask_head(rng, dim_in, head_name):
    """A shipped mask head (JAX mask_rcnn_heads.py:25-53): the v0up heads'
    2x2 deconv from res5's 2048 channels, and v0up's own res5; the v1up
    heads' convs (GroupNorm instead of bias for _gn) and deconv, all
    DIM_REDUCED wide, CONV_INIT fills."""
    init = cfg.MRCNN.CONV_INIT
    dim = cfg.MRCNN.DIM_REDUCED
    if "v0up" in head_name:
        p = {"deconv": init_conv(rng, 2, 2, 2048, dim, weight_init=init)}
        if not head_name.endswith("share"):
            p["res5"] = init_res5_head(rng, dim_in)
        return p
    p = _init_conv_stack(rng, mask_head_convs(head_name), dim_in, dim, init,
                         head_name.endswith("_gn"))
    p["deconv"] = init_conv(rng, 2, 2, dim if p["convs"] else dim_in, dim,
                            weight_init=init)
    return p


def init_mask_outputs(rng, dim_in):
    """mask_fcn_logits (JAX mask_rcnn_heads.py:82-93): a 1x1 conv to one
    logit map per class (CLS_SPECIFIC_MASK) or one in all, or with
    MRCNN.USE_FC_OUTPUT an FC from the (C, M, M) flatten to n x M x M."""
    n_mask = cfg.MODEL.NUM_CLASSES if cfg.MRCNN.CLS_SPECIFIC_MASK else 1
    if cfg.MRCNN.USE_FC_OUTPUT:
        res = cfg.MRCNN.RESOLUTION
        return {"mask_fcn_logits": init_fc(
            rng, dim_in * res * res, n_mask * res * res, "GaussianFill",
            0.001)}
    return {"mask_fcn_logits": init_conv(
        rng, 1, 1, dim_in, n_mask, weight_init=cfg.MRCNN.CONV_INIT,
        std=0.001)}


def init_pose_head(rng, dim_in):
    """roi_pose_head_v1convX (JAX keypoint_rcnn_heads.py:17-29):
    NUM_STACKED_CONVS kernel x kernel convs of CONV_HEAD_DIM, CONV_INIT
    fills with std 0.01, zero biases."""
    k = cfg.KRCNN.CONV_HEAD_KERNEL
    dim = cfg.KRCNN.CONV_HEAD_DIM
    convs = []
    for _ in range(cfg.KRCNN.NUM_STACKED_CONVS):
        convs.append(init_conv(rng, k, k, dim_in, dim,
                               weight_init=cfg.KRCNN.CONV_INIT))
        dim_in = dim
    return {"convs": convs}


def init_keypoint_outputs(rng, dim_in):
    """The keypoint outputs (JAX keypoint_rcnn_heads.py:40-58): with
    KRCNN.USE_DECONV a DECONV_KERNEL deconv to DECONV_DIM, then kps_score
    (a DECONV_KERNEL deconv with USE_DECONV_OUTPUT, else a 1x1 conv) to
    NUM_KEYPOINTS; CONV_INIT fills, std 0.01 (0.001 for kps_score)."""
    init = cfg.KRCNN.CONV_INIT
    outs = {}
    kd = cfg.KRCNN.DECONV_KERNEL
    if cfg.KRCNN.USE_DECONV:
        outs["kps_deconv"] = init_conv(rng, kd, kd, dim_in,
                                       cfg.KRCNN.DECONV_DIM, weight_init=init)
        dim_in = cfg.KRCNN.DECONV_DIM
    ks = kd if cfg.KRCNN.USE_DECONV_OUTPUT else 1
    outs["kps_score"] = init_conv(rng, ks, ks, dim_in,
                                  cfg.KRCNN.NUM_KEYPOINTS, weight_init=init,
                                  std=0.001)
    return outs


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
