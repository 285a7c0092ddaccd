"""Seeded weights of a configuration, made on the device.

The tree has the keys and the layout the program takes (conv kernels
(out, in, kh, kw), transposed-conv kernels (in, out, kh, kw), fully
connected (in, out), fc6's rows in (p, q, c) order of the pooled
features, frozen BatchNorm as s, b), and the reference reads the same
tree. Fills are Detectron's: MSRAFill N(0, 2 / fan_out), XavierFill
U(-sqrt(3 / fan_in), sqrt(3 / fan_in)), GaussianFill N(0, std), zero
biases, s = 1 and b = 0. One torch.Generator on the device, seeded from
the configuration's "weights_seed", draws every normal leaf in one call
and every uniform leaf in another. A configuration is one model served
with one set of weights: --seed draws the traffic (the images) and the
check's sample, not the weights, which would change the work from seed to
seed (the share of proposals from each FPN level, the classes' NMS
lanes).

The configuration's "calibration" moves the random heads toward a trained
detector's output statistics (calibrate): a random ResNet's features grow
through its unnormalized residual stages by a factor that differs from
seed to seed by 2-4x, so the output layers' kernels are scaled, for each
weight seed, to fixed spreads of the plain reference's RPN objectness and
deltas, box deltas, class logits and mask logits on one image; the
foreground biases get N(0, fg_std) noise, and the background logit's bias
moves so that a fixed share of the image's proposals score some foreground
class above the background (as chip_smoke.py's calibrate_scores does), so
that a share of proposals, not all, pass TEST.SCORE_THRESH. Without it the
logits spread by tens to hundreds, sigmoids and softmaxes saturate, and
the number of detections swings between 0 and 100 from seed to seed.
"""

import math

import torch

R50_BLOCKS = (3, 4, 6, 3)


def _conv(spec, path, o, i, k, fill, bias, std=None):
    spec.append((path + ("w",), (o, i, k, k), fill, std))
    if bias:
        spec.append((path + ("b",), (o,), "zero", None))


def _affine(spec, path, c):
    spec.append((path + ("s",), (c,), "one", None))
    spec.append((path + ("b",), (c,), "zero", None))


def _fc(spec, path, i, o, fill, std=None):
    spec.append((path + ("w",), (i, o), fill, std))
    spec.append((path + ("b",), (o,), "zero", None))


def _bottleneck(spec, path, in_c, out_c, inner, shortcut):
    _conv(spec, path + ("branch2a",), inner, in_c, 1, "msra", False)
    _affine(spec, path + ("branch2a_bn",), inner)
    _conv(spec, path + ("branch2b",), inner, inner, 3, "msra", False)
    _affine(spec, path + ("branch2b_bn",), inner)
    _conv(spec, path + ("branch2c",), out_c, inner, 1, "msra", False)
    _affine(spec, path + ("branch2c_bn",), out_c)
    if shortcut:
        _conv(spec, path + ("branch1",), out_c, in_c, 1, "msra", False)
        _affine(spec, path + ("branch1_bn",), out_c)


def _stage(spec, path, n, in_c, out_c, inner):
    for i in range(n):
        _bottleneck(spec, path + (i,), in_c if i == 0 else out_c, out_c,
                    inner, i == 0)


def tree_spec(cfg):
    """[(path, shape, fill, std)] of every leaf of the configuration's
    Mask R-CNN R-50 (FPN or C4), in a fixed order."""
    fpn = bool(cfg["FPN.FPN_ON"])
    spec = []
    _conv(spec, ("body", "conv1"), 64, 3, 7, "msra", False)
    _affine(spec, ("body", "res_conv1_bn"), 64)
    in_c = 64
    for s in range(4 if fpn else 3):
        out_c, inner = 256 * 2 ** s, 64 * 2 ** s
        _stage(spec, ("body", "res{}".format(s + 2)), R50_BLOCKS[s], in_c,
               out_c, inner)
        in_c = out_c
    if fpn:
        dim = cfg["FPN.DIM"]
        for i, d in enumerate((256, 512, 1024, 2048)):
            _conv(spec, ("fpn", "fpn_inner_res{}".format(i + 2)), dim, d, 1,
                  "xavier", True)
            _conv(spec, ("fpn", "fpn_res{}".format(i + 2)), dim, dim, 3,
                  "xavier", True)
        A = len(cfg["FPN.RPN_ASPECT_RATIOS"])
    else:
        dim = 1024
        A = len(cfg["RPN.ASPECT_RATIOS"]) * len(cfg["RPN.SIZES"])
    _conv(spec, ("rpn", "conv_rpn"), dim, dim, 3, "gauss", True, 0.01)
    _conv(spec, ("rpn", "rpn_cls_logits"), A, dim, 1, "gauss", True, 0.01)
    _conv(spec, ("rpn", "rpn_bbox_pred"), 4 * A, dim, 1, "gauss", True, 0.01)
    n_cls = cfg["MODEL.NUM_CLASSES"]
    if fpn:
        P = cfg["FAST_RCNN.ROI_XFORM_RESOLUTION"]
        hidden = cfg["FAST_RCNN.MLP_HEAD_DIM"]
        _fc(spec, ("box_head", "fc6"), dim * P * P, hidden, "xavier")
        _fc(spec, ("box_head", "fc7"), hidden, hidden, "xavier")
    else:
        hidden = 2048
        _stage(spec, ("box_head", "res5"), R50_BLOCKS[3], 1024, 2048, 512)
    _fc(spec, ("box_outs", "cls_score"), hidden, n_cls, "gauss", 0.01)
    _fc(spec, ("box_outs", "bbox_pred"), hidden, 4 * n_cls, "gauss", 0.001)
    red = cfg["MRCNN.DIM_REDUCED"]
    if fpn:
        for i in range(4):
            _conv(spec, ("mask_head", "convs", i), red, dim, 3, "msra", True)
        spec.append((("mask_head", "deconv", "w"), (red, red, 2, 2),
                     "msra_deconv", None))
    else:
        spec.append((("mask_head", "deconv", "w"), (2048, red, 2, 2),
                     "msra_deconv", None))
    spec.append((("mask_head", "deconv", "b"), (red,), "zero", None))
    _conv(spec, ("mask_outs", "mask_fcn_logits"), n_cls, red, 1, "msra", True)
    return spec


def _std(shape, fill, std):
    if fill == "gauss":
        return std
    if fill == "msra":                   # fan_out = out * kh * kw
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if fill == "msra_deconv":            # (in, out, kh, kw)
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    raise ValueError(fill)


def _xavier_bound(shape):
    fan_in = shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[0]
    return math.sqrt(3.0 / fan_in)


def _insert(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= k:
                node.append(default if isinstance(nxt, int) else {})
            node = node[k]
        else:
            node = node.setdefault(k, default)
    node[path[-1]] = value


def make_weights(config, traffic, device, dtype):
    """The configuration's weights tree from its "weights_seed",
    calibrated on one N(0, pixel_std) image of the traffic's canvas drawn
    after them, in `dtype` on `device`: the same tree in every run."""
    cfg = config["cfg"]
    spec = tree_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(config["weights_seed"])
    n_cls = cfg["MODEL.NUM_CLASSES"]
    normal = [(p, s, f, sd) for p, s, f, sd in spec
              if f in ("gauss", "msra", "msra_deconv")]
    uniform = [(p, s, f, sd) for p, s, f, sd in spec if f == "xavier"]
    n_norm = sum(math.prod(s) for _, s, _, _ in normal) + n_cls - 1
    n_unif = sum(math.prod(s) for _, s, _, _ in uniform)
    z = torch.randn(n_norm, generator=gen, device=device)
    u = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    leaves = {}
    off = 0
    for path, shape, fill, std in normal:
        n = math.prod(shape)
        leaves[path] = z[off:off + n].view(shape) * _std(shape, fill, std)
        off += n
    fg_noise = z[off:off + n_cls - 1]
    off = 0
    for path, shape, _, _ in uniform:
        n = math.prod(shape)
        leaves[path] = u[off:off + n].view(shape) * _xavier_bound(shape)
        off += n
    for path, shape, fill, _ in spec:
        if fill in ("zero", "one"):
            leaves[path] = torch.full(shape, 1.0 if fill == "one" else 0.0,
                                      device=device)
    tree = {}
    for path, _, _, _ in spec:
        _insert(tree, path, leaves[path])
    image = torch.randn(*traffic["canvas"], 3, generator=gen, device=device)
    calibrate(tree, config, image.to(dtype) * traffic["pixel_std"],
              traffic["im_info"], fg_noise)
    return tree_map(lambda t: t.to(dtype), tree)


@torch.no_grad()
def calibrate(tree, config, image, im_info, fg_noise):
    """Scales the output layers' kernels of the float32 `tree` in place so
    that, on `image`, the plain reference's RPN objectness logits, RPN box
    deltas, box deltas, foreground class logits and mask logits have the
    standard deviations that the configuration's "calibration" states,
    stage by stage (each stage's inputs come from the stages calibrated
    before it), and sets the class biases."""
    from benchmark.reference.model import Model, no_tf32

    c = config["calibration"]
    with no_tf32():
        ref = Model({**config["cfg"], **config["constants"]}, tree)
        feats, scales = ref.features(image)
        rpn = ref.rpn(feats)
        a = c["rpn_logit_std"] / float(
            torch.cat([l for l, _, _ in rpn]).std())
        b = c["rpn_delta_std"] / float(
            torch.cat([d for _, d, _ in rpn]).std())
        tree["rpn"]["rpn_cls_logits"]["w"] *= a
        tree["rpn"]["rpn_bbox_pred"]["w"] *= b
        rpn = [(l * a, d * b, anchors) for l, d, anchors in rpn]
        rois, valid = ref.proposals(feats, im_info, rpn)
        f = ref.box_features(feats, scales, rois[valid])
        outs = tree["box_outs"]
        outs["cls_score"]["w"] *= c["cls_logit_std"] / float(
            (f @ outs["cls_score"]["w"][:, 1:]).std())
        outs["bbox_pred"]["w"] *= c["box_delta_std"] / float(
            (f @ outs["bbox_pred"]["w"]).std())
        outs["cls_score"]["b"][1:] += fg_noise * c["foreground_bias_std"]
        logits = f @ outs["cls_score"]["w"] + outs["cls_score"]["b"]
        outs["cls_score"]["b"][0] += torch.quantile(
            logits[:, 1:].amax(1) - logits[:, 0],
            1.0 - c["foreground_share"])
        D = config["cfg"]["TEST.DETECTIONS_PER_IM"]
        logits = ref.mask_logits(feats, scales, rois[valid][:D])
        tree["mask_outs"]["mask_fcn_logits"]["w"] *= c["mask_logit_std"] / \
            float(logits.std())


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
