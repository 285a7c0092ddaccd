"""Detectron (Caffe2) .pkl weight import (the port's copy of
detectron_tpu/utils/detectron_weight_helper.py :27-260; reference:
lib/utils/detectron_weight_helper.py :: load_detectron_weight and the
per-module detectron_weight_mapping tables).

Every Caffe2 blob name maps to a path in the params tree plus a layout
transform into the JAX layout that models/init.init_model builds:

  conv    OIHW -> HWIO           (transpose 2,3,1,0)
  deconv  IOHW -> HWIO + spatial flip (the JAX package's conv_transpose
          convention)
  fc      (out, in) -> (in, out) (transpose)
  bn/gn   s, b copied verbatim

A grouped conv blob (O, I / groups, kh, kw) takes the same transform into
HWIO (kh, kw, I / groups, O). GroupNorm blobs follow Detectron's ConvGN
(lib/modeling/detector.py), which names a conv's norm `<conv>_gn_s` /
`<conv>_gn_b` and gives the conv no bias: the body's `conv1_gn_*`,
`res{s}_{b}_branch2a_gn_*` and `branch1_gn_*` (the tree keeps its `*_bn`
keys for them), the FPN's `<lateral or posthoc>_gn_*`, the box head's
`head_conv{i}_gn_*` and the GN mask head's `_mask_fcn{i}_gn_*`, whose
convs Detectron names `_mask_fcn{i}` (the AffineChannel head's are
`_[mask]_fcn{i}`). The JAX package's table names only `*_bn_*` blobs for
a GN body and maps biases the GN convs do not have, so it cannot load a
GN model; the port's tables follow Detectron.

The loaded tree is a numpy tree like init_model's; models/bridge.to_torch
then lays it out for torch (OIHW, the deconv flip undone, fc6's Caffe2
(C, P, P) rows permuted), so each layout hazard lives in one place. fc6_w
imports with a plain transpose: its rows are in Caffe2 order in the JAX
layout too.
"""

import pickle

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import resnet
from detectron_tpu_torch.models.resnet import BLOCK_COUNTS


def _conv(x):
    return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))


def _deconv(x):
    # Caffe2 deconv blob: (in, out, kh, kw). The JAX layout holds it HWIO
    # with the kernel spatially flipped relative to the Caffe2/torch
    # ConvTranspose convention (models/bridge.py flips it back).
    return np.ascontiguousarray(
        np.transpose(x, (2, 3, 0, 1))[::-1, ::-1])


def _fc(x):
    return np.ascontiguousarray(np.transpose(x))


def _id(x):
    return np.asarray(x)


def _norm_blob(conv):
    """The blob prefix of a body conv's norm: `<conv>_bn` (AffineChannel)
    or, with RESNETS.USE_GN, `<conv>_gn` (Detectron's ConvGN)."""
    return conv + ("_gn" if cfg.RESNETS.USE_GN else "_bn")


def _stage_mapping(m, blob, n_blocks, prefix):
    """The blobs blob_{block}_branch* of a stage into prefix + (block,
    ...)."""
    for b in range(n_blocks):
        base = "{}_{}_".format(blob, b)
        for br in ("branch2a", "branch2b", "branch2c") + (
                ("branch1",) if b == 0 else ()):
            m[base + br + "_w"] = (prefix + (b, br, "w"), _conv)
            for k in ("s", "b"):
                m["{}_{}".format(_norm_blob(base + br), k)] = (
                    prefix + (b, br + "_bn", k), _id)
    return m


def body_weight_mapping(depth, num_stages):
    """Backbone blob map: detectron name -> (path tuple, transform)."""
    stem = "conv1" if cfg.RESNETS.USE_GN else "res_conv1"
    m = {"conv1_w": (("body", "conv1", "w"), _conv)}
    for k in ("s", "b"):
        m["{}_{}".format(_norm_blob(stem), k)] = (
            ("body", "res_conv1_bn", k), _id)
    counts = BLOCK_COUNTS[depth]
    for s in range(num_stages):
        stage = "res{}".format(s + 2)
        _stage_mapping(m, stage, counts[s], ("body", stage))
    return m


def res5_head_mapping(depth, prefix=("box_head",), blob="res5"):
    """A C4 RoI head's res5 blobs, named blob_{block}_...: "res5" for the
    box head (the backbone res5's names), "_[mask]_res5" for the v0up mask
    head's own res5 (Detectron's add_ResNet_roi_conv5_head_for_masks)."""
    return _stage_mapping({}, blob, BLOCK_COUNTS[depth][3],
                          prefix + ("res5",))


def fpn_weight_mapping(depth):
    """FPN lateral/posthoc blobs. Caffe2 names carry the top block index of
    each stage (e.g. fpn_inner_res4_5_sum for R-50, fpn_inner_res4_22_sum
    for R-101); non-top laterals carry a '_lateral' suffix. With FPN.USE_GN
    each conv has no bias and a `<conv>_gn_s` / `_gn_b` pair."""
    counts = BLOCK_COUNTS[depth]
    m = {}
    for lvl in range(2, 6):
        suffix = "res{}_{}_sum".format(lvl, counts[lvl - 2] - 1)
        lateral = "fpn_inner_{}".format(suffix)
        if lvl != 5:
            lateral += "_lateral"
        for blob, key in ((lateral, "fpn_inner_res{}".format(lvl)),
                          ("fpn_" + suffix, "fpn_res{}".format(lvl))):
            m[blob + "_w"] = (("fpn", key, "w"), _conv)
            if cfg.FPN.USE_GN:
                m[blob + "_gn_s"] = (("fpn", key + "_gn", "s"), _id)
                m[blob + "_gn_b"] = (("fpn", key + "_gn", "b"), _id)
            else:
                m[blob + "_b"] = (("fpn", key, "b"), _id)
    return m


def rpn_weight_mapping(is_fpn):
    if is_fpn:
        lvl = cfg.FPN.RPN_MIN_LEVEL
        sfx = "_fpn{}".format(lvl)
    else:
        sfx = ""
    return {
        "conv_rpn{}_w".format(sfx): (("rpn", "conv_rpn", "w"), _conv),
        "conv_rpn{}_b".format(sfx): (("rpn", "conv_rpn", "b"), _id),
        "rpn_cls_logits{}_w".format(sfx): (
            ("rpn", "rpn_cls_logits", "w"), _conv),
        "rpn_cls_logits{}_b".format(sfx): (
            ("rpn", "rpn_cls_logits", "b"), _id),
        "rpn_bbox_pred{}_w".format(sfx): (
            ("rpn", "rpn_bbox_pred", "w"), _conv),
        "rpn_bbox_pred{}_b".format(sfx): (
            ("rpn", "rpn_bbox_pred", "b"), _id),
    }


def box_head_weight_mapping(is_fpn):
    m = {
        "cls_score_w": (("box_outs", "cls_score", "w"), _fc),
        "cls_score_b": (("box_outs", "cls_score", "b"), _id),
        "bbox_pred_w": (("box_outs", "bbox_pred", "w"), _fc),
        "bbox_pred_b": (("box_outs", "bbox_pred", "b"), _id),
    }
    if is_fpn:
        head = cfg.FAST_RCNN.ROI_BOX_HEAD
        if "roi_2mlp_head" in head:
            m.update({
                "fc6_w": (("box_head", "fc6", "w"), _fc),
                "fc6_b": (("box_head", "fc6", "b"), _id),
                "fc7_w": (("box_head", "fc7", "w"), _fc),
                "fc7_b": (("box_head", "fc7", "b"), _id),
            })
        elif "Xconv1fc" in head:
            _conv_stack_mapping(m, "head_conv", "box_head",
                                cfg.FAST_RCNN.NUM_STACKED_CONVS,
                                "_gn" in head)
            m["fc6_w"] = (("box_head", "fc6", "w"), _fc)
            m["fc6_b"] = (("box_head", "fc6", "b"), _id)
    return m


def _conv_stack_mapping(m, blob, head, n, use_gn):
    """A head's 3x3 convs blob{i}_w (i from 1) into (head, "convs", i - 1),
    with their biases blob{i}_b, or under `use_gn` their GroupNorms
    blob{i}_gn_s / _gn_b into (head, "gns", i - 1) (Detectron's ConvGN
    convs have no bias)."""
    for i in range(n):
        name = "{}{}".format(blob, i + 1)
        m[name + "_w"] = ((head, "convs", i, "w"), _conv)
        if use_gn:
            m[name + "_gn_s"] = ((head, "gns", i, "s"), _id)
            m[name + "_gn_b"] = ((head, "gns", i, "b"), _id)
        else:
            m[name + "_b"] = ((head, "convs", i, "b"), _id)
    return m


def mask_head_weight_mapping():
    head = cfg.MRCNN.ROI_MASK_HEAD
    m = {}
    if "v1up" in head:
        # Detectron's mask_rcnn_fcn_head_v1upXconvs_gn names its convs
        # _mask_fcn{i}; the AffineChannel variant _[mask]_fcn{i}.
        use_gn = head.endswith("_gn")
        _conv_stack_mapping(m, "_mask_fcn" if use_gn else "_[mask]_fcn",
                            "mask_head", 4 if "v1up4convs" in head else 2,
                            use_gn)
    elif "v0up" in head and not head.endswith("share"):
        # Detectron names this res5 "_[mask]_res5"; the JAX package's table
        # maps it from the box head's "res5" names, so that its later
        # entries take those blobs from the box head.
        m.update(res5_head_mapping(50, prefix=("mask_head",),
                                   blob="_[mask]_res5"))
    m["conv5_mask_w"] = (("mask_head", "deconv", "w"), _deconv)
    m["conv5_mask_b"] = (("mask_head", "deconv", "b"), _id)
    m["mask_fcn_logits_w"] = (("mask_outs", "mask_fcn_logits", "w"),
                              _fc if cfg.MRCNN.USE_FC_OUTPUT else _conv)
    m["mask_fcn_logits_b"] = (("mask_outs", "mask_fcn_logits", "b"), _id)
    return m


def keypoint_head_weight_mapping():
    m = {}
    for i in range(cfg.KRCNN.NUM_STACKED_CONVS):
        m["conv_fcn{}_w".format(i + 1)] = (
            ("kps_head", "convs", i, "w"), _conv)
        m["conv_fcn{}_b".format(i + 1)] = (
            ("kps_head", "convs", i, "b"), _id)
    m["kps_score_w"] = (("kps_outs", "kps_score", "w"),
                        _deconv if cfg.KRCNN.USE_DECONV_OUTPUT else _conv)
    m["kps_score_b"] = (("kps_outs", "kps_score", "b"), _id)
    return m


def full_weight_mapping():
    """The complete blob-name -> (param path, transform) table for the
    configured model (the analog of Generalized_RCNN.detectron_weight_mapping
    aggregation). The RPN's blobs are mapped only with the RPN on: in Fast
    R-CNN mode init_model has no "rpn" params (the JAX table maps them
    whatever RPN.RPN_ON says, and its loader then fails on the missing
    subtree)."""
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    is_fpn = bool(cfg.FPN.FPN_ON)
    m = body_weight_mapping(depth, num_stages)
    if is_fpn:
        m.update(fpn_weight_mapping(depth))
    else:
        m.update(res5_head_mapping(depth))
    if cfg.RPN.RPN_ON:
        m.update(rpn_weight_mapping(is_fpn and cfg.FPN.MULTILEVEL_RPN))
    m.update(box_head_weight_mapping(is_fpn))
    if cfg.MODEL.MASK_ON:
        m.update(mask_head_weight_mapping())
    if cfg.MODEL.KEYPOINTS_ON:
        m.update(keypoint_head_weight_mapping())
    return m


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    old = node[path[-1]]
    assert tuple(old.shape) == tuple(value.shape), \
        "shape mismatch at {}: {} vs {}".format(path, old.shape, value.shape)
    node[path[-1]] = np.asarray(value, np.float32)


def read_blobs(weights_file):
    """The blob dict of a Detectron .pkl: its "blobs" entry, or the whole
    pickle where it is a bare dict (read with latin1, as Python 2 pickles
    need)."""
    with open(weights_file, "rb") as f:
        saved = pickle.load(f, encoding="latin1")
    return saved.get("blobs", saved)


def load_detectron_weight(params, weights_file, strict=True):
    """Load a Detectron .pkl blob dict into the numpy params tree. Returns
    the updated tree (params is modified in place for dict nodes). Blobs
    the mapping does not name (momentum blobs, other heads) are ignored;
    with `strict`, a mapped blob missing from the file raises KeyError."""
    blobs = read_blobs(weights_file)
    mapping = full_weight_mapping()
    missing = []
    for name, (path, transform) in mapping.items():
        if name not in blobs:
            missing.append(name)
            continue
        _set_path(params, path, transform(np.asarray(blobs[name])))
    if strict and missing:
        raise KeyError("Missing blobs in {}: {}".format(
            weights_file, missing[:10]))
    return params


# The inverse of each layout transform: JAX layout -> Caffe2 blob.
_TO_BLOB = {
    _conv: lambda x: np.transpose(x, (3, 2, 0, 1)),
    _deconv: lambda x: np.transpose(x[::-1, ::-1], (2, 3, 0, 1)),
    _fc: np.transpose,
    _id: lambda x: x,
}


def to_detectron_blobs(params):
    """The inverse of load_detectron_weight: {blob name: float32 array in
    its Caffe2 layout} for every blob the configured model maps, from a
    numpy params tree in the JAX layout. Pickled as {"blobs": ...}, it
    loads back to the same tree exactly."""
    blobs = {}
    for name, (path, transform) in full_weight_mapping().items():
        node = params
        for p in path:
            node = node[p]
        blobs[name] = np.ascontiguousarray(
            _TO_BLOB[transform](np.asarray(node, np.float32)))
    return blobs
