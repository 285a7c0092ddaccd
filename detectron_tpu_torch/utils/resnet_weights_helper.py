"""Caffe-style ImageNet ResNet weight import (the port's copy of
detectron_tpu/utils/resnet_weights_helper.py :27-119; reference:
lib/utils/resnet_weights_helper.py :: load_pretrained_imagenet_weights,
convert_state_dict).

Loads the caffe-converted torch .pth checkpoints Detectron uses
(resnet{50,101,152}_caffe.pth, keys like 'conv1.weight', 'bn1.weight',
'layer1.0.conv1.weight') or a Detectron-format .pkl, and maps them onto
the body params of the numpy params tree (JAX layout: HWIO kernels).
RESNETS.STRIDE_1X1 needs no re-ordering (the caffe blobs already follow
the stride-on-1x1 convention); BN folds into the AffineChannel s / b.
Depths 101 and 152 take their block counts from resnet.BLOCK_COUNTS. A
grouped (ResNeXt) or GroupNorm body loads from a Detectron-format .pkl
(X-101-32x8d.pkl, X-152-32x8d-IN5k.pkl, R-50-GN.pkl: the body's blob
names of detectron_weight_helper, `*_gn_*` under RESNETS.USE_GN); a
caffe .pth holds BN statistics, so a GN body raises on one.

A C4 model's res5 lives in its RoI heads, not in its conv4 body: the
ImageNet res5 (res5_* blobs, layer4.* tensors) goes into box_head.res5,
and into mask_head.res5 under the v0up mask head, as Detectron's loader
fills every res* blob of the model. The JAX package's copy
(resnet_weights_helper.py:93, :113) maps the body's stages only, so its C4
heads keep their random init.
"""

import logging

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import resnet
from detectron_tpu_torch.models.resnet import BLOCK_COUNTS
from detectron_tpu_torch.utils import detectron_weight_helper as dwh

logger = logging.getLogger(__name__)


def _torch_conv(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (2, 3, 1, 0)))


def _res5_heads(params):
    """The subtrees of params holding a C4 RoI head's res5."""
    return [(name,) for name in ("box_head", "mask_head")
            if "res5" in params.get(name, {})]


def convert_state_dict(state_dict, depth, num_stages, res5_heads=()):
    """torchvision/caffe-style resnet state dict -> {path: array} updates
    for the body params. BN (weight, bias, running_mean, running_var) folds
    into AffineChannel (s, b): s = gamma/sqrt(var+eps), b = beta - mean*s.
    Caffe-converted checkpoints have var/mean pre-folded (affine only);
    both layouts are handled. layer4 also goes to each prefix of
    res5_heads as (prefix..., "res5", block, ...)."""
    eps = 1e-5
    updates = {}

    def fold_bn(prefix):
        gamma = np.asarray(state_dict[prefix + ".weight"])
        beta = np.asarray(state_dict[prefix + ".bias"])
        if prefix + ".running_var" in state_dict:
            var = np.asarray(state_dict[prefix + ".running_var"])
            mean = np.asarray(state_dict[prefix + ".running_mean"])
            s = gamma / np.sqrt(var + eps)
            b = beta - mean * s
        else:
            s, b = gamma, beta
        return s.astype(np.float32), b.astype(np.float32)

    updates[("body", "conv1", "w")] = _torch_conv(state_dict["conv1.weight"])
    s, b = fold_bn("bn1")
    updates[("body", "res_conv1_bn", "s")] = s
    updates[("body", "res_conv1_bn", "b")] = b

    counts = BLOCK_COUNTS[depth]
    br_map = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c"}
    bn_map = {"bn1": "branch2a_bn", "bn2": "branch2b_bn", "bn3": "branch2c_bn"}
    stages = [(i, ("body", "res{}".format(i + 2)))
              for i in range(num_stages)]
    stages += [(3, prefix + ("res5",)) for prefix in res5_heads]
    for stage_i, stage in stages:
        layer = "layer{}".format(stage_i + 1)
        for blk in range(counts[stage_i]):
            pre = "{}.{}.".format(layer, blk)
            for tsrc, tdst in br_map.items():
                updates[stage + (blk, tdst, "w")] = _torch_conv(
                    state_dict[pre + tsrc + ".weight"])
            for bsrc, bdst in bn_map.items():
                s, b = fold_bn(pre + bsrc)
                updates[stage + (blk, bdst, "s")] = s
                updates[stage + (blk, bdst, "b")] = b
            if pre + "downsample.0.weight" in state_dict:
                updates[stage + (blk, "branch1", "w")] = _torch_conv(
                    state_dict[pre + "downsample.0.weight"])
                s, b = fold_bn(pre + "downsample.1")
                updates[stage + (blk, "branch1_bn", "s")] = s
                updates[stage + (blk, "branch1_bn", "b")] = b
    return updates


def load_pretrained_imagenet_weights(params, weights_file=None):
    """Load cfg.RESNETS.IMAGENET_PRETRAINED_WEIGHTS (or weights_file) into
    params['body'] of the numpy params tree, and its res5 into a C4
    model's res5 heads. Accepts torch .pth state dicts (a "state_dict"
    entry is unwrapped) or Detectron-format .pkl blob dicts (through the
    body's blob mapping)."""
    weights_file = weights_file or cfg.RESNETS.IMAGENET_PRETRAINED_WEIGHTS
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    heads = _res5_heads(params) if num_stages == 3 else []
    if weights_file.endswith(".pkl"):
        blobs = dwh.read_blobs(weights_file)
        mapping = list(dwh.body_weight_mapping(depth, num_stages).items())
        for prefix in heads:
            mapping += dwh.res5_head_mapping(depth, prefix).items()
        n = 0
        for name, (path, transform) in mapping:
            if name in blobs:
                dwh._set_path(params, path, transform(np.asarray(blobs[name])))
                n += 1
        logger.info("Loaded %d ImageNet blobs from %s", n, weights_file)
        return params

    if cfg.RESNETS.USE_GN:
        raise ValueError("{}: a caffe .pth holds BatchNorm statistics; a "
                         "GroupNorm body loads its ImageNet weights from a "
                         "Detectron .pkl".format(weights_file))
    state_dict = torch.load(weights_file, map_location="cpu",
                            weights_only=False)
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    state_dict = {k: v.numpy() if hasattr(v, "numpy") else v
                  for k, v in state_dict.items()}
    updates = convert_state_dict(state_dict, depth, num_stages, heads)
    for path, value in updates.items():
        node = params
        for p in path[:-1]:
            node = node[p]
        assert tuple(node[path[-1]].shape) == tuple(value.shape), path
        node[path[-1]] = np.asarray(value, np.float32)
    logger.info("Loaded %d ImageNet tensors from %s", len(updates),
                weights_file)
    return params
