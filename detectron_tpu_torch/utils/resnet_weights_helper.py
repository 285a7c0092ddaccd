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


def convert_state_dict(state_dict, depth, num_stages):
    """torchvision/caffe-style resnet state dict -> {path: array} updates
    for the body params. BN (weight, bias, running_mean, running_var) folds
    into AffineChannel (s, b): s = gamma/sqrt(var+eps), b = beta - mean*s.
    Caffe-converted checkpoints have var/mean pre-folded (affine only);
    both layouts are handled."""
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
    for stage_i in range(num_stages):
        layer = "layer{}".format(stage_i + 1)
        stage = "res{}".format(stage_i + 2)
        for blk in range(counts[stage_i]):
            pre = "{}.{}.".format(layer, blk)
            for tsrc, tdst in br_map.items():
                updates[("body", stage, blk, tdst, "w")] = _torch_conv(
                    state_dict[pre + tsrc + ".weight"])
            for bsrc, bdst in bn_map.items():
                s, b = fold_bn(pre + bsrc)
                updates[("body", stage, blk, bdst, "s")] = s
                updates[("body", stage, blk, bdst, "b")] = b
            if pre + "downsample.0.weight" in state_dict:
                updates[("body", stage, blk, "branch1", "w")] = _torch_conv(
                    state_dict[pre + "downsample.0.weight"])
                s, b = fold_bn(pre + "downsample.1")
                updates[("body", stage, blk, "branch1_bn", "s")] = s
                updates[("body", stage, blk, "branch1_bn", "b")] = b
    return updates


def load_pretrained_imagenet_weights(params, weights_file=None):
    """Load cfg.RESNETS.IMAGENET_PRETRAINED_WEIGHTS (or weights_file) into
    params['body'] of the numpy params tree. Accepts torch .pth state
    dicts (a "state_dict" entry is unwrapped) or Detectron-format .pkl blob
    dicts (through the body's blob mapping)."""
    weights_file = weights_file or cfg.RESNETS.IMAGENET_PRETRAINED_WEIGHTS
    depth, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    if weights_file.endswith(".pkl"):
        blobs = dwh.read_blobs(weights_file)
        mapping = dwh.body_weight_mapping(depth, num_stages)
        n = 0
        for name, (path, transform) in mapping.items():
            if name in blobs:
                dwh._set_path(params, path, transform(np.asarray(blobs[name])))
                n += 1
        logger.info("Loaded %d ImageNet blobs from %s", n, weights_file)
        return params

    state_dict = torch.load(weights_file, map_location="cpu",
                            weights_only=False)
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    state_dict = {k: v.numpy() if hasattr(v, "numpy") else v
                  for k, v in state_dict.items()}
    updates = convert_state_dict(state_dict, depth, num_stages)
    for path, value in updates.items():
        node = params
        for p in path[:-1]:
            node = node[p]
        assert tuple(node[path[-1]].shape) == tuple(value.shape), path
        node[path[-1]] = np.asarray(value, np.float32)
    logger.info("Loaded %d ImageNet tensors from %s", len(updates),
                weights_file)
    return params
