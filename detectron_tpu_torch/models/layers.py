"""NN primitives on NHWC activations (port of detectron_tpu/models/layers.py,
with GroupNorm and Detectron's group-count rule from layers.py:128-156).

Activations stay NHWC at every function boundary, as in the JAX package.
Convolutions run through a permuted view: an NHWC tensor permuted to NCHW
is a channels_last tensor, which F.conv2d takes as it is, and its output
permuted back is NHWC again, so no copy is made on either side. Params come
from models/bridge.py (OIHW conv kernels, (in, out, kh, kw) deconv kernels,
(in, out) FC kernels) and are cast to the activation dtype, as
detectron_tpu's layers cast theirs.
"""

import torch
import torch.nn.functional as F

from detectron_tpu_torch.core.config import cfg


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(p, x, stride=1, padding=0, dilation=1, groups=1):
    """x: (B, H, W, C). padding: an int, or explicit ((top, bottom),
    (left, right)) pairs."""
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = padding
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        padding = 0
    y = _nhwc(F.conv2d(_nchw(x), p["w"].to(x.dtype), None, stride, padding,
                       dilation, groups))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv_transpose2d(p, x, stride=2, torch_padding=0):
    """Deconv with torch.nn.ConvTranspose2d padding semantics
    (out = (in - 1) * stride - 2 * padding + kernel)."""
    y = _nhwc(F.conv_transpose2d(_nchw(x), p["w"].to(x.dtype), None, stride,
                                 torch_padding))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def fc(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def affine_channel(p, x):
    """Per-channel x * s + b: Detectron's frozen BatchNorm."""
    return x * p["s"].to(x.dtype) + p["b"].to(x.dtype)


def get_group_gn(dim, dim_per_gp, num_groups):
    """Detectron's GN group count (lib/utils/net.py :: get_group_gn): dim /
    dim_per_gp groups, or num_groups; exactly one of the two is set."""
    if not (dim_per_gp == -1 or num_groups == -1):
        raise ValueError("GroupNorm: set GROUP_NORM.DIM_PER_GP or "
                         "GROUP_NORM.NUM_GROUPS, not both")
    if dim_per_gp > 0:
        if dim % dim_per_gp:
            raise ValueError("GroupNorm: {} channels in groups of {}".format(
                dim, dim_per_gp))
        return dim // dim_per_gp
    if dim % num_groups:
        raise ValueError("GroupNorm: {} channels in {} groups".format(
            dim, num_groups))
    return num_groups


def group_norm(p, x, num_groups, eps=1e-5):
    """GroupNorm of x (B, H, W, C) over (H, W, C / G) per group, with scale
    p["s"] and bias p["b"]: statistics and affine in at least float32,
    the result in the input dtype (the JAX package's bf16 rule)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.group_norm(_nchw(x).to(acc), num_groups, p["s"].to(acc),
                     p["b"].to(acc), eps)
    return _nhwc(y).to(x.dtype)


def group_norm_cfg(p, x):
    """group_norm with the cfg's GROUP_NORM settings (the group count from
    the channels by get_group_gn), as every GN layer of the model runs
    it."""
    g = get_group_gn(p["s"].shape[0], cfg.GROUP_NORM.DIM_PER_GP,
                     cfg.GROUP_NORM.NUM_GROUPS)
    return group_norm(p, x, g, cfg.GROUP_NORM.EPSILON)


def max_pool(x, window=3, stride=2, padding=1):
    """Max pool with -inf padding (F.max_pool2d pads with -inf)."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))


def relu(x):
    return torch.relu(x)


def leaves(tree):
    """The tensors of a params (sub)tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def stop_gradient(tree):
    """A params (sub)tree with every tensor detached, as jax.lax.stop_gradient
    does: frozen params enter the forward as constants and get no
    gradient."""
    if isinstance(tree, dict):
        return {k: stop_gradient(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [stop_gradient(v) for v in tree]
    return tree.detach()
