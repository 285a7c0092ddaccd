"""NN primitives on NHWC activations (port of detectron_tpu/models/layers.py).

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


def max_pool(x, window=3, stride=2, padding=1):
    """Max pool with -inf padding (F.max_pool2d pads with -inf)."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))


def relu(x):
    return torch.relu(x)
