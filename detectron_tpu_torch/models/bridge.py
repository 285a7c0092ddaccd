"""Params bridge: a JAX-layout params tree of numpy arrays <-> torch tensors.

The tree keeps detectron_tpu's keys (Caffe2 blob names, nested dicts and
lists); only the leaves change layout:

- conv `w`: HWIO -> OIHW (F.conv2d's layout);
- the mask head's deconv `w`: detectron_tpu stores it spatially flipped for
  lax.conv_transpose(transpose_kernel=False) (layers.py:66-86,
  detectron_weight_helper.py:31-36); F.conv_transpose2d correlates with the
  flipped kernel and takes (in, out, kh, kw), so the bridge flips the
  spatial axes back and moves in/out first;
- fc6 `w`: rows come in Caffe2 (C, P, P) flatten order; they are permuted
  once to the NHWC flatten order (P, P, C) of the pooled features, as
  detectron_tpu's _fc_on_nhwc does per step with qp_order=False
  (fast_rcnn_heads.py:25-49);
- every other leaf (FC `w` in (in, out), biases, AffineChannel s/b) is
  carried as it is.

A JAX tree is bridged after np.asarray on each leaf; the numpy tree from
models/init.init_model is already in that form. to_jax_layout is the exact
inverse, back to numpy arrays in the JAX layout (for comparing gradients and
updated params with the JAX package, or writing a checkpoint in its format).
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg


def _leaf(path, a):
    a = np.array(a, np.float32)
    if path[-1] == "w" and a.ndim == 4:
        if "deconv" in path:
            return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if path[-1] == "w" and path[-3:-1] == ("box_head", "fc6"):
        rows, hidden = a.shape
        P = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
        C = rows // (P * P)
        return np.ascontiguousarray(
            a.reshape(C, P, P, hidden).transpose(1, 2, 0, 3)
            .reshape(rows, hidden))
    return a


def to_torch(tree, device, dtype=torch.float32, _path=()):
    """Bridge a numpy params tree to torch tensors on `device` ("cuda" on
    the card, "cpu" only where the caller asks for it) in `dtype` (the
    compute dtype for inference: every layer casts its params to the
    activation dtype, as detectron_tpu's layers do, so bridging in that
    dtype makes the per-layer cast a no-op; float32 master params for
    training)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype, _path + (i,))
                for i, v in enumerate(tree)]
    return torch.from_numpy(_leaf(_path, tree)).to(device=device,
                                                   dtype=dtype)


def _jax_leaf(path, t):
    a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
    if path[-1] == "w" and a.ndim == 4:
        if "deconv" in path:
            return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if path[-1] == "w" and path[-3:-1] == ("box_head", "fc6"):
        rows, hidden = a.shape
        P = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
        C = rows // (P * P)
        return np.ascontiguousarray(
            a.reshape(P, P, C, hidden).transpose(2, 0, 1, 3)
            .reshape(rows, hidden))
    return np.ascontiguousarray(a)


def to_jax_layout(tree, _path=()):
    """The inverse of to_torch: a tree of torch tensors (params or
    gradients) -> float32 numpy arrays in the JAX layout (HWIO conv
    kernels, the flipped deconv kernel, Caffe2 (C, P, P) fc6 rows).
    to_jax_layout(to_torch(t, "cpu")) == t exactly for float32 leaves."""
    if isinstance(tree, dict):
        return {k: to_jax_layout(v, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_layout(v, _path + (i,)) for i, v in enumerate(tree)]
    return _jax_leaf(_path, tree)
