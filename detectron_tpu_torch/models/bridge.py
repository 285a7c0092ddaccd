"""Params bridge: a JAX-layout params tree of numpy arrays <-> torch tensors.

The tree keeps detectron_tpu's keys (Caffe2 blob names, nested dicts and
lists); only the leaves change layout:

- conv `w`: HWIO -> OIHW (F.conv2d's layout);
- transposed-conv `w` (the mask head's deconv, the keypoint head's
  kps_deconv, and its kps_score under KRCNN.USE_DECONV_OUTPUT; decided by
  the key, since kps_score is a plain 1x1 conv without that option):
  detectron_tpu stores them spatially flipped for
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

Bridged in a dtype narrower than float32, the stem's AffineChannel and
res2 stay float32: the TPU.FUSED_RES2 path folds them from float32 values,
as the JAX package does (ops/cuda/fused_stem_kernel.py); every other path
casts them to the activation dtype in its layers, so their values there do
not change.

A JAX tree is bridged after np.asarray on each leaf; the numpy tree from
models/init.init_model is already in that form. to_jax_layout is the exact
inverse, back to numpy arrays in the JAX layout (for comparing gradients and
updated params with the JAX package, or writing a checkpoint in its format).
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg


# Subtrees that the fused res2 path folds from float32 values.
_FOLDED = (("body", "res_conv1_bn"), ("body", "res2"))


def _is_deconv(path):
    """Whether the kernel at `path` is a transposed conv's: a layer named
    deconv or kps_deconv, or kps_outs' kps_score with
    KRCNN.USE_DECONV_OUTPUT."""
    return path[-2] in ("deconv", "kps_deconv") or (
        tuple(path[-3:-1]) == ("kps_outs", "kps_score")
        and bool(cfg.KRCNN.USE_DECONV_OUTPUT))


def _leaf(path, a):
    a = np.array(a, np.float32)
    if path[-1] == "w" and a.ndim == 4:
        if _is_deconv(path):
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
    if _path[:2] in _FOLDED and dtype.itemsize < 4:
        dtype = torch.float32
    return torch.from_numpy(_leaf(_path, tree)).to(device=device,
                                                   dtype=dtype)


def _jax_leaf(path, t):
    a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
    if path[-1] == "w" and a.ndim == 4:
        if _is_deconv(path):
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
    kernels, flipped deconv kernels, Caffe2 (C, P, P) fc6 rows).
    to_jax_layout(to_torch(t, "cpu")) == t exactly for float32 leaves."""
    if isinstance(tree, dict):
        return {k: to_jax_layout(v, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_layout(v, _path + (i,)) for i, v in enumerate(tree)]
    return _jax_leaf(_path, tree)
