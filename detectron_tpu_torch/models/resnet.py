"""ResNet / ResNeXt conv bodies and the C4 models' res5 RoI head,
Detectron semantics (port of detectron_tpu/models/resnet.py: the norm
:40-56, bottlenecks and stages :80-116, the channel plan :123-130,
apply_body :210-300 with the TPU.FUSED_RES2 branch :232-291 and
TPU.REMAT_BODY :292-297, apply_roi_conv5_head :307-325). A conv5 body
(res2-res5) feeds an FPN; a conv4 body (res2-res4, stride 16) feeds a C4
model, whose box head runs res5 on each RoI's pooled features. Depths 50,
101 and 152 differ only in BLOCK_COUNTS.

The norm after each conv is frozen BN as AffineChannel, whose params never
get a gradient, or with RESNETS.USE_GN GroupNorm under the same keys,
whose params train. The stem and the stages up to RESNETS.FREEZE_AT are
frozen (their params enter the forward detached, as stop_gradient does in
the JAX package). RESNETS.STRIDE_1X1 picks the Caffe (stride on the 1x1)
or torch (stride on the 3x3) bottleneck; RESNETS.NUM_GROUPS and
WIDTH_PER_GROUP give ResNeXt's grouped 3x3 convs and its inner widths.
TPU.REMAT_BODY recomputes each stage's activations in the backward
(torch.utils.checkpoint) instead of keeping them. With TPU.FUSED_RES2,
the stem post-ops and res2 run through kernels K5 and K6
(ops/cuda/fused_stem_kernel.py) under the JAX package's gates (ResNet
bodies with AffineChannel only), with the fused path's own rounding; on
the CPU their plain versions. Res5 dilation (of a body or of the res5
head) and the s2d stems (S2D_STEM, S2D_INPUT) are not ported yet:
check_body_supported raises on them.
"""

import torch
from torch.utils.checkpoint import checkpoint

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk

# (n2, n3, n4, n5) block counts
BLOCK_COUNTS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def body_spec(conv_body_name):
    """Parse a CONV_BODY string into (depth, num_stages)."""
    name = conv_body_name.split(".")[-1]
    depth = None
    for d in (50, 101, 152):
        if "ResNet{}".format(d) in name:
            depth = d
    if depth is None:
        raise ValueError("Unrecognized CONV_BODY: " + conv_body_name)
    return depth, (4 if "conv5" in name else 3)


def inner_dims():
    """Per-stage (inner, outer) channels of res2-res5 and the 3x3 convs'
    group count: inner NUM_GROUPS x WIDTH_PER_GROUP x 2^s (64 x 2^s for a
    ResNet, 256 x 2^s for X-101-32x8d / 64x4d), outer 256 x 2^s."""
    ng = cfg.RESNETS.NUM_GROUPS
    base = ng * cfg.RESNETS.WIDTH_PER_GROUP
    return ([base * 2 ** i for i in range(4)],
            [256 * 2 ** i for i in range(4)], ng)


def check_body_supported():
    off = {"RESNETS.RES5_DILATION != 1": cfg.RESNETS.RES5_DILATION != 1,
           "TPU.S2D_STEM": cfg.TPU.S2D_STEM,
           "TPU.S2D_INPUT": cfg.TPU.S2D_INPUT}
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(
            "not ported yet (ROADMAP Queue A, A7): "
            + ", ".join(on))


def _norm(p, x):
    """The norm of a body or res5 head: GroupNorm with RESNETS.USE_GN
    (params that train), else AffineChannel with frozen (detached)
    params."""
    if cfg.RESNETS.USE_GN:
        return L.group_norm_cfg(p, x)
    return L.affine_channel(L.stop_gradient(p), x)


def apply_bottleneck(p, x, stride):
    s1 = stride if cfg.RESNETS.STRIDE_1X1 else 1
    s3 = 1 if cfg.RESNETS.STRIDE_1X1 else stride
    h = L.conv2d(p["branch2a"], x, stride=s1, padding=0)
    h = L.relu(_norm(p["branch2a_bn"], h))
    h = L.conv2d(p["branch2b"], h, stride=s3, padding=1,
                 groups=cfg.RESNETS.NUM_GROUPS)
    h = L.relu(_norm(p["branch2b_bn"], h))
    h = L.conv2d(p["branch2c"], h, stride=1, padding=0)
    h = _norm(p["branch2c_bn"], h)
    if "branch1" in p:
        sc = _norm(p["branch1_bn"],
                   L.conv2d(p["branch1"], x, stride=stride, padding=0))
    else:
        sc = x
    return L.relu(h + sc)


def apply_stage(blocks, x, stride):
    """A stage's bottleneck blocks; the first one strides."""
    for i, bp in enumerate(blocks):
        x = apply_bottleneck(bp, x, stride if i == 0 else 1)
    return x


def _needs_grad(stage_params, x):
    return x.requires_grad or any(
        t.requires_grad for t in L.leaves(stage_params))


def apply_roi_conv5_head(p, roi_feat):
    """ResNet_roi_conv5_head: roi_feat (R, P, P, 1024) -> res5 at stride 2
    -> the mean over its spatial cells, (R, 2048). The mean sums in at
    least float32, as jnp.mean does for bfloat16, and returns the input
    dtype."""
    check_body_supported()
    h = apply_stage(p["res5"], roi_feat, 2)
    acc = torch.promote_types(h.dtype, torch.float32)
    return h.to(acc).mean((1, 2)).to(h.dtype)


def _fused_mode(p, h, freeze_at, num_stages):
    """The JAX package's TPU.FUSED_RES2 gates (resnet.py:239-257) on the
    raw stem-conv output h: "packed" (K5, then K6), "auto" (the unfused
    stem post-ops, then K6) or None (the unfused path). Its on_tpu gate is
    left out: the port runs the fused semantics on every device."""
    if not (cfg.TPU.FUSED_RES2 and freeze_at >= 2 and num_stages >= 1):
        return None
    Hp, Wp = h.shape[1], h.shape[2]
    ty = fk.pick_ty(Hp // 2, Wp // 2) if Hp % 2 == 0 and Wp % 2 == 0 \
        else None
    if ty is None or cfg.RESNETS.USE_GN or cfg.RESNETS.NUM_GROUPS != 1 or \
            not fk.res2_params_supported(p["res2"]):
        return None
    if h.dtype == torch.bfloat16 and Hp % (2 * ty) == 0 and Wp % 32 == 0:
        return "packed"
    return "auto"


def apply_body(p, x, num_stages):
    """x: (B, H, W, 3). Returns the per-stage outputs [res2, ..., resN].
    Stages <= RESNETS.FREEZE_AT (2-indexed; the stem is stage 1) take
    detached params. With TPU.REMAT_BODY each stage that takes part in
    the gradient runs under torch.utils.checkpoint: its activations are
    recomputed in the backward, with the same values and gradients."""
    check_body_supported()
    freeze_at = cfg.RESNETS.FREEZE_AT
    if freeze_at not in (0, 2, 3, 4, 5):
        raise ValueError("RESNETS.FREEZE_AT must be 0, 2, 3, 4 or 5, got "
                         "{}".format(freeze_at))
    conv1 = L.stop_gradient(p["conv1"]) if freeze_at >= 2 else p["conv1"]
    h = L.conv2d(conv1, x, stride=2, padding=3)
    fused = _fused_mode(p, h, freeze_at, num_stages)
    if fused == "packed":
        bn = L.stop_gradient(p["res_conv1_bn"])
        h = fk.stem_pool(h.contiguous(), bn["s"].float(), bn["b"].float())
    else:
        bn = p["res_conv1_bn"]
        if freeze_at >= 2:
            bn = L.stop_gradient(bn)
        h = L.relu(_norm(bn, h))
        h = L.max_pool(h, window=3, stride=2, padding=1)
    outs = []
    for s in range(num_stages):
        sp = p["res{}".format(s + 2)]
        if freeze_at >= s + 2:
            sp = L.stop_gradient(sp)
        if s == 0 and fused is not None:
            # freeze_at >= 2 (a gate), so no gradient reaches the stage.
            h = fk.fused_res2(h.contiguous(),
                              fk.fold_res2_weights(sp, h.dtype))
            outs.append(h)
            continue
        stride = 1 if s == 0 else 2
        if cfg.TPU.REMAT_BODY and torch.is_grad_enabled() and \
                _needs_grad(sp, h):
            h = checkpoint(apply_stage, sp, h, stride, use_reentrant=False)
        else:
            h = apply_stage(sp, h, stride)
        outs.append(h)
    return outs
