"""ResNet conv body and the C4 models' res5 RoI head, Detectron semantics
(port of detectron_tpu/models/resnet.py: resnet.py:45-56, :80-116 and
:210-300, with the TPU.FUSED_RES2 branch :232-291, and
apply_roi_conv5_head :307-325). A conv5 body (res2-res5) feeds an FPN; a
conv4 body (res2-res4, stride 16) feeds a C4 model, whose box head runs
res5 on each RoI's pooled features.

Frozen BN is AffineChannel, whose params never get a gradient; the stem
and the stages up to RESNETS.FREEZE_AT are frozen too (their params enter
the forward detached, as stop_gradient does in the JAX package).
RESNETS.STRIDE_1X1 picks the Caffe (stride on the 1x1) or torch (stride on
the 3x3) bottleneck. With TPU.FUSED_RES2, the stem post-ops and res2 run
through kernels K5 and K6 (ops/cuda/fused_stem_kernel.py) under the JAX
package's gates, with the fused path's own rounding; on the CPU their
plain versions. GroupNorm, ResNeXt groups, res5 dilation (of a body or
of the res5 head) and the s2d stems (S2D_STEM, S2D_INPUT) are not ported
yet: check_body_supported raises on them.
"""

import torch

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


def check_body_supported():
    off = {"RESNETS.USE_GN": cfg.RESNETS.USE_GN,
           "RESNETS.NUM_GROUPS != 1": cfg.RESNETS.NUM_GROUPS != 1,
           "RESNETS.WIDTH_PER_GROUP != 64": cfg.RESNETS.WIDTH_PER_GROUP != 64,
           "RESNETS.RES5_DILATION != 1": cfg.RESNETS.RES5_DILATION != 1,
           "TPU.S2D_STEM": cfg.TPU.S2D_STEM,
           "TPU.S2D_INPUT": cfg.TPU.S2D_INPUT}
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(
            "not ported yet (ROADMAP Queue A, A7): "
            + ", ".join(on))


def _affine(p, x):
    """AffineChannel with frozen (detached) params."""
    return L.affine_channel(L.stop_gradient(p), x)


def apply_bottleneck(p, x, stride):
    s1 = stride if cfg.RESNETS.STRIDE_1X1 else 1
    s3 = 1 if cfg.RESNETS.STRIDE_1X1 else stride
    h = L.conv2d(p["branch2a"], x, stride=s1, padding=0)
    h = L.relu(_affine(p["branch2a_bn"], h))
    h = L.conv2d(p["branch2b"], h, stride=s3, padding=1)
    h = L.relu(_affine(p["branch2b_bn"], h))
    h = L.conv2d(p["branch2c"], h, stride=1, padding=0)
    h = _affine(p["branch2c_bn"], h)
    if "branch1" in p:
        sc = _affine(p["branch1_bn"],
                     L.conv2d(p["branch1"], x, stride=stride, padding=0))
    else:
        sc = x
    return L.relu(h + sc)


def apply_stage(blocks, x, stride):
    """A stage's bottleneck blocks; the first one strides."""
    for i, bp in enumerate(blocks):
        x = apply_bottleneck(bp, x, stride if i == 0 else 1)
    return x


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
    detached params."""
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
        h = L.relu(_affine(p["res_conv1_bn"], h))
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
        h = apply_stage(sp, h, 1 if s == 0 else 2)
        outs.append(h)
    return outs
