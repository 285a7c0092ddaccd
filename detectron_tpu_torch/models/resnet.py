"""ResNet / ResNeXt conv bodies and the C4 models' res5 RoI head,
Detectron semantics (port of detectron_tpu/models/resnet.py: the norm
:40-56, bottlenecks and stages :80-116, the channel plan :123-130, the
s2d stems :154-207, apply_body :210-300 with the TPU.FUSED_RES2 branch
:232-291 and TPU.REMAT_BODY :292-297, apply_roi_conv5_head :307-325). A
conv5 body (res2-res5) feeds an FPN; a conv4 body (res2-res4, stride 16)
feeds a C4 model, whose box head runs res5 on each RoI's pooled features.
Depths 50, 101 and 152 differ only in BLOCK_COUNTS.

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
the CPU their plain versions. RESNETS.RES5_DILATION d != 1 runs res5
(of a body, the res5 box head or the v0up mask head) at stride 1 with
d-dilated 3x3 convs. Where the channel epilogue kernel takes them
(ops/cuda/channel_epilogue.py's `fuses`: a CUDA tensor, bf16 or f32,
C % 8 == 0, no autograd graph to record) each AffineChannel runs with the
ReLU after it, and branch2c's with the shortcut (branch1's affine
included) and the ReLU, as one pass of that kernel into the conv's fresh
output, in float32 with one rounding: every inference path, and the
frozen stages of a training step. GN bodies and stages that train keep
the torch ops. Under TPU.FUSED_RES2, K5 and K6 keep their own epilogues;
the "auto" stem post-ops and res3-res5 take this kernel as without it.
TPU.S2D_STEM runs the 7x7/s2
stem conv as a 4x4/s1 conv on 2x2 space-to-depth blocks of the padded
image, the same sums in another order; with TPU.S2D_INPUT the caller
feeds those blocks (utils/blob.space_to_depth) and the stem takes them as
they are.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L
from detectron_tpu_torch.ops.cuda import channel_epilogue as ce
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


def _norm(p, x):
    """The norm of a body or res5 head: GroupNorm with RESNETS.USE_GN
    (params that train), else AffineChannel with frozen (detached)
    params."""
    if cfg.RESNETS.USE_GN:
        return L.group_norm_cfg(p, x)
    return L.affine_channel(L.stop_gradient(p), x)


def _norm_relu(p, h, sc=None, sc_bn=None):
    """The norm of the conv output h, plus the shortcut sc (after its own
    norm sc_bn, where given), then ReLU: one channel_epilogue pass into h
    where it fuses (AffineChannel), else the torch ops."""
    if not cfg.RESNETS.USE_GN and ce.fuses(h, sc):
        return ce.channel_epilogue(
            h.contiguous(), p["s"], p["b"],
            None if sc is None else sc.contiguous(),
            *((sc_bn["s"], sc_bn["b"]) if sc_bn else ()), relu=True,
            inplace=True)
    h = _norm(p, h)
    if sc is not None:
        h = h + (_norm(sc_bn, sc) if sc_bn else sc)
    return L.relu(h)


def apply_bottleneck(p, x, stride, dilation=1):
    s1 = stride if cfg.RESNETS.STRIDE_1X1 else 1
    s3 = 1 if cfg.RESNETS.STRIDE_1X1 else stride
    h = L.conv2d(p["branch2a"], x, stride=s1, padding=0)
    h = _norm_relu(p["branch2a_bn"], h)
    h = L.conv2d(p["branch2b"], h, stride=s3, padding=dilation,
                 dilation=dilation, groups=cfg.RESNETS.NUM_GROUPS)
    h = _norm_relu(p["branch2b_bn"], h)
    h = L.conv2d(p["branch2c"], h, stride=1, padding=0)
    if "branch1" in p:
        sc = L.conv2d(p["branch1"], x, stride=stride, padding=0)
        return _norm_relu(p["branch2c_bn"], h, sc, p["branch1_bn"])
    return _norm_relu(p["branch2c_bn"], h, x)


def apply_stage(blocks, x, stride, dilation=1):
    """A stage's bottleneck blocks; the first one strides."""
    for i, bp in enumerate(blocks):
        x = apply_bottleneck(bp, x, stride if i == 0 else 1, dilation)
    return x


def res5_stride_dilation():
    """(stride, dilation) of a res5 stage, the body's or a RoI head's: (1,
    RESNETS.RES5_DILATION) when that is not 1, else (2, 1)."""
    d = cfg.RESNETS.RES5_DILATION
    return (1, d) if d != 1 else (2, 1)


def _needs_grad(stage_params, x):
    return x.requires_grad or any(
        t.requires_grad for t in L.leaves(stage_params))


def apply_roi_conv5_head(p, roi_feat):
    """ResNet_roi_conv5_head: roi_feat (R, P, P, 1024) -> res5 at stride 2
    (stride 1 and dilated convs with RES5_DILATION) -> the mean over its
    spatial cells, (R, 2048). The mean sums in at least float32, as
    jnp.mean does for bfloat16, and returns the input dtype."""
    h = apply_stage(p["res5"], roi_feat, *res5_stride_dilation())
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


def _s2d_kernel(w):
    """The 7x7 stem kernel (O, C, 7, 7) as the 4x4 kernel (O, 4C, 4, 4) of
    the blocked input: zero-padded to 8x8 with one leading row and
    column, input channels in (dy, dx, c) order (JAX resnet.py:175-177)."""
    O, C = w.shape[:2]
    wp = F.pad(w, (1, 0, 1, 0)).reshape(O, C, 4, 2, 4, 2)
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, 4, 4)


def _s2d_blocked_stem_conv(conv1, x2):
    """The stem conv on blocked input x2 (B, (H+8)/2, (W+8)/2, 12) from
    utils/blob.space_to_depth: a VALID 4x4/s1 conv, cropped to (H/2, W/2)
    (JAX resnet.py:187-207)."""
    _, P, Q, _ = x2.shape
    y = L.conv2d({"w": _s2d_kernel(conv1["w"])}, x2, stride=1, padding=0)
    y = y[:, :P - 4, :Q - 4, :]
    if "b" in conv1:
        y = y + conv1["b"].to(y.dtype)
    return y


def space_to_depth(x):
    """(B, H, W, C) -> (B, (H+8)/2, (W+8)/2, 4C): pad 4 a side, then 2x2
    blocks with channels in (dy, dx, c) order; utils/blob.space_to_depth
    on a tensor."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError("space_to_depth needs an even canvas, got "
                         "{} x {}".format(H, W))
    xp = F.pad(x, (0, 0, 4, 4, 4, 4))
    P, Q = (H + 8) // 2, (W + 8) // 2
    return xp.reshape(B, P, 2, Q, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, P, Q, 4 * C)


def stem_conv(conv1, x):
    """The 7x7/s2/p3 stem conv: on the blocked input with TPU.S2D_INPUT, as
    the blocked conv of the image with TPU.S2D_STEM (JAX resnet.py:
    154-184), else directly."""
    if cfg.TPU.S2D_INPUT:
        return _s2d_blocked_stem_conv(conv1, x)
    if cfg.TPU.S2D_STEM:
        return _s2d_blocked_stem_conv(conv1, space_to_depth(x))
    return L.conv2d(conv1, x, stride=2, padding=3)


def apply_body(p, x, num_stages):
    """x: (B, H, W, 3), or its space_to_depth blocks with TPU.S2D_INPUT.
    Returns the per-stage outputs [res2, ..., resN].
    Stages <= RESNETS.FREEZE_AT (2-indexed; the stem is stage 1) take
    detached params. With TPU.REMAT_BODY each stage that takes part in
    the gradient runs under torch.utils.checkpoint: its activations are
    recomputed in the backward, with the same values and gradients."""
    freeze_at = cfg.RESNETS.FREEZE_AT
    if freeze_at not in (0, 2, 3, 4, 5):
        raise ValueError("RESNETS.FREEZE_AT must be 0, 2, 3, 4 or 5, got "
                         "{}".format(freeze_at))
    conv1 = L.stop_gradient(p["conv1"]) if freeze_at >= 2 else p["conv1"]
    h = stem_conv(conv1, x)
    fused = _fused_mode(p, h, freeze_at, num_stages)
    if fused == "packed":
        bn = L.stop_gradient(p["res_conv1_bn"])
        h = fk.stem_pool(h.contiguous(), bn["s"].float(), bn["b"].float())
    else:
        bn = p["res_conv1_bn"]
        if freeze_at >= 2:
            bn = L.stop_gradient(bn)
        h = _norm_relu(bn, h)
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
        stride, dil = res5_stride_dilation() if s == 3 else \
            (1 if s == 0 else 2, 1)
        if cfg.TPU.REMAT_BODY and torch.is_grad_enabled() and \
                _needs_grad(sp, h):
            h = checkpoint(apply_stage, sp, h, stride, dil,
                           use_reentrant=False)
        else:
            h = apply_stage(sp, h, stride, dil)
        outs.append(h)
    return outs
