"""ResNet conv body, Detectron semantics (port of detectron_tpu/models/
resnet.py, its XLA path: resnet.py:80-116 and :210-300).

Frozen BN is AffineChannel; RESNETS.STRIDE_1X1 picks the Caffe (stride on
the 1x1) or torch (stride on the 3x3) bottleneck. GroupNorm, ResNeXt
groups, res5 dilation and the TPU-only stems (S2D_STEM, S2D_INPUT,
FUSED_RES2) are not ported yet: check_body_supported raises on them.
"""

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import layers as L

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
           "TPU.S2D_INPUT": cfg.TPU.S2D_INPUT,
           "TPU.FUSED_RES2": cfg.TPU.FUSED_RES2}
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(
            "not ported yet (ROADMAP Queue A item 11 / Queue B): "
            + ", ".join(on))


def apply_bottleneck(p, x, stride):
    s1 = stride if cfg.RESNETS.STRIDE_1X1 else 1
    s3 = 1 if cfg.RESNETS.STRIDE_1X1 else stride
    h = L.conv2d(p["branch2a"], x, stride=s1, padding=0)
    h = L.relu(L.affine_channel(p["branch2a_bn"], h))
    h = L.conv2d(p["branch2b"], h, stride=s3, padding=1)
    h = L.relu(L.affine_channel(p["branch2b_bn"], h))
    h = L.conv2d(p["branch2c"], h, stride=1, padding=0)
    h = L.affine_channel(p["branch2c_bn"], h)
    if "branch1" in p:
        sc = L.affine_channel(
            p["branch1_bn"], L.conv2d(p["branch1"], x, stride=stride,
                                      padding=0))
    else:
        sc = x
    return L.relu(h + sc)


def apply_body(p, x, num_stages):
    """x: (B, H, W, 3). Returns the per-stage outputs [res2, ..., resN]."""
    check_body_supported()
    h = L.conv2d(p["conv1"], x, stride=2, padding=3)
    h = L.relu(L.affine_channel(p["res_conv1_bn"], h))
    h = L.max_pool(h, window=3, stride=2, padding=1)
    outs = []
    for s in range(num_stages):
        for i, bp in enumerate(p["res{}".format(s + 2)]):
            h = apply_bottleneck(bp, h, (1 if s == 0 else 2) if i == 0 else 1)
        outs.append(h)
    return outs
