"""K5: stem post-ops (kernel csrc/stem_pool.cu) and K6: the fused res2 stage
(kernel csrc/fused_res2.cu), the TPU.FUSED_RES2 path of models/resnet.py.

stem_pool replaces detectron_tpu/ops/pallas/fused_stem_kernel.py ::
stem_pool_pack: AffineChannel in f32 (a rounded multiply, then a rounded
add), ReLU, a cast to bf16, then a 3x3 stride-2 max pool with pad 1, in one
pass. The TPU kernel also packs x pairs into 128 lanes; the port emits plain
NHWC, since only the values have to match.

fused_res2 replaces ::fused_res2: the whole res2 stage (three bottlenecks,
64 -> 256 channels, frozen BN folded into the conv weights) in one pass,
forward only; bf16 on bf16 tensor-core products, f32 on 3xTF32 ones (the
weights split by split_tf32 and laid out by pack_res2_weights_tf32). Its
rounding is the fused path's own, not the unfused stage's
(fused_stem_kernel.py:184-221, :269-325):
- folding: w' = cast(f32(w) * f32(s)) per output channel, the bias f32;
  block 0's branch2c and branch1 keep their weights and share the bias
  bc + bs;
- every conv accumulates the activation-dtype operands in f32, adds the
  f32 bias, applies ReLU and casts to the activation dtype;
- block 0: h0 = cast(relu(b0 . wc' + x . ws' + (bc + bs))), one f32 sum;
- blocks 1 and 2: c = cast(b . wc' + bc), then h = relu(c + h_prev) in the
  activation dtype;
- each 3x3 sees zeros outside the image (the fused 1x1 before it would
  give relu(bias) there).

pick_ty and res2_params_supported are the port's copies of the JAX
package's gates (:68, :83), which decide in models/resnet.py which of the
two roundings runs; res2_params_supported checks the bridged (OIHW) tree.
"""

import ctypes

import torch
import torch.nn.functional as F

from detectron_tpu_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # both kernels move 16-byte vectors


def pick_ty(h, w):
    """The JAX kernel's y-tile for a (h, w) post-pool canvas, or None where
    its static constraints fail (w % 16, h % 8 or h % 4); the port keeps it
    only as the gate that decides which path runs."""
    if w % 16 != 0:
        return None
    for ty in (8, 4):
        if h % ty == 0:
            return ty
    return None


def res2_params_supported(stage_params):
    """The canonical frozen res2 the kernels take: 3 bottlenecks, 64 -> 256
    with inner 64, ungrouped 3x3s, AffineChannel norm, on the bridged tree
    (OIHW conv weights)."""
    if len(stage_params) != 3:
        return False
    for i, bp in enumerate(stage_params):
        if "branch2a_bn" not in bp or "s" not in bp["branch2a_bn"]:
            return False  # GroupNorm trees carry different leaves
        wa, wb, wc = (bp[k]["w"] for k in ("branch2a", "branch2b",
                                           "branch2c"))
        if tuple(wa.shape) != (64, 64 if i == 0 else 256, 1, 1):
            return False
        if tuple(wb.shape) != (64, 64, 3, 3) or \
                tuple(wc.shape) != (256, 64, 1, 1):
            return False
        if (i == 0) != ("branch1" in bp):
            return False
    return True


def fold_conv_affine(conv_p, bn_p, dtype):
    """Fold a frozen-BN AffineChannel (y = conv(x) * s + b) into the conv:
    (w', b') with w' = cast(f32(w) * f32(s)) per output channel (OIHW axis
    0) in `dtype` and b' = f32(b) (+ f32(conv bias) * f32(s))."""
    s = bn_p["s"].float()
    w = conv_p["w"].float() * s[:, None, None, None]
    b = bn_p["b"].float()
    if "b" in conv_p:
        b = b + conv_p["b"].float() * s
    return w.to(dtype), b


def fold_res2_weights(stage_params, dtype):
    """The 3 bottlenecks' folded convs, one dict per block: wa, wb, wc (and
    ws, block 0's branch1) OIHW in `dtype`; ba, bb, bc f32, block 0's bc
    being bc + bs."""
    folded = []
    for i, bp in enumerate(stage_params):
        blk = {}
        for key, conv in (("a", "branch2a"), ("b", "branch2b"),
                          ("c", "branch2c")):
            blk["w" + key], blk["b" + key] = fold_conv_affine(
                bp[conv], bp[conv + "_bn"], dtype)
        if i == 0:
            blk["ws"], bs = fold_conv_affine(bp["branch1"], bp["branch1_bn"],
                                             dtype)
            blk["bc"] = blk["bc"] + bs
        folded.append(blk)
    return folded


# ---------------------------------------------------------------------------
# K5: stem post-ops
# ---------------------------------------------------------------------------

def stem_pool_plain(x, s, b):
    """Plain PyTorch version of K5. x (B, Hp, Wp, C) bf16 raw stem-conv
    output, s and b (C,) -> (B, Hp/2, Wp/2, C) bf16. Two torch ops, so the
    multiply and the add round separately, as in the kernel. F.max_pool2d
    pads with -inf; that equals the TPU kernel's zero padding, since the
    values are >= 0 and every window holds an image cell."""
    y = torch.relu(x.float() * s.float() + b.float()).to(torch.bfloat16)
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def stem_pool(x, s, b):
    """K5: AffineChannel (f32) + ReLU + bf16 cast + 3x3/2 max pool with pad
    1. x (B, Hp, Wp, C) bf16 contiguous, Hp and Wp even, C % 8 == 0; s and
    b (C,) float32. Returns (B, Hp/2, Wp/2, C) bf16 NHWC."""
    if x.device.type == "cpu":
        return stem_pool_plain(x, s, b)
    name = "stem_pool"
    if not all(t.is_cuda and t.device == x.device for t in (x, s, b)):
        raise ValueError(name + ": x, s and b must be on one CUDA device "
                         "(or x on the CPU)")
    if x.dtype != torch.bfloat16 or s.dtype != torch.float32 or \
            b.dtype != torch.float32:
        raise TypeError(name + " takes bf16 x and float32 s, b; got {} {} "
                        "{}".format(x.dtype, s.dtype, b.dtype))
    if x.requires_grad:
        raise ValueError(name + " is forward-only; x requires grad")
    B, Hp, Wp, C = x.shape
    if Hp % 2 or Wp % 2 or C % 8 or s.shape != (C,) or b.shape != (C,):
        raise ValueError(name + ": x {} (Hp, Wp even, C % 8 == 0) with s {} "
                         "and b {}".format(tuple(x.shape), tuple(s.shape),
                                           tuple(b.shape)))
    if not all(t.is_contiguous() for t in (x, s, b)) or \
            x.data_ptr() % _ALIGN:
        raise ValueError(name + " needs contiguous, 16-byte aligned inputs")
    fn = build.load("stem_pool.cu", "stem_pool_launch",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    out = torch.empty((B, Hp // 2, Wp // 2, C), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), B, Hp,
             Wp, C, stream)
    build.check(err, name)
    stem_pool.launches += int(out.numel() > 0)
    return out


# ---------------------------------------------------------------------------
# K6: the fused res2 stage
# ---------------------------------------------------------------------------

def fused_res2_plain(x, folded):
    """Plain PyTorch version of K6. x (B, H, W, 64) NHWC, folded from
    fold_res2_weights in x's dtype. Each conv runs on the dtype-valued
    operands upcast to f32 (f64 for an f64 x), so a bf16 stage rounds only
    where the kernel does (a bf16 torch conv would round otherwise)."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32

    def conv(h, w, pad=0):
        return F.conv2d(h.permute(0, 3, 1, 2).to(acc), w.to(acc), None, 1,
                        pad).permute(0, 2, 3, 1)

    def act(y, bias, relu=True):
        y = y + bias.to(acc)
        return (torch.relu(y) if relu else y).to(dt)

    h = x
    for i, blk in enumerate(folded):
        a = act(conv(h, blk["wa"]), blk["ba"])
        b = act(conv(a, blk["wb"], 1), blk["bb"])
        if i == 0:
            h = act(conv(b, blk["wc"]) + conv(h, blk["ws"]), blk["bc"])
        else:
            h = torch.relu(act(conv(b, blk["wc"]), blk["bc"], relu=False)
                           + h)
    return h


def pack_res2_weights(folded):
    """The kernel's operands: every folded weight as (Cout, kh, kw, Cin)
    (input channels contiguous), flattened and concatenated in the order
    wa0 wb0 wc0 ws0, wa1 wb1 wc1, wa2 wb2 wc2; the biases ba bb bc of each
    block concatenated as f32."""
    ws, bs = [], []
    for blk in folded:
        keys = ("wa", "wb", "wc", "ws") if "ws" in blk else ("wa", "wb", "wc")
        ws += [blk[k].permute(0, 2, 3, 1).reshape(-1) for k in keys]
        bs += [blk[k] for k in ("ba", "bb", "bc")]
    return torch.cat(ws), torch.cat(bs).float()


def split_tf32(w):
    """(head, tail) of float32 w for 3xTF32 products: head is w rounded to
    TF32 (10 mantissa bits, to nearest, ties away from zero: the kernel's
    cvt.rna.tf32.f32), tail the remainder w - head rounded the same way.
    head + tail is w within 2^-22 |w|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    head = rna(w)
    return head, rna(w - head)


def res2_chunk_order(folded):
    """The f32 kernel's weight chunks in the order it consumes them, (104,
    64, 32): each a slice of 64 output x 32 input channels of a conv's
    (Cout, K) matrix, K in (kh, kw, Cin) order. Per block: branch2a,
    branch2b (32 inputs of one tap a chunk), then per 64 output channels
    branch2c's slices and, in block 0, branch1's after them (one sum)."""
    chunks = []
    for blk in folded:
        mats = {k: t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, 32)
                for k, t in blk.items() if k[0] == "w"}
        chunks += [mats["wa"].transpose(0, 1), mats["wb"].transpose(0, 1)]
        c = torch.stack([mats[k].reshape(4, 64, -1, 32)
                         for k in ("wc", "ws") if k in mats], 1)
        chunks.append(c.permute(0, 1, 3, 2, 4).reshape(-1, 64, 32))
    return torch.cat(chunks)


# pack_res2_weights_tf32's gather maps, by device and weight shapes.
_CHUNK_INDEX = {}


def pack_res2_weights_tf32(folded):
    """The f32 kernel's operands: the 104 chunks of res2_chunk_order, each
    4,096 floats: for output channel n (64 rows), k-step s (8 inputs) and
    lane t of 4, the heads of inputs 8s + 2t and 8s + 2t + 1, then their
    tails (split_tf32); and the biases as pack_res2_weights gives them.
    One gather through a cached map of element indices takes the chunks
    from the concatenated weights (a few kernel launches a call)."""
    weights = [t for blk in folded for k, t in blk.items() if k[0] == "w"]
    key = (weights[0].device, tuple(tuple(t.shape) for t in weights))
    index = _CHUNK_INDEX.get(key)
    if index is None:
        flat = torch.arange(sum(t.numel() for t in weights),
                            device=key[0])
        views = iter(flat.split([t.numel() for t in weights]))
        index = _CHUNK_INDEX[key] = res2_chunk_order(
            [{k: next(views).view(t.shape) for k, t in blk.items()
              if k[0] == "w"} for blk in folded]).reshape(-1)
    chunks = torch.cat([t.reshape(-1) for t in weights])[index]
    head, tail = split_tf32(chunks.view(-1, 64, 4, 4, 2))
    bias = torch.cat([blk[k] for blk in folded for k in ("ba", "bb", "bc")])
    return torch.cat([head, tail], -1).reshape(-1), bias.float()


def _check_folded(folded, x):
    shapes = [{"wa": (64, 64 if i == 0 else 256, 1, 1), "wb": (64, 64, 3, 3),
               "wc": (256, 64, 1, 1), "ba": (64,), "bb": (64,),
               "bc": (256,)} for i in range(3)]
    shapes[0]["ws"] = (256, 64, 1, 1)
    if len(folded) != 3 or any(set(blk) != set(shp)
                               for blk, shp in zip(folded, shapes)):
        raise ValueError("fused_res2: folded weights must come from "
                         "fold_res2_weights (3 blocks)")
    for blk, shp in zip(folded, shapes):
        for k, t in blk.items():
            if tuple(t.shape) != shp[k]:
                raise ValueError("fused_res2: {} has shape {}, expected {}"
                                 .format(k, tuple(t.shape), shp[k]))
            if t.device != x.device:
                raise ValueError("fused_res2: x and the folded weights must "
                                 "be on one CUDA device (or all on the CPU)")
            if t.dtype != (x.dtype if k[0] == "w" else torch.float32):
                raise TypeError("fused_res2: {} is {}; weights take x's "
                                "dtype {}, biases float32".format(
                                    k, t.dtype, x.dtype))
            if t.requires_grad:
                raise ValueError("fused_res2 is forward-only; {} requires "
                                 "grad".format(k))


def fused_res2(x, folded):
    """K6: the res2 stage. x (B, H, W, 64) bf16 or f32, NHWC contiguous;
    folded from fold_res2_weights(stage, x.dtype). Returns (B, H, W, 256)
    in x's dtype. Forward only: raises where x or a weight requires grad
    (res2 is frozen wherever models/resnet.py takes this path)."""
    if x.requires_grad:
        raise ValueError("fused_res2 is forward-only; x requires grad")
    if x.device.type == "cpu":
        return fused_res2_plain(x, folded)
    name = "fused_res2"
    if not x.is_cuda:
        raise ValueError(name + ": x must be on a CUDA device or the CPU")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(name + " takes bfloat16 or float32, got {}".format(
            x.dtype))
    if x.dim() != 4 or x.shape[-1] != 64:
        raise ValueError(name + ": x must be (B, H, W, 64), got {}".format(
            tuple(x.shape)))
    if not x.is_contiguous() or x.data_ptr() % _ALIGN:
        raise ValueError(name + " needs a contiguous, 16-byte aligned x")
    _check_folded(folded, x)
    w, b = (pack_res2_weights_tf32 if x.dtype == torch.float32
            else pack_res2_weights)(folded)
    B, H, W, _ = x.shape
    fn = build.load("fused_res2.cu", "fused_res2_launch",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    out = torch.empty((B, H, W, 256), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H,
             W, _DTYPE_CODES[x.dtype], stream)
    build.check(err, name)
    fused_res2.launches += int(out.numel() > 0)
    return out


stem_pool.launches = 0
fused_res2.launches = 0
