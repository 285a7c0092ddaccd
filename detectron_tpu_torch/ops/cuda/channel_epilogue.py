"""A convolution's per-channel epilogue in one pass (kernel
csrc/channel_epilogue.cu): for y, a conv's output with C channels on its
last axis,

    out = [relu]( y * s + b  [+ r * s_r + b_r | + r] )

s and b (C,) per-channel (s absent for a conv bias alone), r a bottleneck's
shortcut (the identity, or branch1's conv output with its own affine s_r,
b_r). The math runs in float32, each multiply and add rounding on its own
in this order, with one rounding to y's dtype at the end. It replaces no
Pallas kernel: on the TPU, XLA fuses the frozen AffineChannel, the bias,
the residual add and the ReLU into the convolution, while the eager port
ran each as its own elementwise kernel.

models/resnet.py and models/layers.py call it where `fuses` says so, and
run their torch ops otherwise.
"""

import ctypes
import functools

import torch

from detectron_tpu_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # the kernel moves 16-byte vectors


def fuses(y, *others):
    """Whether a conv's epilogue over y (and the tensors `others`: a
    shortcut, a bias that may train) runs through channel_epilogue: y on a
    CUDA device, bfloat16 or float32, C % 8 == 0 channels, and no autograd
    graph to record (grad mode off, or nothing requires grad)."""
    return (y.is_cuda and y.dtype in _DTYPE_CODES and y.shape[-1] % 8 == 0
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (y,) + others if t is not None)))


def channel_epilogue_plain(y, s, b, r=None, s_r=None, b_r=None, relu=False):
    """Plain PyTorch version: the same float32 ops (float64 for a float64
    y) in the same order, then y's dtype."""
    acc = torch.promote_types(y.dtype, torch.float32)
    t = y.to(acc)
    t = t * s.to(acc) + b.to(acc) if s is not None else t + b.to(acc)
    if r is not None:
        r = r.to(acc)
        t = t + (r * s_r.to(acc) + b_r.to(acc) if s_r is not None else r)
    return (torch.relu(t) if relu else t).to(y.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t):
    return t.is_contiguous() and t.data_ptr() % _ALIGN == 0


def channel_epilogue(y, s, b, r=None, s_r=None, b_r=None, relu=False,
                     inplace=False):
    """out = [relu](y * s + b [+ r * s_r + b_r | + r]) in one pass. y (...,
    C) contiguous, bf16 or float32, C % 8 == 0; r as y or None; s (or None
    for a bias alone, which takes no r), b, s_r and b_r (C,) (s_r and b_r
    both or neither, and only with r). The kernel reads the (C,) vectors
    as they are where they are contiguous and aligned and share one dtype,
    float32 or y's; otherwise as float32 copies. With `inplace` the result
    goes into y, which is returned; the caller vouches that nothing else
    reads y. Forward only: raises where y or r requires grad."""
    if (s_r is None) != (b_r is None) or (r is None and s_r is not None) \
            or (s is None and r is not None):
        raise ValueError("channel_epilogue: s_r and b_r come together, and "
                         "only with r; a bias alone takes no r")
    if y.device.type == "cpu":
        out = channel_epilogue_plain(y, s, b, r, s_r, b_r, relu)
        return y.copy_(out) if inplace else out
    name = "channel_epilogue"
    code = _DTYPE_CODES.get(y.dtype)
    if code is None or not y.is_cuda:
        raise TypeError(name + " takes CUDA bfloat16 or float32, got {} "
                        "{}".format(y.device, y.dtype))
    C = y.shape[-1] if y.dim() else 0
    if C == 0 or C % 8 or not _aligned(y):
        raise ValueError(name + ": y {} needs C % 8 == 0 channels on its "
                         "last axis, contiguous and 16-byte aligned".format(
                             tuple(y.shape)))
    if y.requires_grad or (r is not None and r.requires_grad):
        raise ValueError(name + " is forward-only; y or r requires grad")
    if r is not None and (r.shape != y.shape or r.dtype != y.dtype
                          or r.device != y.device or not _aligned(r)):
        raise ValueError(name + ": r {} {} must match y {} {}, contiguous "
                         "and 16-byte aligned".format(
                             tuple(r.shape), r.dtype, tuple(y.shape),
                             y.dtype))
    vecs = [t for t in (s, b, s_r, b_r) if t is not None]
    for t in vecs:
        if t.shape != (C,) or t.device != y.device:
            raise ValueError(name + ": a (C,) vector has shape {} on {}, "
                             "expected ({},) on {}".format(
                                 tuple(t.shape), t.device, C, y.device))
    vdtype = b.dtype
    if vdtype not in (torch.float32, y.dtype) or not all(
            t.dtype == vdtype and _aligned(t) for t in vecs):
        vdtype = torch.float32
        s, b, s_r, b_r = (None if t is None else
                          t.detach().to(torch.float32, copy=True)
                          for t in (s, b, s_r, b_r))
    out = y if inplace else torch.empty_like(y)
    fn = build.load("channel_epilogue.cu", "channel_epilogue_launch",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int64]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(y.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(y.data_ptr(), ptr(s), b.data_ptr(), ptr(r), ptr(s_r), ptr(b_r),
             out.data_ptr(), y.numel(), C, code, _DTYPE_CODES[vdtype],
             int(relu), _sm_count(y.device.index), stream)
    build.check(err, name)
    channel_epilogue.launches += int(y.numel() > 0)
    return out


channel_epilogue.launches = 0
