"""Dotted-name -> head functions (port of detectron_tpu/models/registry.py
:1-161; reference: lib/modeling/model_builder.py :: get_func).

A cfg string such as 'fast_rcnn_heads.roi_2mlp_head' names a head. It
resolves to a HeadFuncs record:

  init(rng, dim_in[, roi_res]) -> params   (numpy tree, rng a RandomState)
  apply(params, roi_feat) -> features      (torch, NHWC RoI features)
  out_dim() -> int                         (the features' width)

Resolution order, as in the JAX package:
  1. the explicit table of every shipped head name;
  2. the convention fallback: 'module.symbol' imports
     detectron_tpu_torch.models.<module> (aliases: FPN -> fpn, ResNet ->
     resnet) and takes its init_<symbol> and apply_<symbol> (and
     out_dim_<symbol>, a function or an int, where it has one), so a new
     head needs those functions and a cfg change, no edit of the model
     builder.
An unknown name raises ValueError('Failed to find function: <name>'); an
empty name gives None.
"""

import functools
import importlib
import inspect

from detectron_tpu_torch.core.config import cfg


class HeadFuncs:
    """A resolved head: its init and apply functions and its output
    width (by default FAST_RCNN.MLP_HEAD_DIM)."""

    def __init__(self, init, apply, out_dim=None):
        self.init = init
        self.apply = apply
        self.out_dim = out_dim or (lambda: cfg.FAST_RCNN.MLP_HEAD_DIM)


_REGISTRY = {}

_MODULE_ALIASES = {"FPN": "fpn", "ResNet": "resnet"}

MLP_HEAD = "fast_rcnn_heads.roi_2mlp_head"
XCONV_HEAD = "fast_rcnn_heads.roi_Xconv1fc_head"
XCONV_GN_HEAD = "fast_rcnn_heads.roi_Xconv1fc_gn_head"
C4_HEAD = "ResNet.ResNet_roi_conv5_head"
# The shipped mask heads: n 3x3 convs then a deconv (v1up4convs and its
# GroupNorm twin, v1up with two), or res5 then a deconv (v0up with its own
# res5, v0upshare with the C4 box head's).
MASK_HEADS = tuple("mask_rcnn_heads.mask_rcnn_fcn_head_" + n for n in (
    "v1up4convs", "v1up4convs_gn", "v1up", "v0up", "v0upshare"))
POSE_HEAD = "keypoint_rcnn_heads.roi_pose_head_v1convX"


def register(name, **kw):
    """Register a head factory under its dotted name."""

    def deco(make):
        _REGISTRY[name] = (make, kw)
        return make

    return deco


def _adapt_init(fn):
    """Call fn with as many of (rng, dim_in, roi_res) as it takes: a head
    may take no roi_res (the mask heads do not)."""
    try:
        n = len([p for p in inspect.signature(fn).parameters.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        n = 3

    def init(rng, dim_in, roi_res=None):
        return fn(*(rng, dim_in, roi_res)[:n])

    return init


def get_func(func_name):
    """The HeadFuncs of a cfg head name; None for an empty name."""
    if not func_name:
        return None
    if func_name in _REGISTRY:
        make, kw = _REGISTRY[func_name]
        return make(**kw)
    try:
        mod_name, sym = func_name.rsplit(".", 1)
        mod = importlib.import_module(
            "detectron_tpu_torch.models."
            + _MODULE_ALIASES.get(mod_name, mod_name))
        init = getattr(mod, "init_" + sym)
        apply = getattr(mod, "apply_" + sym)
    except (ValueError, ImportError, AttributeError):
        raise ValueError("Failed to find function: %s" % func_name)
    out_dim = getattr(mod, "out_dim_" + sym, None)
    if out_dim is not None and not callable(out_dim):
        out_dim = functools.partial(int, out_dim)
    return HeadFuncs(_adapt_init(init), apply, out_dim=out_dim)


@register(MLP_HEAD)
def _roi_2mlp():
    from detectron_tpu_torch.models import fast_rcnn_heads as f
    from detectron_tpu_torch.models import init as i

    return HeadFuncs(i.init_roi_2mlp_head, f.apply_roi_2mlp_head)


@register(XCONV_HEAD, use_gn=False)
@register(XCONV_GN_HEAD, use_gn=True)
def _roi_xconv(use_gn):
    from detectron_tpu_torch.models import fast_rcnn_heads as f
    from detectron_tpu_torch.models import init as i

    return HeadFuncs(
        lambda rng, dim_in, roi_res: i.init_xconv1fc_head(
            rng, dim_in, roi_res, use_gn),
        f.apply_roi_Xconv1fc_head)


@register(C4_HEAD)
def _roi_conv5():
    from detectron_tpu_torch.models import init as i
    from detectron_tpu_torch.models import resnet

    return HeadFuncs(
        lambda rng, dim_in, roi_res=None: {"res5": i.init_res5_head(
            rng, dim_in)},
        resnet.apply_roi_conv5_head, out_dim=lambda: 2048)


def _register_mask(name):
    @register(name, head_name=name)
    def _mk(head_name):
        from detectron_tpu_torch.models import init as i
        from detectron_tpu_torch.models import mask_rcnn_heads as m

        return HeadFuncs(
            lambda rng, dim_in, roi_res=None: i.init_mask_head(
                rng, dim_in, head_name),
            m.apply_mask_head, out_dim=lambda: cfg.MRCNN.DIM_REDUCED)


for _n in MASK_HEADS:
    _register_mask(_n)


@register(POSE_HEAD)
def _pose_v1convx():
    from detectron_tpu_torch.models import init as i
    from detectron_tpu_torch.models import keypoint_rcnn_heads as k

    return HeadFuncs(
        lambda rng, dim_in, roi_res=None: i.init_pose_head(rng, dim_in),
        k.apply_pose_head, out_dim=lambda: cfg.KRCNN.CONV_HEAD_DIM)
