"""Stage-wise golden-tensor dump and diff (the port's twin of
tools/golden_compare.py).

1) DUMP the activations of every stage of the detection pipeline for one
   image:

       python -m detectron_tpu_torch.tools.golden_compare \\
           --cfg configs/baselines/e2e_mask_rcnn_R-50-FPN_1x.yaml \\
           [--pkl model_final.pkl | --ckpt DIR] [--image img.ppm] \\
           --out stages.npz [--device cuda|cpu] [--set KEY VALUE ...]

   The stages and their keys are the JAX tool's: data, im_scale,
   res2..res5, fpn_p2..fpn_p6, rpn_cls_logits_l*, rpn_bbox_pred_l*,
   rpn_rois, rpn_roi_scores, rpn_roi_valid, roi_feat, box_head_feat,
   cls_prob, bbox_pred and det_* (boxes, scores, classes, valid,
   mask_probs), all float32 and NHWC, so a dump of this port and a dump of
   the JAX package diff key for key.

2) DIFF two dumps (this port against the JAX package, a reference-side
   dump with the same keys, or two builds of the port):

       python -m detectron_tpu_torch.tools.golden_compare --diff A.npz B.npz

   Each shared stage's max abs difference over max |A| is held to --rtol;
   the first failing stage is where to look upstream of. A 4-D tensor of
   an NCHW dump is transposed to NHWC where that makes its shape match.

Weights: the seeded numpy init (models/init.py), or a Detectron .pkl
(--pkl, utils/detectron_weight_helper.py), or a checkpoint in the JAX
package's format (--ckpt, utils/net.py). Images are read with
utils/image_io.imread: binary PPM (P6) without OpenCV, every other format
(JPEG, PNG, ...) through cv2, which must then be installed. Without
--image the tool dumps a seeded 480 x 640 noise image, as the JAX tool
does.
"""

import argparse
import sys

import numpy as np
import torch

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def _np(t):
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


@torch.no_grad()
def dump_stages(params, im):
    """The full detection pipeline on ONE image (H, W, 3) uint8 BGR, with
    a bridged params tree (its device is the run's): an ordered dict of
    per-stage float32 numpy activations."""
    from detectron_tpu_torch.core import test as test_core
    from detectron_tpu_torch.core import test_aug
    from detectron_tpu_torch.models import fpn as fpn_mod
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.models import resnet

    init_mod.check_model_supported()
    device = params["body"]["conv1"]["w"].device
    blob, scale, im_info = test_aug.prep_on_device(
        im, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, device)
    out = {"data": _np(blob), "im_scale": np.float32(scale)}

    _, num_stages = resnet.body_spec(cfg.MODEL.CONV_BODY)
    body_outs = resnet.apply_body(params["body"], blob.to(mb.compute_dtype()),
                                  num_stages)
    for i, o in enumerate(body_outs):
        out["res{}".format(i + 2)] = o
    if cfg.FPN.FPN_ON:
        features, scales = fpn_mod.apply_fpn(params["fpn"], body_outs)
        for f, s in zip(features, scales):
            out["fpn_p{}".format(int(round(np.log2(1.0 / s))))] = f
    else:
        features, scales = [body_outs[-1]], [1.0 / 16.0]
    rpn_outs = mb.forward_rpn(params, features)
    for li, (cl, bp) in enumerate(rpn_outs):
        out["rpn_cls_logits_l{}".format(li)] = cl
        out["rpn_bbox_pred_l{}".format(li)] = bp
    rois, roi_scores, roi_valid = mb.generate_proposals(
        rpn_outs, features, im_info, training=False)
    out["rpn_rois"] = rois
    out["rpn_roi_scores"] = roi_scores
    out["rpn_roi_valid"] = roi_valid
    out["roi_feat"] = mb.roi_feature_transform(
        features, scales, rois, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
        cfg.FAST_RCNN.ROI_XFORM_METHOD)
    cls_logits, bbox_pred, box_feat = mb.forward_box_outputs(
        params, features, scales, rois)
    out["box_head_feat"] = box_feat
    out["cls_prob"] = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    out["bbox_pred"] = bbox_pred
    det = test_core._detect_tail(params, features, scales, rois, roi_valid,
                                 im_info)
    for k, v in det.items():
        out["det_" + k] = v
    return {k: _np(v) if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def _load_params(args, device):
    """The numpy tree of --pkl, --ckpt or the seeded init, bridged to
    `device` in the compute dtype."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.models import model_builder as mb

    params = init_mod.init_model(args.seed)
    if args.pkl:
        from detectron_tpu_torch.utils import detectron_weight_helper as dwh
        params = dwh.load_detectron_weight(params, args.pkl,
                                           strict=not args.lenient)
        logger.info("loaded Detectron pkl %s", args.pkl)
    elif args.ckpt:
        from detectron_tpu_torch.utils import net as net_utils
        params = net_utils.load_ckpt_params(args.ckpt)
        logger.info("loaded checkpoint %s", args.ckpt)
    else:
        logger.info("no weights given: dumping from random init (seed %d)",
                    args.seed)
    return bridge.to_torch(params, device, mb.compute_dtype())


def _maybe_nhwc(a, b):
    """Transpose `b` NCHW->NHWC if that makes it match `a`'s shape."""
    if a.ndim == 4 and b.ndim == 4 and a.shape != b.shape and \
            a.shape == (b.shape[0], b.shape[2], b.shape[3], b.shape[1]):
        return np.transpose(b, (0, 2, 3, 1))
    return b


def diff_dumps(path_a, path_b, rtol):
    a = np.load(path_a)
    b = np.load(path_b)
    keys_a, keys_b = set(a.files), set(b.files)
    shared = [k for k in a.files if k in keys_b]
    only_a = sorted(keys_a - keys_b)
    only_b = sorted(keys_b - keys_a)
    if only_a:
        print("only in {}: {}".format(path_a, only_a))
    if only_b:
        print("only in {}: {}".format(path_b, only_b))

    print("{:<24} {:>14} {:>12} {:>12} {:>8}".format(
        "stage", "shape", "max_abs", "rel", "ok"))
    worst = 0.0
    failed = []
    for k in shared:
        ta = np.asarray(a[k], np.float32)
        tb = _maybe_nhwc(ta, np.asarray(b[k], np.float32))
        if ta.shape != tb.shape:
            print("{:<24} SHAPE MISMATCH {} vs {}".format(
                k, ta.shape, tb.shape))
            failed.append(k)
            continue
        d = np.abs(ta - tb)
        max_abs = float(d.max()) if d.size else 0.0
        denom = float(np.abs(ta).max()) if ta.size else 1.0
        rel = max_abs / max(denom, 1e-12)
        ok = rel <= rtol
        worst = max(worst, rel)
        if not ok:
            failed.append(k)
        print("{:<24} {:>14} {:>12.3e} {:>12.3e} {:>8}".format(
            k, str(ta.shape), max_abs, rel, "ok" if ok else "FAIL"))
    print("worst rel diff: {:.3e} (tolerance {:.1e})".format(worst, rtol))
    if failed:
        print("DIVERGED at: first failing stage = {!r} — inspect upstream "
              "of it.".format(failed[0]))
    return 1 if failed else 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", dest="cfg_file")
    p.add_argument("--pkl", help="Detectron model-zoo weights .pkl")
    p.add_argument("--ckpt", help="checkpoint dir in the JAX package's "
                   "format")
    p.add_argument("--image", help="image file (utils/image_io.imread: "
                   "PPM without OpenCV, other formats through cv2)")
    p.add_argument("--out", help="output .npz dump path")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="diff two dumps instead of dumping")
    p.add_argument("--rtol", type=float, default=3e-2,
                   help="per-stage relative tolerance for --diff "
                        "(bf16 compute => ~1e-2 scale noise)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lenient", action="store_true",
                   help="allow missing blobs in the pkl")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Dump (returns the stages) or diff (returns diff_dumps' exit code)."""
    from detectron_tpu_torch.utils import image_io
    from detectron_tpu_torch.utils.device import check_device

    args = parse_args(argv)
    if args.diff:
        return diff_dumps(args.diff[0], args.diff[1], args.rtol)

    if not (args.cfg_file and args.out):
        raise SystemExit("--cfg and --out are required for a dump")
    device = check_device(args.device)
    merge_cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        merge_cfg_from_list(args.set_cfgs)
    assert_and_infer_cfg(make_immutable=False)

    if args.image:
        im = image_io.imread(args.image)
    else:
        logger.info("no --image: synthetic deterministic image")
        rng = np.random.RandomState(7)
        im = (rng.rand(480, 640, 3) * 255).astype(np.uint8)

    params = _load_params(args, device)
    stages = dump_stages(params, im)
    # Uncompressed (the JAX tool compresses): zlib over the ~0.3 GB of
    # float32 stages of one full-width image took most of a 47.8 s
    # --pkl dump on an H100's host; the forward takes under a second.
    np.savez(args.out, **stages)
    logger.info("wrote %d stages to %s", len(stages), args.out)
    for k in stages:
        logger.info("  %-24s %s", k, getattr(stages[k], "shape", stages[k]))
    return stages


if __name__ == "__main__":
    got = main()
    sys.exit(got if isinstance(got, int) else 0)
