"""Detect on a folder of images and write visualizations (the port's twin
of tools/infer_simple.py).

    python -m detectron_tpu_torch.tools.infer_simple --cfg CFG.yaml \
        [--dataset coco|keypoints_coco] [--load_ckpt DIR] \
        [--load_detectron PKL] (--image_dir DIR | --images IM ...) \
        [--output_dir infer_outputs] [--thresh 0.7] [--ext pdf] \
        [--set KEY VALUE ...] [--device cuda|cpu]

The JAX tool's flags, with its meaning, plus --device (default cuda; cpu
only where asked for, and cuda raises without a GPU).
Each image goes through the JAX tool's steps (infer_simple.py:61-84): read
(utils/image_io.imread: PPM itself, other formats through cv2; a file
cv2 cannot read is skipped, as the JAX tool skips it), get_image_blob at
TEST.SCALE / MAX_SIZE, core/test.detect_graph on the device,
test_engine.device_outputs_to_image_results, then utils/vis.vis_one_image
(matplotlib) with the class names of the COCO dummy dataset, writing
<output_dir>/<image stem>.<ext> when a detection scores --thresh or more.
On a host without matplotlib the image is drawn by vis_one_image_opencv
instead and written with cv2.imwrite, which raises unless --ext names an
image format cv2 writes (png, jpg, ...; not the default pdf).
--dataset keypoints_coco sets MODEL.NUM_CLASSES 2, any other value the
81 COCO classes.
"""

import argparse
import glob
import importlib.util
import os
import time

import numpy as np
import torch

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Demo inference")
    parser.add_argument("--dataset", default="coco",
                        help="class-name set: coco | keypoints_coco")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--load_ckpt")
    parser.add_argument("--load_detectron")
    parser.add_argument("--image_dir")
    parser.add_argument("--images", nargs="+")
    parser.add_argument("--output_dir", default="infer_outputs")
    parser.add_argument("--thresh", type=float, default=0.7)
    parser.add_argument("--ext", default="pdf")
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the tool; returns one dict per image detected: its path, the
    blob and im_info it was given, its cls_boxes / cls_segms / cls_keyps,
    the file written (None where no detection reached --thresh) and the
    seconds from read to write."""
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.core import test_engine
    from detectron_tpu_torch.data import dummy_datasets
    from detectron_tpu_torch.models import init as init_mod
    from detectron_tpu_torch.models import model_builder as mb
    from detectron_tpu_torch.utils import blob as blob_utils
    from detectron_tpu_torch.utils import image_io
    from detectron_tpu_torch.utils import vis as vis_utils
    from detectron_tpu_torch.utils.device import check_device

    args = parse_args(argv)
    device = check_device(args.device)
    merge_cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        merge_cfg_from_list(args.set_cfgs)
    dataset = dummy_datasets.get_coco_dataset()
    if args.dataset.startswith("keypoints_coco"):
        cfg.MODEL.NUM_CLASSES = 2
    else:
        cfg.MODEL.NUM_CLASSES = len(dataset.classes)
    assert_and_infer_cfg(make_immutable=False)
    if cfg.TPU.S2D_INPUT:
        raise NotImplementedError(
            init_mod.NOT_IN_REFERENCE + "TPU.S2D_INPUT in infer_simple (its "
            "blob is not blocked for the stem, tools/infer_simple.py:69)")

    params = test_engine.initialize_model_from_cfg(args, device=device)
    if args.image_dir:
        image_list = sorted(glob.glob(os.path.join(args.image_dir, "*")))
    else:
        image_list = args.images
    os.makedirs(args.output_dir, exist_ok=True)

    results = []
    for i, im_path in enumerate(image_list):
        t0 = time.perf_counter()
        try:
            im = image_io.imread(im_path)
        except ValueError as e:   # as the JAX tool's cv2.imread -> None
            logger.info("skipping %s: %s", im_path, e)
            continue
        blob, _, im_info = blob_utils.get_image_blob(im)
        # get_image_blob's [None] view has a batch stride of 0; the CPU's
        # convolutions sum such a tensor in another order than the
        # engine's batch, so give it standard strides.
        blob = blob.copy()
        out = test_ops.detect_graph(
            params, torch.from_numpy(blob).to(device, mb.compute_dtype()),
            torch.from_numpy(im_info).to(device))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        cls_boxes, cls_segms, cls_keyps = \
            test_engine.device_outputs_to_image_results(
                out, 0, im_info, cfg.MODEL.NUM_CLASSES, im.shape[:2])
        logger.info("%d/%d %s", i + 1, len(image_list), im_path)
        name = os.path.splitext(os.path.basename(im_path))[0]
        written = _visualize(args, vis_utils, im, name, cls_boxes,
                             cls_segms, cls_keyps, dataset)
        results.append({"image": im_path, "blob": blob, "im_info": im_info,
                        "cls_boxes": cls_boxes, "cls_segms": cls_segms,
                        "cls_keyps": cls_keyps, "output": written,
                        "seconds": time.perf_counter() - t0})
    return results


def _visualize(args, vis_utils, im, name, cls_boxes, cls_segms, cls_keyps,
               dataset):
    """Draw one image's detections, with matplotlib where the host has it,
    else with OpenCV; returns the file written, or None when no detection
    reached --thresh (neither drawer writes then)."""
    boxes = np.concatenate([b for b in cls_boxes[1:] if len(b)] or
                           [np.zeros((0, 5), np.float32)])
    if len(boxes) == 0 or boxes[:, 4].max() < args.thresh:
        return None
    path = os.path.join(args.output_dir, name + "." + args.ext)
    if importlib.util.find_spec("matplotlib") is not None:
        vis_utils.vis_one_image(
            im, name, args.output_dir, cls_boxes, cls_segms, cls_keyps,
            thresh=args.thresh, dataset=dataset, show_class=True,
            ext=args.ext)
    else:
        import cv2

        if not cv2.haveImageWriter(path):
            raise ValueError("matplotlib is not installed and cv2 cannot "
                             "write {}: give --ext an image format cv2 "
                             "writes, e.g. png".format(path))
        drawn = vis_utils.vis_one_image_opencv(
            im, cls_boxes, cls_segms, cls_keyps, thresh=args.thresh,
            dataset=dataset, show_class=True)
        if not cv2.imwrite(path, drawn):
            raise ValueError("cv2 could not write " + path)
    return path


if __name__ == "__main__":
    main()
