"""Evaluate a model on a dataset (the port's twin of tools/test_net.py).

    python -m detectron_tpu_torch.tools.test_net --cfg CFG.yaml \
        [--load_ckpt DIR] [--load_detectron PKL] [--output_dir DIR] \
        [--batch_size 8] [--range START END] [--set KEY VALUE ...] \
        [--device cuda|cpu]

Writes detections.pkl (or detection_range_{start}_{end}.pkl with --range)
and the COCO box and mask results into the output directory, and logs the
AP. --load_ckpt takes a checkpoint directory in the JAX package's format
(utils/net.py), --load_detectron a Detectron .pkl (loaded over the
checkpoint where both are given); without either the weights are the
seeded random init.
"""

import argparse
import os

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a detection model")
    parser.add_argument("--dataset", help="coco2017 | coco2014 | ...")
    parser.add_argument("--cfg", dest="cfg_file", required=False)
    parser.add_argument("--load_ckpt", help="checkpoint dir")
    parser.add_argument("--load_detectron", help="Detectron .pkl weights")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--multi-gpu-testing", dest="multi_gpu_testing",
                        action="store_true",
                        help="accepted for CLI parity; one device is used")
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--range", nargs=2, type=int, default=None,
                        help="image index range [start end)")
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    return parser.parse_args(argv)


DATASET_MAP = {
    "coco2017": "coco_2017_val",
    "coco2014": "coco_2014_minival",
    "keypoints_coco2017": "keypoints_coco_2017_val",
    "keypoints_coco2014": "keypoints_coco_2014_minival",
    "voc2007": "voc_2007_test",
    "voc2012": "voc_2012_trainval",
}


def main(argv=None):
    from detectron_tpu_torch.core import test_engine

    args = parse_args(argv)
    if args.cfg_file:
        merge_cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        merge_cfg_from_list(args.set_cfgs)
    dataset_name = DATASET_MAP.get(args.dataset, args.dataset) or \
        (cfg.TEST.DATASETS[0] if cfg.TEST.DATASETS else None)
    if args.dataset and "keypoints" in args.dataset:
        cfg.MODEL.NUM_CLASSES = 2
    elif args.dataset and "coco" in args.dataset:
        cfg.MODEL.NUM_CLASSES = 81
    elif args.dataset and "voc" in args.dataset:
        cfg.MODEL.NUM_CLASSES = 21
    assert_and_infer_cfg(make_immutable=False)

    output_dir = args.output_dir or os.path.join(
        cfg.OUTPUT_DIR, "test",
        os.path.splitext(os.path.basename(args.cfg_file or "default"))[0])
    os.makedirs(output_dir, exist_ok=True)
    results = test_engine.run_inference(
        args, dataset_name=dataset_name, output_dir=output_dir,
        batch_size=args.batch_size,
        check_expected_results=bool(cfg.EXPECTED_RESULTS),
        ind_range=args.range, device=args.device)
    logger.info("Results: %s", results)


if __name__ == "__main__":
    main()
