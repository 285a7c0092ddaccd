"""Evaluate a model on a dataset (the port's twin of tools/test_net.py).

    python -m detectron_tpu_torch.tools.test_net --cfg CFG.yaml \
        [--load_ckpt DIR] [--load_detectron PKL] [--output_dir DIR] \
        [--batch_size 8] [--range START END] [--set KEY VALUE ...] \
        [--device cuda|cpu|cuda:0,cuda:1,...] [--multi-gpu-testing] \
        [--multihost | --multihost_coordinator HOST:PORT --num_hosts N \
         --host_rank R] [--dist_backend nccl|gloo]

Writes detections.pkl (or detection_range_{start}_{end}.pkl with --range)
and the COCO box and mask results into the output directory, and logs the
AP. --load_ckpt takes a checkpoint directory in the JAX package's format
(utils/net.py), --load_detectron a Detectron .pkl (loaded over the
checkpoint where both are given); without either the weights are the
seeded random init.

More than one device (the JAX tool's mesh-sharded evaluation): a
--device list starts one process per listed device on this host, and
--multi-gpu-testing with --device cuda one per visible card (with one
card it runs as without the flag); the multi-host flags join a world of
processes started elsewhere, as in train_net_step (parallel/launch.py).
Each rank runs its rows of every batch that divides by the world size
(core/test_engine.py); rank 0 writes the files, evaluates and logs the
AP.
"""

import argparse
import os
import sys

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.parallel import launch
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
                        help="with --device cuda, one process per visible "
                        "card")
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--range", nargs=2, type=int, default=None,
                        help="image index range [start end)")
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    launch.add_world_args(parser)
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
    """Run the evaluation; returns run_inference's results (None with
    --range, on a rank other than 0, and where a device list started the
    ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.multi_gpu_testing and args.device == "cuda" and not (
            args.multihost or args.multihost_coordinator):
        import torch

        n = torch.cuda.device_count()
        if n > 1:
            args.device = ",".join("cuda:{}".format(i) for i in range(n))
            argv = launch.without_flags(argv, ("--device",)) + [
                "--device", args.device]
    with launch.world_of(args, argv, "detectron_tpu_torch.tools.test_net") \
            as world:
        return None if world is None else _test(args, world[0])


def _test(args, device):
    from detectron_tpu_torch.core import test_engine

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
        ind_range=args.range, device=device)
    logger.info("Results: %s", results)
    return results


if __name__ == "__main__":
    main()
