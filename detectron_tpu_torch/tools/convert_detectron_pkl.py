"""Convert a Detectron/Caffe2 .pkl into a checkpoint in the JAX package's
format and print a blob coverage report (which blobs mapped, which were
unused, and which params stayed at init): the port's twin of
tools/convert_detectron_pkl.py, with the same flags.

    python -m detectron_tpu_torch.tools.convert_detectron_pkl \
        --cfg CFG.yaml --pkl model_final.pkl --out DIR [--set KEY VALUE ...]

The checkpoint (DIR/ckpt/model_step0, utils/net.save_ckpt) loads in
test_net and train_net_step through --load_ckpt, and in the JAX package.
"""

import argparse

import numpy as np

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--pkl", required=True, help="Detectron weights .pkl")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns the checkpoint directory written."""
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.utils import detectron_weight_helper as dwh
    from detectron_tpu_torch.utils import net as net_utils

    args = parse_args(argv)
    merge_cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        merge_cfg_from_list(args.set_cfgs)
    assert_and_infer_cfg(make_immutable=False)

    params = init.init_model(0)
    mapping = dwh.full_weight_mapping()
    blobs = dwh.read_blobs(args.pkl)

    mapped, missing = [], []
    for name, (path, transform) in mapping.items():
        if name in blobs:
            dwh._set_path(params, path, transform(np.asarray(blobs[name])))
            mapped.append(name)
        else:
            missing.append(name)
    momentum_blobs = [b for b in blobs if b.endswith("_momentum")]
    unused = sorted(set(blobs) - set(mapped) - set(momentum_blobs))

    logger.info("mapped %d/%d blobs", len(mapped), len(mapping))
    if missing:
        logger.warning("params left at init (no blob): %s", missing)
    if unused:
        logger.warning("reference blobs without a target (check mapping "
                       "tables!): %s", unused[:40])

    ckpt = net_utils.save_ckpt(args.out, 0, params,
                               meta={"source_pkl": args.pkl})
    logger.info("wrote %s", ckpt)
    return ckpt


if __name__ == "__main__":
    main()
