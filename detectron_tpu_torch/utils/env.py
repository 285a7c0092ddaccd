"""Output-directory helpers (the port's copy of detectron_tpu/utils/env.py;
reference: lib/utils/env.py, lib/utils/misc.py :: get_output_dir,
get_run_name), on the port's cfg."""

import datetime
import os

from detectron_tpu_torch.core.config import cfg


def get_run_name():
    """Timestamped run name (reference misc.get_run_name convention)."""
    return datetime.datetime.now().strftime("%b%d-%H-%M-%S") + \
        "_" + os.uname().nodename


def get_output_dir(args_cfg_file=None, run_name=None, training=True):
    """Outputs/<cfg-stem>/<run-name> (reference layout)."""
    stem = os.path.splitext(os.path.basename(args_cfg_file or "default"))[0]
    parts = [cfg.OUTPUT_DIR, stem]
    if run_name:
        parts.append(run_name)
    if not training:
        parts.append("test")
    return os.path.join(*parts)
