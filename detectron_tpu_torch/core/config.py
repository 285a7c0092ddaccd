"""The port's config: detectron_tpu's cfg tree, imported as it is.

detectron_tpu/core/config.py imports `yaml` at module level but needs it
only to load a yaml cfg file (load_cfg). The presets and merge_cfg_from_list
parse values with ast.literal_eval, so a host without PyYAML can still run
every preset: when `yaml` is missing, a stub module is installed first
whose safe_load raises.
"""

import importlib.util
import sys
import types


def _install_yaml_stub():
    if "yaml" in sys.modules or importlib.util.find_spec("yaml") is not None:
        return
    stub = types.ModuleType("yaml")

    def safe_load(*_args, **_kwargs):
        raise ImportError("loading a yaml cfg needs PyYAML")

    stub.safe_load = safe_load
    sys.modules["yaml"] = stub


_install_yaml_stub()

from detectron_tpu.core.config import (  # noqa: E402
    assert_and_infer_cfg, cfg, merge_cfg_from_list, reset_cfg)

__all__ = ["assert_and_infer_cfg", "cfg", "merge_cfg_from_list",
           "reset_cfg"]
