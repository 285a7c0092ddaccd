"""Logging set-up (the port's copy of setup_logging from
detectron_tpu/utils/logging.py :10-15; reference: lib/utils/logging.py)."""

import logging
import sys


def setup_logging(name):
    FORMAT = "%(levelname)s %(filename)s:%(lineno)4d: %(message)s"
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format=FORMAT,
                            stream=sys.stdout)
    return logging.getLogger(name)
