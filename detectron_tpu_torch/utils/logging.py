"""Logging helpers (the port's copy of detectron_tpu/utils/logging.py
:10-52; reference: lib/utils/logging.py :: setup_logging, SmoothedValue,
log_json_stats)."""

import json
import logging
import sys
from collections import deque

import numpy as np


def setup_logging(name):
    FORMAT = "%(levelname)s %(filename)s:%(lineno)4d: %(message)s"
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format=FORMAT,
                            stream=sys.stdout)
    return logging.getLogger(name)


class SmoothedValue:
    """Track a series of values; report median/average over a window."""

    def __init__(self, window_size):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def AddValue(self, value):
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    def GetMedianValue(self):
        return float(np.median(self.deque))

    def GetAverageValue(self):
        return float(np.mean(self.deque))

    def GetGlobalAverageValue(self):
        return self.total / max(self.count, 1)


def log_json_stats(stats, sort_keys=True):
    print("json_stats: {:s}".format(
        json.dumps(stats, sort_keys=sort_keys)))


log_stats = log_json_stats
