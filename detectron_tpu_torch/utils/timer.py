"""Wall-clock timers (the port's copy of detectron_tpu/utils/timer.py;
reference: lib/utils/timer.py :: Timer)."""

import time


class Timer:
    def __init__(self):
        self.reset()

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average=True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
