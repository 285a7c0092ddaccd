"""Training statistics tracking and logging (the port's copy of
detectron_tpu/utils/training_stats.py :20-93; reference:
lib/utils/training_stats.py :: TrainingStats): window-smoothed medians of
each loss and metric, iteration timing, ETA, the `json_stats:` line and
optional TensorBoard scalars. Stats arrive as Python floats, 0-d numpy
arrays or 0-d torch tensors (read back by the trainer beforehand)."""

import datetime

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.utils.logging import SmoothedValue, log_json_stats
from detectron_tpu_torch.utils.timer import Timer


class TrainingStats:
    """Track vital training statistics."""

    def __init__(self, misc_args=None, log_period=20, tensorboard_logger=None):
        self.misc_args = misc_args
        self.LOG_PERIOD = log_period
        self.tblogger = tensorboard_logger
        self.tb_ignored_keys = ["iter", "eta", "time"]
        self.iter_timer = Timer()
        win_sz = 20
        self.smoothed_losses = {}
        self.smoothed_metrics = {}
        self.smoothed_total_loss = SmoothedValue(win_sz)
        self.win_sz = win_sz
        self.cur_iter = 0

    def IterTic(self):
        self.iter_timer.tic()

    def IterToc(self):
        return self.iter_timer.toc(average=False)

    def ResetIterTimer(self):
        self.iter_timer.reset()

    def UpdateIterStats(self, stats, cur_iter=None):
        """stats: dict of scalar losses/metrics from the train step."""
        if cur_iter is not None:
            self.cur_iter = cur_iter
        for k, v in stats.items():
            v = float(v)
            if k.startswith("loss"):
                if k == "loss":
                    self.smoothed_total_loss.AddValue(v)
                    continue
                self.smoothed_losses.setdefault(
                    k, SmoothedValue(self.win_sz)).AddValue(v)
            elif k not in ("lr",):
                self.smoothed_metrics.setdefault(
                    k, SmoothedValue(self.win_sz)).AddValue(v)
        self.last_lr = float(stats.get("lr", 0.0))

    def LogIterStats(self, cur_iter, lr=None):
        """Log the tracked statistics (every LOG_PERIOD iters)."""
        if (cur_iter % self.LOG_PERIOD == 0
                or cur_iter == cfg.SOLVER.MAX_ITER - 1):
            stats = self.GetStats(cur_iter, lr or self.last_lr)
            log_json_stats(stats)
            if self.tblogger:
                self.tb_log_stats(stats, cur_iter)

    def tb_log_stats(self, stats, cur_iter):
        for k, v in stats.items():
            if k not in self.tb_ignored_keys and isinstance(v, (int, float)):
                self.tblogger.add_scalar(k, v, cur_iter)

    def GetStats(self, cur_iter, lr):
        eta_seconds = self.iter_timer.average_time * (
            cfg.SOLVER.MAX_ITER - cur_iter)
        eta = str(datetime.timedelta(seconds=int(eta_seconds)))
        stats = dict(
            iter=cur_iter,
            time=self.iter_timer.average_time,
            eta=eta,
            lr=float(lr),
            loss=self.smoothed_total_loss.GetMedianValue(),
        )
        for k, v in self.smoothed_losses.items():
            stats[k] = v.GetMedianValue()
        for k, v in self.smoothed_metrics.items():
            stats[k] = v.GetMedianValue()
        return stats
