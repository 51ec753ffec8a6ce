"""Epoch metrics (counterpart of ``mimikit_tpu/loops/logger.py``).

:class:`EpochMetrics` accumulates per-batch metric dicts, prints epoch
averages and raises on a NaN/inf loss.  It also keeps each epoch's averages
in ``history``.  The h5 ``LossLogger`` and the ``AudioLogger`` are not
ported.
"""
from __future__ import annotations

from time import gmtime, time

import numpy as np

__all__ = ["EpochMetrics"]


class EpochMetrics:
    def __init__(self, print_fn=print):
        self.print = print_fn
        self._metrics = {}
        self._counts = {}
        self._fit_start = None
        self.history = []  # (epoch, {metric: epoch average})

    def on_epoch_start(self):
        self._metrics = {}
        self._counts = {}

    def check_loss(self, loss_value: float):
        if not np.isfinite(loss_value):
            raise RuntimeError(f"loss is {loss_value}")

    def log_output(self, out: dict):
        for metric, val in out.items():
            v = float(val)
            self._metrics[metric] = self._metrics.get(metric, 0.0) + v
            self._counts[metric] = self._counts.get(metric, 0) + 1
        return out

    def averages(self) -> dict:
        return {k: v / self._counts[k] for k, v in self._metrics.items()}

    def flush_epoch(self, epoch: int):
        to_print = "Epoch %i " % epoch
        avgs = self.averages()
        for k, v in avgs.items():
            to_print += "- %s : %.4f " % (k, v)
        self.print(to_print)
        self.history.append((epoch, avgs))
        return avgs

    def on_fit_start(self):
        self._fit_start = time()

    def on_fit_end(self):
        duration = time() - (self._fit_start or time())
        t = gmtime(duration)
        self.print(
            "Training finished after "
            f"{t[2] - 1} days {t[3]} hours {t[4]} mins {t[5]} seconds"
        )
        return duration
