"""Epoch metrics, the loss log and audio output (counterpart of
``mimikit_tpu/loops/logger.py``).

:class:`EpochMetrics` accumulates per-batch metric dicts, prints epoch
averages, raises on a NaN/inf loss and keeps each epoch's averages in
``history``.  :class:`LossLogger` appends each epoch's averages to a file
through ``data/h5.File`` (HDF5 where h5py is installed, else its npz
container).  :class:`AudioLogger` writes waveforms (``features/audio_io``)
and shows them in a notebook where matplotlib and IPython are installed.
"""
from __future__ import annotations

import dataclasses as dtc
import os
from time import gmtime, time
from typing import Optional

import numpy as np

from ..features.audio_io import write_audio

__all__ = ["EpochMetrics", "LoggingHooks", "LossLogger", "AudioLogger"]


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

    def flush_epoch(self, epoch: int, logger: Optional["LossLogger"] = None):
        to_print = "Epoch %i " % epoch
        avgs = self.averages()
        for k, v in avgs.items():
            to_print += "- %s : %.4f " % (k, v)
        self.print(to_print)
        self.history.append((epoch, avgs))
        if logger is not None:
            logger.log_metrics(avgs, epoch)
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


class LossLogger:
    """Writes each epoch's metric averages under the group ``"<epoch>"`` of
    ``logs_file``, one (1,) dataset a metric (an epoch written again
    replaces its values).  Only the writer process writes: rank 0 where
    ``torch.distributed`` is initialised, else this process."""

    def __init__(self, logs_file: str):
        self.logs_file = logs_file

    @property
    def _is_writer(self) -> bool:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def log_metrics(self, metrics: dict, step: int):
        if not self._is_writer:
            return
        from ..data import h5

        os.makedirs(os.path.dirname(os.path.abspath(self.logs_file)), exist_ok=True)
        with h5.File(self.logs_file, "a") as f:
            g = f.require_group(str(step))
            for k, v in metrics.items():
                if k in g:
                    del g[k]
                g.create_dataset(k, data=np.asarray([v]))


@dtc.dataclass
class AudioLogger:
    sr: int = 16000
    file_template: Optional[str] = None
    title_template: Optional[str] = None

    figsize = (30, 4)

    @staticmethod
    def format_template(template: str, **parameters) -> str:
        return template.format(**parameters)

    @staticmethod
    def to_numpy(audio) -> np.ndarray:
        if hasattr(audio, "detach"):
            audio = audio.detach().cpu().numpy()
        audio = np.asarray(audio).squeeze()
        if audio.ndim > 1:
            raise ValueError(
                f"Expected `audio` array to have a single dimension, got {audio.ndim}."
            )
        return audio.astype(np.float32)

    def write(self, audio, **template_params) -> str:
        audio = self.to_numpy(audio)
        filename = self.format_template(self.file_template, **template_params)
        return write_audio(filename, audio, self.sr)

    def display(self, audio, **template_params):
        self.display_waveform(audio, **template_params)
        self.display_html(audio, **template_params)

    def display_batch(self, audio, **template_params):
        for y in audio:
            self.display(y, **template_params)

    def display_waveform(self, audio, **template_params):
        try:
            from matplotlib import pyplot as plt
        except ImportError:
            return
        audio = self.to_numpy(audio)
        plt.figure(figsize=self.figsize)
        plt.plot(audio)
        if template_params and self.title_template:
            plt.title(self.format_template(self.title_template, **template_params))
        plt.show(block=False)
        plt.close()

    def display_html(self, audio, **template_params):
        try:
            import IPython.display as ipd
        except ImportError:
            return
        audio = self.to_numpy(audio)
        try:
            ipd.display(ipd.Audio(audio, rate=self.sr))
        except Exception:
            pass


# the reference's name for the epoch-metric hooks
LoggingHooks = EpochMetrics
