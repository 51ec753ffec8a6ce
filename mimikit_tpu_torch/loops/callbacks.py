"""Loop callbacks (counterpart of ``mimikit_tpu/loops/callbacks.py``): the
progress bars, gradient norms, epoch-interval checkpointing and per-epoch
generation.  The train loop calls these hooks itself."""
from __future__ import annotations

import os
from typing import Iterable

import torch

from ..checkpoint import Checkpoint

__all__ = [
    "is_notebook",
    "tqdm",
    "EpochProgressBarCallback",
    "TrainingProgressBar",
    "GradNormCallback",
    "MMKCheckpoint",
    "GenerateCallback",
]


def is_notebook() -> bool:
    try:
        from IPython import get_ipython

        shell = get_ipython().__class__.__name__
        return shell in ("ZMQInteractiveShell", "Shell")
    except Exception:
        return False


try:
    if is_notebook():
        from tqdm.notebook import tqdm  # type: ignore
    else:
        from tqdm.auto import tqdm  # type: ignore
except ImportError:  # tqdm is optional: the iterable passes through

    def tqdm(it, **kwargs):  # type: ignore
        return it


class EpochProgressBarCallback:
    """The outer bar over epochs; the train loop draws each epoch's batch
    bar itself."""

    def __init__(self):
        self.epoch_bar = None

    def on_train_start(self, max_epochs: int):
        self.epoch_bar = tqdm(
            range(1, max_epochs), unit="epoch", position=0, leave=False, dynamic_ncols=True,
        )

    def on_train_epoch_end(self, *a, **k):
        if self.epoch_bar is not None:
            self.epoch_bar.update()


class TrainingProgressBar:
    """A batch bar redrawn at most every ``mininterval`` seconds."""

    def __init__(self, mininterval: float = 1.0):
        self.mininterval = mininterval

    def bar(self, iterable, total=None, desc=None):
        return tqdm(
            iterable, total=total, desc=desc, leave=True, dynamic_ncols=True, smoothing=0,
            mininterval=self.mininterval,
        )


class GradNormCallback:
    """Collects global gradient norms: call ``on_after_backward(grads)``
    from a custom step, or use ``grad_norm`` directly."""

    def __init__(self):
        self.gradnorms = []

    @staticmethod
    def grad_norm(grads, ord=1.0):
        """The ``ord``-norm of every element of ``grads`` (a tensor, or a
        list or dict of them) taken together."""
        if isinstance(grads, dict):
            grads = list(grads.values())
        elif isinstance(grads, torch.Tensor):
            grads = [grads]
        leaves = [g for g in grads if g is not None]
        if ord == 1.0:
            return sum(g.abs().sum() for g in leaves)
        return sum((g.abs() ** ord).sum() for g in leaves) ** (1.0 / ord)

    def on_after_backward(self, grads) -> None:
        self.gradnorms.append(float(self.grad_norm(grads)))


class MMKCheckpoint:
    """Save ``<root>/<id>/epoch=N.ckpt`` every ``epochs`` epochs (an int) or
    at the listed epochs, at the last epoch, and on an interrupt."""

    def __init__(self, epochs=None, root_dir=""):
        self.epochs = epochs
        self.root_dir = root_dir
        self.config = None

    def on_fit_start(self, loop) -> None:
        config = loop.config
        # serialization round-trip sanity check before any training happens
        type(config).deserialize(config.serialize())
        self.config = config

    def should_save(self, epoch: int, step: int) -> bool:
        if type(self.epochs) is int:
            return epoch > 0 and (epoch % self.epochs) == 0
        if isinstance(self.epochs, Iterable):
            return epoch in self.epochs
        return False

    def on_train_epoch_end(self, loop, epoch: int, global_step: int,
                           interrupted: bool = False) -> None:
        if interrupted or epoch == loop.train_cfg.max_epochs or self.should_save(
            epoch, global_step
        ):
            self.save_checkpoint(loop, epoch)

    def save_checkpoint(self, loop, epoch: int):
        root_dir, training_id = os.path.split(self.root_dir)
        opt_state = loop.opt.state_dict() if loop.train_cfg.save_optimizer else None
        trainer_state = dict(fit_loop=dict(epoch=epoch, global_step=loop.global_step))
        Checkpoint(id=training_id, epoch=epoch, root_dir=root_dir).create(
            loop.net, self.config, optimizer_state=opt_state, trainer_state=trainer_state,
        )


class GenerateCallback:
    """Runs a generation loop every ``every_n_epochs`` epochs (audio
    monitoring during training), its outputs named by the epoch."""

    def __init__(self, generate_loop=None, every_n_epochs: int = 10):
        self.loop = generate_loop
        self.every_n_epochs = every_n_epochs

    def on_train_epoch_end(self, trainer_loop, epoch: int) -> None:
        if epoch % self.every_n_epochs != 0:
            return
        self.loop.template_vars = dict(epoch=epoch)
        for _ in self.loop.run():
            continue
