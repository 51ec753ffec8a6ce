"""Loop callbacks (counterpart of ``mimikit_tpu/loops/callbacks.py``):
epoch-interval checkpointing.  ``GenerateCallback`` waits for the port of
``GenerateLoopV2``."""
from __future__ import annotations

import os
from typing import Iterable

from ..checkpoint import Checkpoint

__all__ = ["MMKCheckpoint"]


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
