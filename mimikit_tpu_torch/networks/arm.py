"""Network interfaces: the Auto-Regressive Model contract.

Counterpart of ``mimikit_tpu/networks/arm.py``.  A network is an
``nn.Module`` on an explicit device, with a host ``torch.Generator`` for its
randomness (the JAX package's rng key stream).  Besides ``rf`` and the batch
specs, the contract holds the stepwise generation API that
``loops/generate.GenerateLoopV2`` drives where a net's ``generate`` cannot
take the sampler parameters (``before_generate``, ``generate_step``,
``after_generate``), and the optional ``stepwise_step_fn``.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
from typing import TYPE_CHECKING, Optional, Set, Tuple

import torch
from torch import nn

from ..config import Config, Configurable
from ..features.item_spec import ItemSpec

if TYPE_CHECKING:
    from ..io_spec import IOSpec

__all__ = ["NetworkConfig", "ARM", "ARMWithHidden"]


@dtc.dataclass
class NetworkConfig(Config, abc.ABC):
    @property
    @abc.abstractmethod
    def io_spec(self) -> "IOSpec":
        ...


class _NetworkBase(Configurable, nn.Module):
    """Shared runtime plumbing: device + host generator."""

    _generator: Optional[torch.Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def seed(self, seed: int):
        self._generator = torch.Generator().manual_seed(seed)
        return self

    def next_seed(self) -> int:
        """Draw a 31-bit seed from the network's host generator."""
        if self._generator is None:
            self.seed(0)
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self._generator))

    @property
    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @property
    @abc.abstractmethod
    def config(self) -> NetworkConfig:
        ...

    @property
    @abc.abstractmethod
    def rf(self):
        ...

    @abc.abstractmethod
    def train_batch(self, item_spec: ItemSpec):
        ...

    @abc.abstractmethod
    def test_batch(self, item_spec: ItemSpec):
        ...

    @abc.abstractmethod
    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        ...

    @abc.abstractmethod
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters) -> Tuple:
        ...

    @abc.abstractmethod
    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        ...

    @property
    @abc.abstractmethod
    def generate_params(self) -> Set[str]:
        ...

    def stepwise_step_fn(self, parameters: dict):
        """Optional: a function ``(window_inputs, generator) -> outputs``
        equal to ``generate_step(inputs, t=t, **parameters)`` for a step that
        depends neither on t nor on state (an element of the outputs may be
        None for a tensor the step does not write).  ``GenerateLoopV2``'s
        stepwise loop then calls it in place of ``generate_step``, on buffers
        that stay on the net's device.  Default None: the loop calls
        ``generate_step`` (SampleRNN's step carries its tiers' state)."""
        return None


class ARM(_NetworkBase):
    """Interface for Auto Regressive Networks."""


class ARMWithHidden(ARM):
    @abc.abstractmethod
    def reset_hidden(self) -> None:
        ...
