"""Network interfaces: the Auto-Regressive Model contract.

Counterpart of ``mimikit_tpu/networks/arm.py``.  A network is an
``nn.Module`` on an explicit device, with a host ``torch.Generator`` for its
randomness (the JAX package's rng key stream).  The batch-spec and stepwise
generation methods of the JAX contract come with the data layer and the
generation loops.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
from typing import TYPE_CHECKING, Optional, Set

import torch
from torch import nn

from ..config import Config, Configurable

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

    @property
    @abc.abstractmethod
    def generate_params(self) -> Set[str]:
        ...


class ARM(_NetworkBase):
    """Interface for Auto Regressive Networks."""


class ARMWithHidden(ARM):
    @abc.abstractmethod
    def reset_hidden(self) -> None:
        ...
