"""One sampling temperature a decode row.

JAX's sampler divides a step's logits by ``jnp.asarray(temperature)``
broadcast over the rows (``mimikit_tpu/modules/targets.py:19-23``), so a
decode takes a scalar, a 1-tuple or one temperature an example (the
training monitor's ``temperature=(1.0, 0.75, 0.5, 0.1)``).  The port's decode
kernels read a (B,) float32 tensor on the card, one value a stream, where a
scalar used to be; their plain twins divide each row by its own value.

:func:`row_temperatures` makes that tensor once a call: ``generate`` and the
streams build it at their start and hand the same object to every chunk's
wrapper, which then copies nothing to the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["RowTemperatures", "Temperature", "row_temperatures"]


class RowTemperatures(NamedTuple):
    """``tensor``: contiguous (B,) float32 on the decode's device, every
    value > 0 (checked on the host where it was made)."""

    tensor: torch.Tensor

    def column(self) -> torch.Tensor:
        """(B, 1): what a (B, Q) row of scores divides by."""
        return self.tensor[:, None]


# what a decode takes: None (argmax), one temperature, or one a row
Temperature = Union[None, float, Sequence[float], np.ndarray, torch.Tensor, RowTemperatures]


def row_temperatures(temperature, B: int, device) -> Optional[RowTemperatures]:
    """None (argmax) stays None.  A scalar or a length-1 sequence broadcasts
    to the B rows; a length-B sequence (a tuple, an array or a tensor) gives
    each row its own.  Any other length raises ``ValueError``, as JAX's
    broadcast fails, and so does a temperature that is not > 0.  An earlier
    result for the same B and device is returned as it is."""
    if temperature is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(temperature, RowTemperatures):
        t = temperature.tensor
        if t.shape != (B,) or t.device != device:
            raise ValueError(f"temperatures for {tuple(t.shape)} rows on {t.device} given to"
                             f" a decode of {B} rows on {device}")
        return temperature
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.detach().cpu().numpy()
    values = np.array(temperature, dtype=np.float32).reshape(-1)
    if values.size == 1:
        values = np.repeat(values, B)
    elif values.size != B:
        raise ValueError(f"{values.size} temperatures for {B} rows: give one, or one a row")
    if not np.all(values > 0):
        raise ValueError(f"temperature must be > 0, got {values.tolist()}")
    tensor = torch.from_numpy(values)
    if device.type == "cuda":
        tensor = tensor.pin_memory().to(device, non_blocking=True)
    else:
        tensor = tensor.to(device)
    return RowTemperatures(tensor)
