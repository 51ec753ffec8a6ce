"""The training optimizer: Adam on the one-cycle cosine schedule, with
global-norm clipping and gradient accumulation.

Counterpart of the optimizer ``TrainARMLoop.get_optimizer`` builds in the JAX
package (``mimikit_tpu/loops/train_loops.py:171-207``):
``MultiSteps(chain(clip_by_global_norm(clip), adam(schedule, b1, b2)), k)``.

* the schedule is ``optax.cosine_onecycle_schedule``'s formula, written out
  (:func:`onecycle_schedule`); torch's ``OneCycleLR`` places its boundaries
  one step later and cycles beta1, so it is not used;
* Adam is ``torch.optim.Adam`` with eps 1e-8, ``optax.adam``'s update
  (``mu_hat / (sqrt(nu_hat) + eps)``); update ``n`` (0-based) uses the
  schedule's value at ``n``, as optax's count does;
* clipping follows ``optax.clip_by_global_norm``: scale by max/||g|| only
  when ||g|| >= max, with nothing added to the norm;
* with ``accumulate`` > 1 the gradients of ``accumulate`` micro-batches are
  averaged and the parameters move once (``optax.MultiSteps``); the
  schedule ticks once per update.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["onecycle_schedule", "TrainOptimizer"]


def onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float,
                      div_factor: float, final_div_factor: float) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: cosine from peak/div up to peak over
    the first ``int(pct_start * steps)`` steps, then down to
    peak/(div*final_div) at ``steps``, constant after."""
    if transition_steps <= 0:
        raise ValueError("the one-cycle schedule needs transition_steps > 0")
    scales = {int(pct_start * transition_steps): div_factor,
              int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = [peak_value / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * scales[b])

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return schedule


class TrainOptimizer:
    """Call :meth:`step` after every backward; it returns whether the
    parameters moved (every ``accumulate``-th call)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], schedule: Callable[[int], float],
                 betas: Tuple[float, float], clip: Optional[float] = None,
                 accumulate: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = float(clip) if clip else None
        self.accumulate = int(accumulate)
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=tuple(betas), eps=1e-8)
        self.count = 0   # parameter updates so far (optax's count)
        self.micro = 0   # micro-batches accumulated towards the next update

    @torch.no_grad()
    def step(self) -> bool:
        self.micro += 1
        if self.micro < self.accumulate:
            return False
        self.micro = 0
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accumulate > 1:
            for g in grads:
                g.div_(self.accumulate)
        if self.clip is not None and grads:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
