"""OneCycle-style cosine schedule over Adam's beta1.

Counterpart of ``mimikit_tpu/loops/beta_scheduler.py``: beta1 anneals
``initial -> max -> final`` in two cosine phases.  JAX wires it into optax
through ``inject_hyperparams``; here it is a ``torch.optim.Adam`` whose
``betas[0]`` is set from the schedule before each step.  As in the JAX
package it is not in the default training path.
"""
from __future__ import annotations

import math

import torch

__all__ = ["beta_schedule", "adam_with_beta_schedule", "BetaScheduledAdam"]


def beta_schedule(
    max_beta: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
):
    """step -> beta1: a cosine rise from ``max_beta / div_factor`` to
    ``max_beta`` over ``pct_start`` of ``total_steps``, then a cosine fall to
    ``max_beta / div_factor / final_div_factor``."""
    initial = max_beta / div_factor
    final = initial / final_div_factor
    up_steps = max(1, int(pct_start * total_steps))
    down_steps = max(1, total_steps - up_steps)

    def schedule(step):
        step = min(step, total_steps)
        if step < up_steps:
            pct = step / up_steps
            return initial + (max_beta - initial) * (1 - math.cos(math.pi * pct)) / 2
        pct = (step - up_steps) / down_steps
        return max_beta + (final - max_beta) * (1 - math.cos(math.pi * pct)) / 2

    return schedule


class BetaScheduledAdam(torch.optim.Adam):
    """Adam whose beta1 at its n-th step (from 0) is ``schedule(n)``: the
    first moment and the bias correction use that step's beta1, as optax's
    ``adam`` under ``inject_hyperparams`` does."""

    def __init__(self, params, lr, schedule, b2: float = 0.999, **kwargs):
        super().__init__(params, lr=lr, betas=(schedule(0), b2), **kwargs)
        self.schedule = schedule
        self.n_steps = 0

    @torch.no_grad()
    def step(self, closure=None):
        b1 = self.schedule(self.n_steps)
        for group in self.param_groups:
            group["betas"] = (b1, group["betas"][1])
        self.n_steps += 1
        return super().step(closure)


def adam_with_beta_schedule(
    params,
    learning_rate,
    max_beta: float,
    total_steps: int,
    b2: float = 0.999,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> BetaScheduledAdam:
    """Adam over ``params`` whose beta1 follows ``beta_schedule(max_beta,
    total_steps, ...)``.  The JAX function returns ``(tx, schedule_fn)`` and
    its caller injects ``schedule_fn(step)`` before each update; a torch
    optimizer holds its parameters, so this one sets beta1 itself."""
    sched = beta_schedule(max_beta, total_steps, pct_start, div_factor, final_div_factor)
    return BetaScheduledAdam(params, learning_rate, sched, b2=b2)
