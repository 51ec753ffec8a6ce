"""Loss functions (counterpart of ``mimikit_tpu/modules/loss_functions.py``).

The categorical objective's cross-entropy and the reconstruction objective's
``MeanL1Prop`` are ported.  NaN guarding is the train loop's
(``loops/logger.py``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses as dtc

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "MeanL1Prop"]


def cross_entropy(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all positions; output (..., C) logits,
    target (...) class indices (``loss_functions.py:29``).

    The precision follows the logits' own dtype: logits below f32 (a bf16
    policy's) are cast to f32 first, so the loss is the f32 log-softmax of the
    values the net produced.  That stays finite where bf16 logits reach
    |x| >= 2**15, where one bf16 ulp exceeds f32's exp underflow range (the
    case the JAX package guards with an optimization barrier,
    ``mimikit_tpu/precision.py``; eager PyTorch materializes the logits
    once)."""
    if output.is_floating_point() and output.dtype.itemsize < 4:
        output = output.float()
    return F.cross_entropy(output.reshape(-1, output.shape[-1]), target.reshape(-1).long())


@dtc.dataclass
class MeanL1Prop:
    """L1 normalised by the target's magnitude per time slice
    (``mimikit_tpu/modules/loss_functions.py:79-92``): the L1 error and the
    target's L1 summed over the batch and the features; a slice whose target
    sum is below 1 gets the (detached) error added to it, at least ``eps``;
    the mean of the ratios."""

    raise_on_nan: bool = True  # enforced by the loop
    eps: float = 1e-8

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        dims = (0, output.dim() - 1)
        L = (output - target).abs().sum(dim=dims, keepdim=True)
        target_sums = target.abs().sum(dim=dims, keepdim=True)
        prop = L.detach().clamp_min(self.eps)
        target_sums = target_sums + (target_sums < 1.0).to(L.dtype) * prop
        return (L / target_sums).mean()
