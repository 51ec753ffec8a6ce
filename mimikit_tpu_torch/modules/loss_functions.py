"""Loss functions (counterpart of ``mimikit_tpu/modules/loss_functions.py``).

The categorical objective's cross-entropy, the reconstruction objective's
``MeanL1Prop``, and the rest of the JAX module (``:95-206``): the criteria of
the ``WeightedL1``, ``DiffOverTime``, ``MaximizeStd``, ``MaximizeMagnitude``
and ``ElementWiseAngularDistance`` objectives (``io_spec.Objective``) and
the distances that ``extract/from_neighbors.py`` ranks with.
``jax.lax.stop_gradient`` is ``.detach()``.  NaN guarding is the train
loop's (``loops/logger.py``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses as dtc

import numpy as np
import torch
import torch.nn.functional as F

from .threefry import uniform

__all__ = [
    "MeanL1Prop",
    "Mean2dDiff",
    "CosineSimilarity",
    "AngularDistance",
    "ElementWiseAngularDistance",
    "WeightedL1",
    "DiffOverTime",
    "DistanceOverTime",
    "MaximizeStd",
    "ScaledOutputsL1",
    "MaximizeMagnitude",
    "cross_entropy",
]


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


@dtc.dataclass
class WeightedL1:
    """L1 weighted by each feature's (detached) share of the error summed
    over time."""

    eps: float = 1e-18

    def __call__(self, output, target):
        L = (output - target).abs()
        target_sums = L.detach().sum(dim=1, keepdim=True)
        prop = target_sums / target_sums.sum(dim=-1, keepdim=True).clamp_min(self.eps)
        return (L * prop).sum()


@dtc.dataclass
class DiffOverTime:
    threshold: float = 1e-4

    def __call__(self, output, target):
        return (torch.diff(output, dim=1) - torch.diff(target, dim=1)).abs().mean()


@dtc.dataclass
class DistanceOverTime:
    """The L1 gap of the two (time, time) matrices of Euclidean distances
    between frames.  The norm is ``jnp.linalg.norm``'s, the root of the
    summed squares: its gradient at a frame's zero distance to itself is
    NaN, as in the JAX package (``torch.linalg.vector_norm`` takes 0
    there)."""

    def __call__(self, output, target):
        def dist(x):
            return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1).sqrt()

        return (dist(output) - dist(target)).abs().mean()


@dtc.dataclass
class MaximizeStd:
    def __call__(self, output, target):
        # jnp.std: the population deviation
        return -output.std(dim=1, keepdim=True, correction=0).mean()


@dtc.dataclass
class MaximizeMagnitude:
    def __call__(self, output, target):
        return -output.mean()


@dtc.dataclass
class ScaledOutputsL1:
    """``MeanL1Prop`` against the target scaled by a seeded draw in [min_a,
    max_a) a frame: the JAX package's values (``threefry.uniform``, its
    ``jax.random.uniform``)."""

    min_a: float = 0.95
    max_a: float = 1.05
    seed: int = 0

    def __call__(self, output, target):
        scales = torch.from_numpy(uniform(self.seed, (*target.shape[:-1], 1), self.min_a,
                                          self.max_a)).to(target)
        return MeanL1Prop()(output, scales * target)


@dtc.dataclass
class Mean2dDiff:
    """``MeanL1Prop`` of the differences along the features and along time,
    summed."""

    raise_on_nan: bool = True
    eps: float = 1e-8

    def __call__(self, output, target):
        l1p = MeanL1Prop(self.raise_on_nan, self.eps)
        lw = l1p(output[:, :, 1:] - output[:, :, :-1], target[:, :, 1:] - target[:, :, :-1])
        lh = l1p(output[:, 1:] - output[:, :-1], target[:, 1:] - target[:, :-1])
        return lw + lh


@dtc.dataclass
class CosineSimilarity:
    """The full (..., N, M) cosine-similarity matrix of X (..., N, D) and Y
    (..., M, D)."""

    eps: float = 1e-8

    def __call__(self, X, Y):
        dot = X @ Y.transpose(-2, -1)
        norms = (torch.linalg.vector_norm(X, dim=-1)[..., :, None]
                 * torch.linalg.vector_norm(Y, dim=-1)[..., None, :])
        return dot / norms.clamp_min(self.eps)


@dtc.dataclass
class AngularDistance:
    """arccos of the cosine similarity over pi, doubled where neither input
    has a negative entry; ``reduction`` "none" keeps the matrix."""

    eps: float = 1e-8
    reduction: str = "mean"

    def _safe_acos(self, x):
        return torch.arccos(x.clamp(-1 + self.eps / 2, 1 - self.eps / 2))

    def __call__(self, X, Y):
        have_negatives = (X < 0).any() | (Y < 0).any()
        cos_theta = CosineSimilarity(self.eps)(X, Y)
        scale = 2.0 - have_negatives.to(cos_theta.dtype)
        d = scale * self._safe_acos(cos_theta) / np.pi
        if self.reduction != "none":
            return getattr(torch, self.reduction)(d)
        return d


@dtc.dataclass
class ElementWiseAngularDistance(AngularDistance):
    """``AngularDistance`` of each output frame to its target frame."""

    def __call__(self, output, target):
        return super().__call__(output[..., None, :], target[..., None, :])
