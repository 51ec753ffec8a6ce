"""Output heads: train/infer switch + temperature sampling (counterpart of
``mimikit_tpu/modules/targets.py``).

``OutputWrapper`` returns raw distribution parameters in training and
sampled values at inference; ``CategoricalSampler`` does argmax (no
temperature) or tempered categorical sampling from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["OutputWrapper", "CategoricalSampler", "call_head"]


class CategoricalSampler(nn.Module):
    """argmax (no temperature) or tempered categorical sampling.

    ``impl`` keeps the JAX package's config strings, so a YAML reads the same
    in both packages:

    * ``"jax"`` (default): the port's plain sampling, ``torch.multinomial``
      over ``softmax(logits / temperature)``;
    * ``"pallas"``: with a scalar temperature, the Gumbel-argmax sampler
      ``ops.categorical.categorical`` — the CUDA kernel on a CUDA tensor,
      its plain twin on a CPU one — seeded with a draw from ``generator``.
      A per-example temperature tuple takes the plain route, as in JAX.
    """

    sampling_params = frozenset({"temperature"})

    def __init__(self, impl: str = "jax"):
        super().__init__()
        self.impl = impl

    def forward(self, logits, *, temperature=None, generator: Optional[torch.Generator] = None,
                train: bool = False):
        if train:
            return logits
        if temperature is None:
            return torch.argmax(logits, dim=-1)
        t = torch.as_tensor(temperature, dtype=logits.dtype)
        if self.impl == "pallas" and t.ndim == 0:
            from ..ops.categorical import categorical

            dev = generator.device if generator is not None else torch.device("cpu")
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=dev))
            return categorical(logits, float(t), seed)
        t = t.to(logits.device)
        while t.ndim < logits.ndim:
            t = t[..., None]
        probs = torch.softmax(logits / t, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        out = torch.multinomial(flat, 1, generator=generator)
        return out.reshape(probs.shape[:-1])


class OutputWrapper(nn.Module):
    """estimator -> params (train) | sampler(params) (eval)."""

    def __init__(self, estimator: nn.Module, sampler: Optional[nn.Module]):
        super().__init__()
        self.estimator = estimator
        self.sampler = sampler

    def forward(self, x, train: bool = False, **sampler_kwargs):
        params = self.estimator(x)
        if not train and self.sampler is not None:
            return self.sampler(params, train=False, **sampler_kwargs)
        return params

    @property
    def sampling_params(self):
        return getattr(self.sampler, "sampling_params", frozenset())


def call_head(mod: nn.Module, x, train: bool, temperature=None,
              generator: Optional[torch.Generator] = None):
    """An output head on x: a sampler's :class:`OutputWrapper` takes the
    train flag and the sampler's arguments, a plain head (a dense one, as
    ``IOSpec.magspec_io``'s) only x."""
    if not isinstance(mod, OutputWrapper):
        return mod(x)
    if train:
        return mod(x, train=True)
    return mod(x, train=False, temperature=temperature, generator=generator)
