"""Tied-weight convolutional autoencoder.

Counterpart of ``mimikit_tpu/networks/tied_autoencoder.py``: the encoder's
convolutions and the decoder's transposed convolutions share their kernels.
JAX keeps a kernel as flax's (k, d_in, d_out) ("NWC", "WIO", "NWC"); the
port keeps it as the conv weight (d_out, d_in, k), ``kernels.{i}``.  The
encoder is ``conv1d`` on it with padding k // 2 (causal: 2 (k // 2) zeros
on the left, no padding); the decoder's ``lax.conv_transpose(...,
transpose_kernel=True, padding=[(p, p)])`` is the adjoint of that
convolution, ``conv_transpose1d`` on the same tensor with padding
k - 1 - p, so an even kernel lengthens the sequence by one a layer each
way, as in JAX.  ``non_negative_latent`` takes ``abs`` after each encoder
convolution.

The forward returns ``(y, indp)``: ``indp`` is ``independence_reg`` times
the sum over kernels of ``|ws wsᵀ - I|.mean()`` (``ws`` the kernel summed
over its taps, (d_in, d_out)).  ``IOSpec.loss_fn`` zips the targets with
that pair, so with one target the term is computed and dropped, as in the
JAX package (``mimikit_tpu/io_spec.py:244-253``).
"""
from __future__ import annotations

import dataclasses as dtc
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..features.item_spec import ItemSpec
from ..modules.targets import call_head
from ..utils import resolve_device
from .arm import AutoEncoder, NetworkConfig

if TYPE_CHECKING:
    from ..io_spec import IOSpec

__all__ = ["TiedAE"]


class TiedAE(AutoEncoder):
    @dtc.dataclass
    class Config(NetworkConfig):
        io_spec: "IOSpec" = None
        kernel_sizes: Tuple[int, ...] = (3,)
        dims: Tuple[int, ...] = (16,)
        non_negative_latent: bool = False
        causal_pad: bool = False
        independence_reg: Optional[float] = None

    @classmethod
    def from_config(cls, config: "TiedAE.Config", device=None, seed: int = 0) -> "TiedAE":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed``: the kernels LeCun-normal (truncated at two
        deviations, flax's ``lecun_normal``), the heads PyTorch's uniform."""
        device = resolve_device(device)
        io_dim = config.dims[0]
        input_modules = [spec.module.copy().set(out_dim=io_dim).module()
                         for spec in config.io_spec.inputs]
        output_modules = [spec.module.copy().set(in_dim=io_dim).module()
                          for spec in config.io_spec.targets]
        in_dims = (io_dim, *config.dims[:-1])
        shapes = [(d_out, d_in, k) for d_in, d_out, k in
                  zip(in_dims, config.dims, config.kernel_sizes)]
        net = cls(config=config, input_modules=input_modules, output_modules=output_modules,
                  shapes=shapes)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    def __init__(self, *, config, input_modules, output_modules, shapes):
        super().__init__()
        self._config = config
        self.input_modules = nn.ModuleList(input_modules)
        self.output_modules = nn.ModuleList(output_modules)
        self.kernels = nn.ParameterList([nn.Parameter(torch.empty(s)) for s in shapes])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in self.kernels:
            std = np.sqrt(1.0 / (w.shape[1] * w.shape[2])) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, nn.Linear):
                bound = 1.0 / np.sqrt(m.weight.shape[1])
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    @property
    def config(self) -> "TiedAE.Config":
        return self._config

    @property
    def rf(self) -> int:
        return 0

    @property
    def generate_params(self):
        return set()

    def forward(self, inputs: Tuple, temperature=None):
        """inputs: one (B, T, F) tensor an input spec.  Returns (y, indp)."""
        cfg = self._config
        x = None
        for mod, xi in zip(self.input_modules, inputs):
            y = mod(torch.as_tensor(xi).to(self.device))
            x = y if x is None else x + y
        x = x.transpose(1, 2)  # (B, C, T)
        paddings = [k // 2 for k in cfg.kernel_sizes]
        for w, p in zip(self.kernels, paddings):
            if cfg.causal_pad:
                x = F.conv1d(F.pad(x, (2 * p, 0)), w)
            else:
                x = F.conv1d(x, w, padding=p)
            if cfg.non_negative_latent:
                x = x.abs()
        indp = x.new_zeros(())
        for w, p in zip(reversed(self.kernels), reversed(paddings)):
            x = F.conv_transpose1d(x, w, padding=w.shape[-1] - 1 - p)
            if cfg.independence_reg:
                ws = w.sum(-1).T  # (d_in, d_out)
                wwt = ws @ ws.T
                indp = indp + (wwt - torch.eye(wwt.shape[0], device=wwt.device)).abs().mean()
        x = x.transpose(1, 2)
        y = None
        for mod in self.output_modules:
            o = call_head(mod, x, self.training, temperature)
            y = o if y is None else y + o
        return y, indp * (cfg.independence_reg or 0.0)

    def train_batch(self, item_spec: ItemSpec):
        return tuple(
            spec.to_batch_item(item_spec) for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(item_spec) for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        return self.train_batch(item_spec)

    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        pass

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """The eval forward's reconstruction, a 1-tuple."""
        was = self.training
        self.eval()
        try:
            y, _ = self.forward(inputs)
            return (y,)
        finally:
            self.train(was)

    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        pass
