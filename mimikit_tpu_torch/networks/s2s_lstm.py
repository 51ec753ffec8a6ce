"""Seq2Seq LSTM: encode a hop of frames, decode the next hop.

Counterpart of ``mimikit_tpu/networks/s2s_lstm.py``: stacked bidirectional
LSTMs (forward and backward directions summed), a hop -> 1 down-sampling
(``edge_sum``, ``edge_mean``, ``sum``, ``mean``, ``linear_resample``), the
encoder's final (h, c) seeding the decoder's first LSTM, a 1 -> hop
up-sampling (``repeat``, ``interp``, ``linear_resample``).  Used on STFT
magnitude frames (``IOSpec.magspec_io``, the seq2seq demo).

Every LSTM layer is ``modules/rnn.LSTM.run_layer``: it takes its
``lstm_route``, so at the demo's width (model_dim 512, B=16, hop 4) the
card runs K3a-wide/K3b-wide in f32 and the bf16 cluster kernels under a
bf16 policy.  The backward direction runs on the flipped sequence; its
outputs are flipped back before the sum.  The decoder's first layer starts
from the encoder's final carry, so training sends gradient through both
the encoder's ``h_T``/``c_T`` and the decoder's ``dh0``/``dc0``.

State_dict names are PyTorch mimikit's (``s2s_lstm_v2.py``), the names
``mimikit_tpu/migrate.py:seq2seq_params_from_state_dict`` reads:
``{enc,dec}.lstm.{n}.weight_ih_l0`` and ``..._reverse``, ``enc.fc_out.weight``,
``{enc,dec}.fc.fc.*`` and ``output_module.heads.{i}.*``.

``ref_compat``: the reference's "sum" of the two directions adds adjacent
feature pairs of the concatenated ``[fwd | bwd]`` output, and its encoder
carry seeds every decoder layer; both are kept for its checkpoints, as in
the JAX package.

The JAX network is an ``ARMWithHidden`` whose hidden is made and dropped in
each call (its train apply returns an empty carry); the port's is a plain
``ARM``, so the train loop calls it without a carry, the same computation.
Weight norm (``enc_weight_norm``, ``dec_weight_norm``) is not ported.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..features.functionals import Continuous
from ..features.item_spec import ItemSpec
from ..modules.dense import Dense
from ..modules.io import ZipReduceVariables
from ..modules.misc import unfold
from ..modules.resamplers import LinearResampler
from ..modules.rnn import LSTM, init_rnn_carry
from ..modules.targets import call_head
from ..utils import resolve_device
from .arm import ARM, NetworkConfig

__all__ = ["EncoderLSTM", "DecoderLSTM", "Seq2SeqLSTMNetwork"]

DOWN_SAMPLINGS = ("edge_sum", "edge_mean", "sum", "mean", "linear_resample")
UP_SAMPLINGS = ("repeat", "interp", "linear_resample")


class _BiLSTMSum(LSTM):
    """A bidirectional LSTM layer whose two directions are summed
    (``mimikit_tpu/networks/s2s_lstm.py:51-92``); ``pair_sum`` sums adjacent
    feature pairs of ``[fwd | bwd]`` instead (the reference's computation)."""

    def __init__(self, input_dim: int, output_dim: int, pair_sum: bool = False):
        super().__init__(output_dim, 1, input_dim=input_dim, bidirectional=True)
        self.pair_sum = pair_sum

    def forward(self, x, hidden=None):
        """x (B, T, D); hidden: None or (h, c), each (2, B, H), seeding the
        forward ([0]) and backward ([1]) carries.  Returns (y (B, T, H), (h,
        c)) with each direction's final carry stacked the same way."""
        xs = x.transpose(0, 1)
        if hidden is None:
            (c, h), = init_rnn_carry(1, x.shape[0], self.hidden_size, device=x.device,
                                     dtype=x.dtype)
            hidden = (torch.stack([h, h]), torch.stack([c, c]))
        h0, c0 = hidden
        y_f, h_f, c_f = self.run_layer(0, xs, h0[0], c0[0])
        y_b, h_b, c_b = self.run_layer(0, xs.flip(0), h0[1], c0[1], reverse=True)
        y_f, y_b = y_f.transpose(0, 1), y_b.flip(0).transpose(0, 1)
        if self.pair_sum:
            z = torch.cat([y_f, y_b], dim=-1)
            y = z[..., 0::2] + z[..., 1::2]
        else:
            y = y_f + y_b
        return y, (torch.stack([h_f, h_b]), torch.stack([c_f, c_b]))


class EncoderLSTM(nn.Module):
    """hop frames -> one code frame and the last layer's carry
    (``mimikit_tpu/networks/s2s_lstm.py:95-137``)."""

    def __init__(self, downsampling: str, input_dim: int = 512, output_dim: int = 512,
                 num_layers: int = 1, hop: int = 4, apply_residuals: bool = False,
                 ref_compat: bool = False):
        super().__init__()
        if str(downsampling) not in DOWN_SAMPLINGS:
            raise ValueError(f"unknown downsampling '{downsampling}'")
        self.downsampling, self.hop, self.apply_residuals = str(downsampling), hop, apply_residuals
        self.lstm = nn.ModuleList([
            _BiLSTMSum(input_dim if i == 0 else output_dim, output_dim, pair_sum=ref_compat)
            for i in range(num_layers)
        ])
        if self.downsampling == "linear_resample":
            self.fc = LinearResampler(output_dim, 1 / hop, 1)
        self.fc_out = Dense(output_dim, output_dim, bias=False)

    def forward(self, x):
        if x.shape[1] != self.hop:
            raise ValueError(f"the encoder takes {self.hop} frames, got {x.shape[1]}")
        hidden = None
        for n, lstm in enumerate(self.lstm):
            y, hidden = lstm(x)
            x = x + y if n > 0 and self.apply_residuals else y
        ds = self.downsampling
        if ds == "linear_resample":
            return self.fc_out(self.fc(x)), hidden
        x = unfold(x, 1, self.hop, self.hop)  # (B, 1, D, hop)
        if "edge" in ds:
            x = x[..., [0, self.hop - 1]]
        x = x.sum(dim=-1) if "sum" in ds else x.mean(dim=-1)
        return self.fc_out(x), hidden


class DecoderLSTM(nn.Module):
    """One code frame and the encoder's carry -> hop frames
    (``mimikit_tpu/networks/s2s_lstm.py:140-187``)."""

    def __init__(self, upsampling: str, model_dim: int = 512, num_layers: int = 1, hop: int = 4,
                 apply_residuals: bool = False, ref_compat: bool = False):
        super().__init__()
        if str(upsampling) not in UP_SAMPLINGS:
            raise ValueError(f"unknown upsampling '{upsampling}'")
        self.upsampling, self.hop = str(upsampling), hop
        self.apply_residuals, self.ref_compat = apply_residuals, ref_compat
        self.lstm = nn.ModuleList([_BiLSTMSum(model_dim, model_dim, pair_sum=ref_compat)
                                   for _ in range(num_layers)])
        if self.upsampling == "linear_resample":
            self.fc = LinearResampler(model_dim, hop, 1)

    def forward(self, x, hidden=None):
        if x.shape[1] != 1:
            raise ValueError(f"the decoder takes one frame, got {x.shape[1]}")
        us = self.upsampling
        if us == "linear_resample":
            x = self.fc(x)
        elif us == "repeat":
            x = x.repeat_interleave(self.hop, dim=1)
        else:
            # the encoder's two final h, linearly resized from 2 to hop steps
            # (jax.image.resize "linear": half-pixel centres, the edges held)
            h_t = hidden[0].permute(1, 2, 0)  # (B, H, 2)
            interp = F.interpolate(h_t, size=self.hop, mode="linear", align_corners=False)
            x = x.expand(x.shape[0], self.hop, x.shape[2]) + interp.transpose(1, 2)
        for n, lstm in enumerate(self.lstm):
            y, _ = lstm(x, hidden if (n == 0 or self.ref_compat) else None)
            x = x + y if self.apply_residuals else y
        return x


class Seq2SeqLSTMNetwork(ARM):
    @dtc.dataclass
    class Config(NetworkConfig):
        io_spec: "IOSpec" = None  # noqa: F821
        model_dim: int = 1024
        enc_downsampling: str = "edge_sum"
        enc_n_lstm: int = 1
        enc_apply_residuals: bool = False
        enc_weight_norm: bool = False
        dec_upsampling: str = "linear_resample"
        dec_n_lstm: int = 1
        dec_apply_residuals: bool = False
        dec_weight_norm: bool = False
        hop: int = 8
        # the reference's adjacent-pair direction "sum" and its carry seeding
        # every decoder layer, for its checkpoints
        ref_compat: bool = False

    @classmethod
    def from_config(cls, config: "Seq2SeqLSTMNetwork.Config", device=None,
                    seed: int = 0) -> "Seq2SeqLSTMNetwork":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed`` (``mimikit_tpu/networks/s2s_lstm.py:243-284``)."""
        device = resolve_device(device)
        if config.enc_weight_norm or config.dec_weight_norm:
            raise NotImplementedError("weight norm in Seq2SeqLSTMNetwork is not ported")
        io = config.io_spec
        D = config.model_dim
        if isinstance(io.inputs[0].elem_type, Continuous):
            input_dim, input_module = io.inputs[0].elem_type.size, None
        else:
            input_dim = D
            input_module = ZipReduceVariables("sum", tuple(
                spec.module.copy().set(out_dim=D).module() for spec in io.inputs))
        heads = tuple(spec.module.copy().set(in_dim=D).module() for spec in io.targets)
        net = cls(
            config=config,
            input_module=input_module,
            output_module=ZipReduceVariables("sum", heads),
            enc=EncoderLSTM(config.enc_downsampling, input_dim, D, config.enc_n_lstm, config.hop,
                            config.enc_apply_residuals, config.ref_compat),
            dec=DecoderLSTM(config.dec_upsampling, D, config.dec_n_lstm, config.hop,
                            config.dec_apply_residuals, config.ref_compat),
        )
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    def __init__(self, *, config, input_module, output_module, enc, dec):
        super().__init__()
        self._config = config
        self.input_module = input_module
        self.enc, self.dec = enc, dec
        self.output_module = output_module

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the
        LSTMs' U(-1/sqrt(H), 1/sqrt(H)), ``bias_ih`` zero), N(0, 1) for an
        embedding, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, LSTM):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    @property
    def config(self) -> "Seq2SeqLSTMNetwork.Config":
        return self._config

    @property
    def rf(self) -> int:
        return self._config.hop

    @property
    def generate_params(self):
        out = set()
        for t_spec in self.config.io_spec.targets:
            sampler = t_spec.objective.get_sampler()
            out |= set(getattr(sampler, "sampling_params", ()) or ())
        return out

    def reset_hidden(self) -> None:
        """The carry is made in each call (the JAX network's no-op)."""

    def core(self, inputs: Tuple, train: bool, temperature=None,
             generator: Optional[torch.Generator] = None) -> Tuple:
        """Encode the hop frames of ``inputs``, decode the next hop, the
        heads' outputs summed: a tuple of one (B, hop, F)
        (``mimikit_tpu/networks/s2s_lstm.py:198-220``)."""
        if self.input_module is not None:
            x = self.input_module(tuple(inputs))
        else:
            x = sum(inputs)
        coded, h_enc = self.enc(x)
        output = self.dec(coded, h_enc)
        y = None
        for head in self.output_module.heads:
            o = call_head(head, output, train, temperature, generator)
            y = o if y is None else y + o
        return (y,)

    def forward(self, inputs: Tuple, temperature=None):
        """Train mode: the heads' outputs; eval mode: the same through the
        samplers, where a head has one."""
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        if self.training:
            return self.core(inputs, train=True)
        return self.core(inputs, train=False, temperature=temperature,
                         generator=self._sample_generator())

    def _sample_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.next_seed())

    # -- batch specs (s2s_lstm.py:452-465) ---------------------------------------------------
    def train_batch(self, item_spec: ItemSpec):
        hop = self._config.hop
        return tuple(
            spec.to_batch_item(ItemSpec(shift=0, length=hop, unit=item_spec.unit))
            for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=hop, length=hop, unit=item_spec.unit))
            for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        return tuple(spec.to_batch_item(item_spec) for spec in self.config.io_spec.inputs), ()

    # -- generation ----------------------------------------------------------------------------
    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        pass

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """The eval forward on the last ``hop`` frames: the next hop."""
        was = self.training
        self.eval()
        try:
            return self.forward(inputs, parameters.get("temperature"))
        finally:
            self.train(was)

    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        pass

    def stepwise_step_fn(self, parameters: dict):
        """``(window, generator) -> the next hop`` for ``GenerateLoopV2``'s
        stepwise loop: the eval forward on the ``hop`` window, independent of
        t and of any state (``mimikit_tpu/networks/s2s_lstm.py:354-380``)."""
        if set(parameters) - {"temperature"}:
            return None
        temperature = parameters.get("temperature")

        @torch.no_grad()
        def step(wins, generator):
            return self.core(tuple(wins), train=False, temperature=temperature,
                             generator=generator)

        return step

    @torch.no_grad()
    def generate(self, prompts: Tuple, n_steps: int, temperature=None,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """Block-autoregressive decode (``mimikit_tpu/networks/s2s_lstm.py:
        382-443``): each block feeds the last ``hop`` frames (a prompt
        shorter than ``hop`` zero-padded on the left) through the eval-mode
        encoder and decoder and appends the next ``hop``; the outputs become
        the next window.  Returns each prompt with its ``n_steps`` new frames
        appended, on the network's device."""
        hop = self._config.hop
        xs = tuple(torch.as_tensor(p).to(self.device) for p in prompts)
        Tp = xs[0].shape[1]
        n_blocks = max(1, -(-n_steps // hop))
        wins = tuple(F.pad(x, (0, 0) * (x.dim() - 2) + (max(0, hop - Tp), 0))[:, -hop:]
                     for x in xs)
        gen = torch.Generator(device=self.device).manual_seed(
            self.next_seed() if seed is None else seed)
        was = self.training
        self.eval()
        try:
            blocks = []
            for _ in range(n_blocks):
                outs = self.core(wins, train=False, temperature=temperature, generator=gen)
                wins = tuple(o.to(w.dtype) for o, w in zip(outs, wins))
                blocks.append(wins)
        finally:
            self.train(was)
        return tuple(
            torch.cat([x, torch.cat(b, dim=1)[:, :n_steps]], dim=1)
            for x, b in zip(xs, zip(*blocks))
        )
