"""SampleRNN: tiered recurrent autoregressive audio model, PyTorch port.

Counterpart of ``mimikit_tpu/networks/sample_rnn.py``.  Coarse frame-level
LSTM tiers condition finer ones down to a per-sample MLP head.  Module and
parameter names follow PyTorch mimikit's ``SampleRNN`` (``tiers.{i}``,
``output_modules.{j}``), the names ``mimikit_tpu/migrate.py`` reads.

Training: ``forward`` is the train-mode forward, ``train_batch`` the
windows a training step reads; ``TrainARMLoop`` drives both.  ``test_batch``
gives the prompts ``GenerateLoopV2`` reads, and ``before_generate``,
``generate_step`` and ``after_generate`` its stepwise loop (no kernel).

``weight_norm=True`` (the recipe of ``demos/srnn.py``) puts weight norm
where the JAX package does: on the upper tiers' input denses, the LSTMs, the
up-samplers and the head's denses (``modules/weight_norm.py``).  Training
and decoding read the effective weights, through the same kernels.

Serving: ``generate`` and ``stream`` run on the network's device.  A network
inside the decode kernel's scope (:func:`supports_kernel_decode`) on CUDA
always goes through the hand-written kernel: ``decode_single`` for fewer than
64 streams, ``decode_chunk`` (``_CHUNK`` steps a launch, state carried) for
wider batches and for every stream.  On the CPU the same wrappers run the
plain PyTorch twin.  Networks outside the scope run the plain step loop.

``MMK_PALLAS_BF16=1`` (``_pallas_weight_dtype``, as in the JAX package) packs
the kernel's weights in bfloat16: each product's input is rounded to bf16 and
summed in f32, so tokens may part from the f32 decode at near-ties (the
parity criterion is teacher forcing, not token identity).  It applies to
networks in the kernel's scope; the plain step loop stays f32.
"""
from __future__ import annotations

import dataclasses as dtc
import os
from enum import auto
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..features.functionals import Discrete
from ..features.item_spec import ItemSpec
from ..modules.io import FramedConv1dIO, FramedLinearIO, ZipReduceVariables
from ..modules.resamplers import LinearResampler
from ..modules.rnn import LSTM
from ..modules.weight_norm import WeightNormDense
from ..ops.samplernn_decode import (
    decode_chunk,
    decode_plain,
    decode_single,
    init_decode_state,
    samplernn_weight_pack,
    supports_kernel_decode,
)
from ..ops.temperature import Temperature, row_temperatures
from ..utils import AutoStrEnum, resolve_device
from .arm import ARMWithHidden, NetworkConfig

__all__ = ["SampleRNN"]


class RNNType(AutoStrEnum):
    lstm = auto()
    none = auto()


class Tier(nn.Module):
    """One tier: its input module, and for the frame tiers an LSTM and an
    upsampler (PyTorch mimikit's ``tiers.{i}`` names)."""

    def __init__(self, input_module, rnn=None, up_sampler=None):
        super().__init__()
        self.input_module = input_module
        self.rnn = rnn
        self.up_sampler = up_sampler


class SampleRNN(ARMWithHidden):
    @dtc.dataclass
    class Config(NetworkConfig):
        frame_sizes: Tuple[int, ...] = (16, 8, 8)
        hidden_dim: int = 256
        rnn_class: str = "lstm"
        n_rnn: int = 1
        rnn_dropout: float = 0.0
        rnn_bias: bool = True
        h0_init: str = "zeros"
        weight_norm: bool = False
        inputs_mode: str = "sum"
        io_spec: "IOSpec" = None  # noqa: F821

    # streams below this decode in one launch (decode_single); at and above
    # it, and for every stream, in _CHUNK-step launches (decode_chunk)
    _CHUNKED_MIN_B = 64
    _CHUNK = 2048

    @classmethod
    def from_config(cls, config: "SampleRNN.Config", device=None, seed: int = 0) -> "SampleRNN":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed``."""
        device = resolve_device(device)
        if str(config.rnn_class) not in RNNType.__members__:
            raise NotImplementedError(f"rnn_class={config.rnn_class!r} is not ported")
        h, fs = config.hidden_dim, tuple(config.frame_sizes)
        # weight norm where JAX puts it (sample_rnn.py:212-248): the upper tiers'
        # inputs, the LSTMs, the up-samplers and the heads; not the bottom's conv
        wn = config.weight_norm
        tiers, up_factors = [], []
        for i, f in enumerate(fs[:-1]):
            mods = tuple(
                in_spec.module.copy().set(frame_size=f, hop_length=f, out_dim=h,
                                          weight_norm=wn).module()
                for in_spec in config.io_spec.inputs
            )
            up = f // (fs[i + 1] if i < len(fs) - 2 else 1)
            up_factors.append(up)
            rnn = (
                LSTM(h, config.n_rnn, config.rnn_dropout, weight_norm=wn)
                if str(config.rnn_class) == "lstm" else None
            )
            tiers.append(
                Tier(ZipReduceVariables(config.inputs_mode, mods), rnn,
                     LinearResampler(h, t_factor=up, d_factor=1, weight_norm=wn))
            )
        mods = []
        for in_spec in config.io_spec.inputs:
            params = {}
            if isinstance(in_spec.elem_type, Discrete):
                if not isinstance(in_spec.module, FramedLinearIO):
                    raise NotImplementedError("embedding inputs are not ported")
                params = dict(class_size=in_spec.elem_type.size)
            mods.append(
                FramedConv1dIO().set(**params, frame_size=fs[-1], hop_length=1, out_dim=h).module()
            )
        tiers.append(Tier(ZipReduceVariables(config.inputs_mode, tuple(mods))))
        outputs = [
            t_spec.module.copy().set(in_dim=h, weight_norm=wn).module()
            for t_spec in config.io_spec.targets
        ]
        net = cls(config=config, tiers=tiers, output_modules=outputs, up_factors=up_factors)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    def __init__(self, *, config, tiers, output_modules, up_factors):
        super().__init__()
        self._config = config
        self.frame_sizes = tuple(config.frame_sizes)
        self.up_factors = tuple(up_factors)
        self.tiers = nn.ModuleList(tiers)
        self.output_modules = nn.ModuleList(output_modules)
        self.hidden = None  # carried TBPTT state (train path)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
        drawn from ``generator``; the LSTMs' ``bias_ih`` stays zero; under
        weight norm each ``_v`` is drawn so and each ``_g`` is ones."""
        for m in self.modules():
            if isinstance(m, (LSTM, WeightNormDense)):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    @property
    def config(self) -> "SampleRNN.Config":
        return self._config

    @property
    def rf(self):
        return self.frame_sizes[0]

    @property
    def generate_params(self):
        return {"temperature"}

    def reset_hidden(self) -> None:
        self.hidden = None

    # -- batch specs (identical ItemSpec arithmetic to the JAX package,
    #    ``mimikit_tpu/networks/sample_rnn.py:354-366``) -------------------------
    def train_batch(self, item_spec: ItemSpec):
        """(inputs, targets) reads for a training window: each input covers
        ``frame_sizes[0]`` more samples before the window, each target is the
        window shifted by ``frame_sizes[0]``."""
        fs0 = self.frame_sizes[0]
        return tuple(
            spec.to_batch_item(ItemSpec(shift=0, length=fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        """(inputs, targets) reads for a prompt: each input the window itself,
        each target the window less its first ``frame_sizes[0]`` samples
        (``mimikit_tpu/networks/sample_rnn.py:368-383``)."""
        fs0 = self.frame_sizes[0]
        return tuple(
            spec.to_batch_item(item_spec.to(spec.unit)) for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=fs0, length=-fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.targets
        )

    # -- training forward (sample_rnn.py:96-124) ------------------------------
    def forward(self, inputs: Tuple, hidden=None):
        """inputs: tuple of (B, fs0 + T) tensors.  Returns (outputs, hidden):
        each output (B, T, Q) logits, ``hidden`` the tiers' final carries.
        The LSTM tiers run through the fused LSTM layer (on the card, the
        hand-written forward and backward kernels).  A carried ``hidden``
        from an earlier window must come detached: TBPTT never
        back-propagates across windows (``TrainARMLoop`` detaches it)."""
        fs = self.frame_sizes
        fs0 = fs[0]
        prev, new_hidden = None, []
        for i, f in enumerate(fs[:-1]):
            tier = self.tiers[i]
            x = tier.input_module(tuple(v[:, fs0 - f : v.shape[1] - f] for v in inputs))
            if prev is not None:
                x = x + prev
            if tier.rnn is not None:
                x, h = tier.rnn.forward_seq(x, hidden[i] if hidden is not None else None)
                new_hidden.append(h)
            prev = tier.up_sampler(x)
        f = fs[-1]
        x = self.tiers[-1].input_module(tuple(v[:, fs0 - f : v.shape[1] - 1] for v in inputs))
        if prev is not None:
            x = x + prev
        return tuple(mod(x, train=True) for mod in self.output_modules), tuple(new_hidden)

    # -- one AR step (sample_rnn.py:127-189) -----------------------------------
    def decode_step(self, t: int, win: Tuple, hidden, tier_out):
        """One sample step at absolute position ``t``.

        win: tuple of (B, rf) input windows ending at t (exclusive).
        hidden: per frame tier, the LSTM carry; tier_out: per frame tier, the
        (B, up_i, H) cached upsampled outputs.  Returns (per-target (B, Q)
        logits after the learned temperature, new_hidden, new_tier_out) —
        sampling is the caller's (``ops.samplernn_decode.decode_plain``)."""
        fs = self.frame_sizes
        rf, n = fs[0], len(fs)
        new_hidden, new_tier_out = list(hidden), list(tier_out)
        for i in range(n - 1):
            f = fs[i]
            if t % f:
                continue
            tier = self.tiers[i]
            x = tier.input_module(tuple(w[:, rf - f :] for w in win))  # (B, 1, H)
            if i > 0:
                idx = (t // f) % self.up_factors[i - 1]
                x = x + new_tier_out[i - 1][:, idx : idx + 1]
            y = x[:, 0]
            if tier.rnn is not None:
                y, new_hidden[i] = tier.rnn.step(y, hidden[i])
            new_tier_out[i] = tier.up_sampler(y[:, None, :])
        f = fs[-1]
        x = self.tiers[-1].input_module(tuple(w[:, rf - f :] for w in win))
        idx = t % fs[-2]
        x = x + new_tier_out[-1][:, idx : idx + 1]
        logits = tuple(mod.estimator(x)[:, 0] for mod in self.output_modules)
        return logits, tuple(new_hidden), tuple(new_tier_out)

    # -- step-wise generation API (sample_rnn.py:994-1032) ---------------------
    # The reference semantics, for GenerateLoopV2's stepwise loop: one
    # decode_step a sample on the tiers' carried state, sampled by the output
    # modules' samplers.  It launches no kernel, as in JAX.
    def _sample_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.next_seed())

    @torch.no_grad()
    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        """Fresh tier state for the prompts' batch, then warm it up on the
        prompt: a prompt of ``rf * k + offset`` samples steps over its last
        ``rf * k``, the first ``offset`` dropped."""
        first = torch.as_tensor(prompts[0]).to(self.device)
        state = init_decode_state(self, first, self._generator)
        rows = np.cumsum((0, *self.up_factors))
        self._gen_hidden = tuple(
            tuple((state.c[i, l], state.h[i, l]) for l in range(state.h.shape[1]))
            for i in range(len(self.up_factors))
        )
        self._gen_tier_out = tuple(state.cache[:, rows[i] : rows[i + 1]]
                                   for i in range(len(self.up_factors)))
        prompt_length = first.shape[1]
        offset = prompt_length % self.rf
        self._gen_prompt_length = prompt_length - offset
        for t in range(self.rf, self._gen_prompt_length):
            self.generate_step(
                tuple(torch.as_tensor(p)[:, t + offset - self.rf : t + offset] for p in prompts),
                t=t)

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """One sample at absolute step ``t`` from the inputs' last ``rf``
        samples, the tiers' state carried.  Returns an empty tuple while ``t``
        lies in the prompt, else one (B, 1) tensor a target."""
        win = tuple(torch.as_tensor(x).to(self.device, torch.int64)[:, -self.rf :]
                    for x in inputs)
        logits, self._gen_hidden, self._gen_tier_out = self.decode_step(
            t, win, self._gen_hidden, self._gen_tier_out)
        if t < self._gen_prompt_length:
            return tuple()
        gen = self._sample_generator()
        return tuple(mod.sampler(l[:, None], temperature=parameters.get("temperature"),
                                 generator=gen)
                     for mod, l in zip(self.output_modules, logits))

    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        self._gen_hidden = self._gen_tier_out = None
        self._gen_prompt_length = 0

    # -- serving ---------------------------------------------------------------
    def _prompt(self, prompts: Tuple) -> torch.Tensor:
        if len(prompts) != 1 or len(self.config.io_spec.targets) != 1:
            raise NotImplementedError("decoding supports one input and one target")
        prompt = torch.as_tensor(prompts[0]).to(self.device, torch.int32).contiguous()
        if prompt.shape[1] < self.rf:
            raise ValueError(
                f"prompt length {prompt.shape[1]} is shorter than rf={self.rf}"
            )
        return prompt

    @staticmethod
    def _pallas_weight_dtype() -> torch.dtype:
        """bfloat16 under ``MMK_PALLAS_BF16=1`` (half the weight bytes a step
        reads, bf16-rounded products), else float32
        (``mimikit_tpu/networks/sample_rnn.py:736-741``)."""
        return torch.bfloat16 if os.environ.get("MMK_PALLAS_BF16") == "1" else torch.float32

    def _pack(self):
        """The decode kernel's weight pack in ``_pallas_weight_dtype()``, or
        None for a net outside the kernel's scope."""
        if not supports_kernel_decode(self):
            return None
        return samplernn_weight_pack(self, self._pallas_weight_dtype())

    def _chunk(self, pack, prompt, state, t0: int, n: int, seed: int, temperature):
        if pack is not None:
            return decode_chunk(pack, prompt, state, t0, n, seed, temperature)
        return decode_plain(self, prompt, state, t0, n, t0, n, seed, temperature)

    @torch.no_grad()
    def generate(self, prompts: Tuple, n_steps: int, temperature: Temperature = None,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor]:
        """Decode ``n_steps`` new samples after each prompt.  ``temperature``
        None is argmax; one value, or one a prompt.  Returns a tuple of one
        (B, prior_t + n_steps) tensor (prompt + generation) on the network's
        device."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temperature = row_temperatures(temperature, B, prompt.device)
        rf = self.rf
        if seed is None:
            seed = self.next_seed()
        pack = self._pack()
        if pack is not None and B < self._CHUNKED_MIN_B:
            toks = decode_single(pack, prompt, n_steps, seed, temperature)
        else:
            state = init_decode_state(self, prompt, self._generator)
            end, chunks = prior_t + n_steps, []
            for t0 in range(rf, end, self._CHUNK):
                n = min(self._CHUNK, end - t0)
                chunks.append(self._chunk(pack, prompt, state, t0, n, seed, temperature))
            toks = torch.cat(chunks, dim=1)[:, prior_t - rf :]
        out = torch.cat([prompt, toks], dim=1)
        return (out.to(torch.as_tensor(prompts[0]).dtype),)

    def stream(self, prompts: Tuple, chunk_steps: int, temperature: Temperature = None,
               seed: Optional[int] = None):
        """Unbounded generation: yield (B, chunk_steps) numpy token chunks
        forever, continuing exactly across chunks (the decode state is
        carried), so the concatenated stream equals one long decode.  Noise
        is keyed by absolute step, so sampled streams do not depend on
        ``chunk_steps`` either."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temperature = row_temperatures(temperature, B, prompt.device)
        if seed is None:
            seed = self.next_seed()
        pack = self._pack()
        state = init_decode_state(self, prompt, self._generator)
        C = min(chunk_steps, self._CHUNK)

        def dev_chunks():
            t_abs = self.rf
            while True:
                with torch.no_grad():
                    out = self._chunk(pack, prompt, state, t_abs, C, seed, temperature)
                drop = min(C, max(0, prior_t - t_abs))  # prompt warm-up rows
                t_abs += C
                yield out, drop

        from ..loops.streaming import _read_behind_chunks

        yield from _read_behind_chunks(dev_chunks(), chunk_steps)
