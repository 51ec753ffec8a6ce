"""The transformer networks, PyTorch port: SimpleTransformer and JukeBox.

Counterpart of ``mimikit_tpu/networks/transformers.py``.  Each decoder block
is flax's: causal self-attention, causal cross-attention over the same (PE'd)
input sequence, an FFN, post- or pre-norm.  Attention follows flax's
``MultiHeadDotProductAttention`` (q, k and v each projected, q divided by
sqrt(dH), masked scores at ``finfo(f32).min``, an f32 softmax) and the layer
norm is flax's (var = max(0, E[x²] - E[x]²), eps 1e-5).  State_dict names are
those of torch's ``nn.TransformerDecoderLayer`` inside PyTorch mimikit's nets
(``model.layers.{i}.self_attn.in_proj_weight`` (3d, d), ``multihead_attn.*``,
``linear1``/``linear2``, ``norm1..3``, ``model.norm``,
``input_module.heads.0.0.weight``, ``output_modules.0.estimator.0.fc.{k}``;
JukeBox's under ``tiers.{i}.``, with ``tiers.{i}.input_module.heads.{j}.2``
and ``tiers.{i}.up_sampler.fc``), the names
``mimikit_tpu/migrate.py:transformer_params_from_state_dict`` reads.

SimpleTransformer serving routes (the JAX package's semantics, not its TPU
budgets):

* ``generate`` with a prompt of at least ``rf`` tokens and a net in the
  decode kernels' scope
  (:func:`~..ops.transformer_decode.supports_kernel_decode`), up to
  ``_K6_MAX_BATCH`` (32) streams: one launch of the window-refeed kernel (K6,
  :func:`~..ops.transformer_decode.decode_window`; JAX's v5e-measured
  ``B == 1`` split, ``transformers.py:538-539``, is not carried over: on the
  H100 K6 beats the batched window route up to about 40 streams);
* more streams, or a net outside the scope: the window re-feed through the
  network's own batched eval forward;
* a prompt shorter than ``rf``: the KV-cached incremental decoder, which
  attends over the whole history (``_make_decoder``, ``:452-509``);
* ``stream``: re-feeding (``loops.streaming._refeed_stream``), so one K6
  launch a chunk, the weight pack built once a stream; under
  ``MMK_DECODE_KV=1`` a net in the scope streams through the KV-ring kernel
  (K7, :func:`~..ops.transformer_kv.decode_chunk`) at every B, in chunks of
  ``max(chunk_steps, 64)`` steps with the state on the card (PARITY.md #10:
  the KV ring's tokens part from the re-feed's after the first step).

JukeBox serving routes:

* ``generate``: the prompt left-padded with zeros to the window, then, for a
  net in the tier-pyramid kernel's scope
  (:func:`~..ops.jukebox_decode.supports_kernel_decode`), one launch of K8
  (:func:`~..ops.jukebox_decode.decode_pyramid`) at every B: up to
  ``_K8_CLUSTER_MAX_B`` streams on the cluster kernel (a stream a cluster
  of blocks, ``csrc/jukebox_cluster.cu``), up to ``K8_GROUP_ROUTE``'s limit
  on the group kernel (a group of streams a cluster,
  ``csrc/jukebox_group.cu``), more on the block kernel (a stream a block,
  ``csrc/jukebox_decode.cu``); outside the scope the window re-feed with
  its one-token lead;
* ``stream``: in the scope, one K8 launch a chunk with the (B, W) lead window
  carried on the card and the weight pack built once a stream (the kernel
  chosen by B alone, so every chunk takes the same one); outside it, the
  window re-feed (``_refeed_stream``, which re-feeds ``_window_len()``
  tokens).

bf16 routes, ``MMK_DECODE_BF16=1`` (``transformers.py:326-372,735-748``):

* the KV stream (with ``MMK_DECODE_KV=1``) of a net in K7's bf16 scope (d,
  ff and d / n_heads multiples of 8) runs K7 on a bfloat16 weight pack: each
  product's input rounded to bf16, sums, softmax, norms, PE rows and the K/V
  rings f32.  A net outside that scope streams through the f32 route, with a
  warning (JAX's fused gate warns and runs its f32 ring scan);
* the window re-feed (SimpleTransformer's ``generate`` past
  ``_K6_MAX_BATCH`` streams or outside K6's scope, JukeBox's outside K8's
  scope, and their re-feed streams) runs its forward on a bfloat16 copy of
  the net (``precision.cast_floats``) inside ``precision.compute(bfloat16)``:
  activations in bf16, the norms' statistics in f32, as flax computes them
  with bf16 parameters; the token buffer stays int.  The copy is built once
  a ``generate`` call, once a re-feed stream;
* K6 and K8 have no bf16 variant in JAX either: their routes stay f32.

bf16 tokens may part from the f32 ones at near-ties: the parity criterion of
these routes is teacher forcing (each token within a tolerance of its row's
maximum under the bf16 twin), not token identity.

Not carried over, because they budget a TPU core's VMEM or probe its layouts:
the gates ``_use_pallas_decode`` (SimpleTransformer ``:512-552``, JukeBox
``:1110-1152``) and ``_use_pallas_kv`` (``:554-593``, with its ``d % 128`` and
``rf % 8`` alignment) and the layout probes ``MMK_KV_NOREP``,
``MMK_KV_SLOT_MAJOR`` and ``MMK_KV_UNROLL``; nor does the port read
``MMK_PALLAS_DECODE``.
Where the JAX gate refuses a net it runs its oracle scan, which has the
kernel's semantics, so sending every net of the scope to the kernels changes
no tokens.  Nor is the fallback on a kernel failure
(``pallas_generate_or_fallback``, the KV stream's first-chunk retry
``:828-850``, JukeBox's first-chunk stream fallback ``:1295-1362``): a kernel
that fails raises.
"""
from __future__ import annotations

import dataclasses as dtc
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..features.functionals import Discrete
from ..features.item_spec import ItemSpec, Step
from ..modules.activations import _PLAIN
from ..modules.dense import Dense, dense
from ..modules.io import FramedConv1dIO, FramedLinearIO, ZipReduceVariables
from ..modules.resamplers import LinearResampler
from ..modules import rounding
from .. import precision
from ..ops import jukebox_decode as jbd
from ..ops.transformer_decode import (
    decode_window,
    layer_norm,
    supports_kernel_decode,
    transformer_weight_pack,
)
from ..ops.transformer_kv import decode_chunk, init_kv_state
from ..ops.temperature import Temperature, row_temperatures
from ..utils import resolve_device
from .arm import ARM, NetworkConfig

__all__ = ["PositionalEncoding", "SimpleTransformer", "TransformerTier", "JukeBox"]


def _decode_bf16() -> bool:
    """``MMK_DECODE_BF16=1``: the bf16 decode routes (see the module note)."""
    return os.environ.get("MMK_DECODE_BF16") == "1"


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal table (``transformers.py:40-48``), computed as the JAX
    package computes it (float64, stored as float32)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div_term = np.exp(
        np.arange(0, d_model, 2).astype(np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """``x + pe[:T]``, then dropout in training.  The table is a
    non-persistent buffer: it is no parameter, and ``migrate`` skips
    ``pe.pe``."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        self.dropout = dropout
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, d_model)),
                             persistent=False)

    def forward(self, x):
        x = x + self.pe[: x.shape[1]].to(x.dtype)
        return F.dropout(x, self.dropout, self.training) if self.dropout > 0 else x


def _softmax(scores):
    """Softmax over the last axis; below f32 each of flax's steps (the
    shifted scores, their exponentials, the sum, the quotient) is rounded to
    the scores' dtype, and on the CPU its gradient is JAX's
    (``rounding.softmax``)."""
    if scores.dtype == torch.float32:
        return torch.softmax(scores, dim=-1)
    return rounding.softmax(scores)


class LayerNorm(nn.Module):
    """Layer norm with flax's formula under torch's ``weight``/``bias`` names."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.dtype != torch.float32 and x.device.type == "cpu":
            # below f32 on the CPU, with JAX's gradient
            return rounding.layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


class MultiheadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` under torch's
    ``nn.MultiheadAttention`` parameter names: ``in_proj_weight`` stacks the
    q, k and v projections (3d, d), ``out_proj`` merges the heads."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim)

    def project(self, x, part: int):
        """q (0), k (1) or v (2) of ``x`` (..., d), split into heads."""
        d = x.shape[-1]
        w = self.in_proj_weight[part * d : (part + 1) * d]
        y = dense(x, w, self.in_proj_bias[part * d : (part + 1) * d])
        return y.reshape(*y.shape[:-1], self.n_heads, d // self.n_heads)

    def attend(self, q, k, v, mask=None):
        """q (B, Tq, nH, dH), k and v (B, Tk, nH, dH) -> (B, Tq, d).  q is
        divided by sqrt(dH) in q's dtype and masked scores are that dtype's
        lowest value, as flax does them."""
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
        # below f32 on the CPU, the products in XLA's order (rounding.matmul)
        xla = q.dtype != torch.float32 and q.device.type == "cpu"
        if xla:
            scores = rounding.attention_scores(q.transpose(1, 2), k.transpose(1, 2))
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        p = _softmax(scores)
        if self.dropout > 0 and self.training:
            p = F.dropout(p, self.dropout)
        if xla:
            out = rounding.attention_mix(p, v.transpose(1, 2)).transpose(1, 2)
        else:
            out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.out_proj(out.reshape(*out.shape[:2], -1))

    def forward(self, x, kv, mask=None):
        return self.attend(self.project(x, 0), self.project(kv, 1), self.project(kv, 2), mask)


class DecoderBlock(nn.Module):
    """torch ``TransformerDecoderLayer`` equivalent (``transformers.py:67-121``):
    self-attention, cross-attention on ``memory``, FFN; post- or pre-norm."""

    def __init__(self, model_dim: int, n_heads: int, feedforward_dim: int, dropout: float = 0.0,
                 activation: str = "ReLU", norm_first: bool = False):
        super().__init__()
        self.activation, self.norm_first, self.dropout = str(activation), norm_first, dropout
        self.self_attn = MultiheadAttention(model_dim, n_heads, dropout)
        self.multihead_attn = MultiheadAttention(model_dim, n_heads, dropout)
        self.linear1 = Dense(model_dim, feedforward_dim)
        self.linear2 = Dense(feedforward_dim, model_dim)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(model_dim) for _ in range(3))

    def _drop(self, v):
        return F.dropout(v, self.dropout, self.training) if self.dropout > 0 else v

    def _ffn(self, x):
        h = self._drop(_PLAIN[self.activation](self.linear1(x)))
        return self._drop(self.linear2(h))

    def forward(self, x, memory, mask=None):
        if self.norm_first:
            h = self.norm1(x)
            x = x + self._drop(self.self_attn(h, h, mask))
            x = x + self._drop(self.multihead_attn(self.norm2(x), memory, mask))
            return x + self._ffn(self.norm3(x))
        x = self.norm1(x + self._drop(self.self_attn(x, x, mask)))
        x = self.norm2(x + self._drop(self.multihead_attn(x, memory, mask)))
        return self.norm3(x + self._ffn(x))

    def step(self, x, memory, cache: dict):
        """One incremental decode step (flax ``decode=True``): ``x`` and
        ``memory`` are (B, 1, d); each attention appends its new key and
        value to ``cache`` and attends over every cached position."""
        def attend(attn, name, q_in, kv_in):
            k, v = attn.project(kv_in, 1), attn.project(kv_in, 2)
            if name in cache:
                k = torch.cat([cache[name][0], k], 1)
                v = torch.cat([cache[name][1], v], 1)
            cache[name] = (k, v)
            return attn.attend(attn.project(q_in, 0), k, v)

        if self.norm_first:
            h = self.norm1(x)
            x = x + attend(self.self_attn, "self", h, h)
            x = x + attend(self.multihead_attn, "cross", self.norm2(x), memory)
            return x + self._ffn(self.norm3(x))
        x = self.norm1(x + attend(self.self_attn, "self", x, x))
        x = self.norm2(x + attend(self.multihead_attn, "cross", x, memory))
        return self.norm3(x + self._ffn(x))


class DecoderStack(nn.Module):
    """``transformers.py:124-157``: the blocks under a causal mask, with the
    input itself as every block's ``memory``; an optional final norm."""

    def __init__(self, model_dim: int, n_heads: int, feedforward_dim: int, num_layers: int,
                 dropout: float = 0.0, activation: str = "ReLU", norm_first: bool = False,
                 with_layer_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            DecoderBlock(model_dim, n_heads, feedforward_dim, dropout, activation, norm_first)
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(model_dim) if with_layer_norm else None

    def forward(self, x):
        T = x.shape[1]
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
        memory = x
        for layer in self.layers:
            x = layer(x, memory, mask)
        return self.norm(x) if self.norm is not None else x

    def step(self, x, caches: List[dict]):
        memory = x
        for layer, cache in zip(self.layers, caches):
            x = layer.step(x, memory, cache)
        return self.norm(x) if self.norm is not None else x


class SimpleTransformerCore(nn.Module):
    """Input embedding -> positional encoding -> decoder stack -> heads
    (``transformers.py:160-223``)."""

    def __init__(self, cfg: dict, input_heads, output_modules):
        super().__init__()
        self.input_dropout = cfg["input_dropout"]
        self.input_module = ZipReduceVariables(mode="sum", heads=tuple(input_heads))
        self.pe = PositionalEncoding(cfg["model_dim"], dropout=0.0, max_len=2048)
        self.model = DecoderStack(
            model_dim=cfg["model_dim"], n_heads=cfg["n_heads"],
            feedforward_dim=cfg["feedforward_dim"], num_layers=cfg["num_layers"],
            dropout=cfg["dropout"], activation="ReLU", with_layer_norm=cfg["with_layer_norm"],
        )
        self.output_modules = nn.ModuleList(output_modules)

    def _heads(self, y, train: bool, temperature=None, generator=None):
        if train:
            return tuple(mod(y, train=True) for mod in self.output_modules)
        return tuple(mod(y, train=False, temperature=temperature, generator=generator)
                     for mod in self.output_modules)

    def forward(self, inputs: Tuple, train: bool = False, temperature=None,
                generator: Optional[torch.Generator] = None):
        """Train: per-target (B, T, Q) logits.  Eval: the heads' samples at
        the last position, argmax when ``temperature`` is None."""
        src = self.input_module(inputs)
        if train and self.input_dropout > 0:
            keep = torch.rand(src.shape[0], 1, src.shape[-1], device=src.device)
            keep = keep >= self.input_dropout
            src = torch.where(keep, src / (1.0 - self.input_dropout), torch.zeros_like(src))
        out = self.model(self.pe(src))
        if not train:
            return self._heads(out[:, -1:], False, temperature, generator)
        return self._heads(out, True)

    def decode_step(self, inputs: Tuple, t: int, caches: List[dict], temperature=None,
                    generator: Optional[torch.Generator] = None):
        """Incremental mode (``decode=True``): ``inputs`` are one step at
        absolute position ``t`` (absolute PE); ``caches`` (one dict a layer)
        grow by one position.  Past the table's end the last row repeats, as
        JAX's clamped ``dynamic_slice`` reads it."""
        table = self.pe.pe
        src = self.input_module(inputs) + table[min(t, table.shape[0] - 1)].to(torch.float32)
        out = self.model.step(src, caches)
        return self._heads(out, False, temperature, generator)


class _StatefulTransformerARM(ARM):
    """The ARM plumbing the transformer networks share
    (``transformers.py:226-396``): the network is its core module (listed
    after this class, so :meth:`_core` reaches the core's ``forward``), the
    eval forward samples with a ``torch.Generator``, and the window re-feed
    decode reads ``_window_len()`` tokens ending ``_decode_win_lead`` past
    the write position."""

    # how far past the write position the re-feed window reaches: 0 for a net
    # that reads every window token (SimpleTransformer), 1 for JukeBox, whose
    # core never reads the final window slot (PARITY.md #6)
    _decode_win_lead = 0

    def __init__(self, *, config, **core):
        super().__init__(**core)
        self._config = config

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) embeddings, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every
        projection, dense and conv weight and bias (``in_proj_bias`` zero),
        unit layer norms; drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
            elif isinstance(m, MultiheadAttention):
                bound = 1.0 / np.sqrt(m.in_proj_weight.shape[1])
                w = torch.rand(m.in_proj_weight.shape, generator=generator)
                m.in_proj_weight.copy_(w * (2 * bound) - bound)
                m.in_proj_bias.zero_()

    @property
    def config(self):
        return self._config

    @property
    def rf(self) -> int:
        return self._config.rf

    @property
    def generate_params(self):
        return {"temperature"}

    def _window_len(self) -> int:
        return self.rf

    def _sample_generator(self, seed: Optional[int] = None) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.next_seed() if seed is None else seed)

    def _core(self, inputs: Tuple, train: bool, temperature=None,
              generator: Optional[torch.Generator] = None):
        """The core module's forward."""
        return super().forward(inputs, train, temperature, generator)

    def forward(self, inputs: Tuple, **parameters):
        """Train mode: per-target (B, T, Q) logits.  Eval mode: one sample
        per stream at the last position, tempered by ``temperature``."""
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        if self.training:
            return self._core(inputs, True)
        return self._core(inputs, False, parameters.get("temperature"), self._sample_generator())

    # -- step-wise generation API (transformers.py:295-311) ------------------------
    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        pass

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """The eval forward on the window ``inputs``."""
        was = self.training
        self.eval()
        try:
            return self.forward(inputs, **parameters)
        finally:
            self.train(was)

    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        pass

    # -- serving -------------------------------------------------------------------
    def _prompt(self, prompts: Tuple) -> torch.Tensor:
        if len(prompts) != 1 or len(self.config.io_spec.targets) != 1:
            raise NotImplementedError("decoding supports one input and one target")
        return torch.as_tensor(prompts[0]).to(self.device, torch.int32).contiguous()

    def _window_net(self):
        """The module the window re-feed runs its forward on: the network,
        or under ``MMK_DECODE_BF16=1`` a bfloat16 copy of it
        (``precision.cast_floats``; ``transformers.py:351-372``)."""
        return precision.cast_floats(self, torch.bfloat16) if _decode_bf16() else self

    @torch.no_grad()
    def _window_loop(self, prompt: torch.Tensor, n_steps: int, temperature, seed: int,
                     net=None):
        """The window re-feed (``_make_window_decoder``): the token at t is
        the batched eval forward's sample on ``buf[t - W + lead : t + lead]``
        (W = ``_window_len()``, window-relative PE), appended to the buffer.
        With lead 1 the window's last slot is the never-read placeholder for
        t.  ``prompt`` holds at least W - lead tokens.  The forward runs on
        ``net`` (``_window_net()`` when None: a bf16 copy under
        ``MMK_DECODE_BF16=1``), in its parameters' dtype; the buffer stays
        int."""
        B, prior_t = prompt.shape
        W, lead = self._window_len(), self._decode_win_lead
        net = self._window_net() if net is None else net
        dtype = next(net.parameters()).dtype
        buf = torch.cat([prompt, prompt.new_zeros(B, n_steps)], 1).long()
        gen = self._sample_generator(seed)
        was = net.training
        net.eval()
        try:
            with precision.compute(dtype):
                for t in range(prior_t, prior_t + n_steps):
                    out = net._core((buf[:, t - W + lead : t + lead],), False, temperature, gen)
                    buf[:, t] = out[0].reshape(B)
        finally:
            net.train(was)
        return buf


class SimpleTransformer(_StatefulTransformerARM, SimpleTransformerCore):
    @dtc.dataclass
    class Config(NetworkConfig):
        io_spec: "IOSpec" = None  # noqa: F821
        model_dim: int = 256
        n_heads: int = 8
        feedforward_dim: int = 1024
        num_layers: int = 8
        with_layer_norm: bool = False
        dropout: float = 0.0
        input_dropout: float = 0.1
        rf: int = 64

    # the KV stream's kernel calls run at least this many steps
    _KV_MIN_CHUNK = 64
    # generate sends at most this many streams to K6, more to the batched
    # window route: K6's step grows with each stream (~245 us), the window
    # route's barely.  chip_smoke.py times both on an H100 at transformer8l's
    # widths: at B=32 K6 takes 7.9 ms a step against 13.9, at B=48 11.8
    # against 9.0
    _K6_MAX_BATCH = 32

    @classmethod
    def from_config(cls, config: "SimpleTransformer.Config", device=None,
                    seed: int = 0) -> "SimpleTransformer":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed``."""
        device = resolve_device(device)
        input_heads = [spec.module.copy().set(out_dim=config.model_dim).module()
                       for spec in config.io_spec.inputs]
        output_modules = [spec.module.copy().set(in_dim=config.model_dim).module()
                          for spec in config.io_spec.targets]
        cfg = dict(model_dim=config.model_dim, n_heads=config.n_heads,
                   feedforward_dim=config.feedforward_dim, num_layers=config.num_layers,
                   with_layer_norm=config.with_layer_norm, dropout=config.dropout,
                   input_dropout=config.input_dropout)
        net = cls(config=config, cfg=cfg, input_heads=input_heads, output_modules=output_modules)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    # -- batch specs (transformers.py:441-450) ---------------------------------
    def train_batch(self, item_spec: ItemSpec):
        return tuple(
            spec.to_batch_item(item_spec) for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=1, length=0, unit=Step()) + item_spec)
            for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        return self.train_batch(item_spec)

    # -- serving -------------------------------------------------------------------
    @torch.no_grad()
    def _kv_cache_loop(self, prompt: torch.Tensor, n_steps: int, temperature, seed: int):
        """The KV-cached incremental decoder (``_make_decoder``): step t feeds
        the prompt's token while t < prior_t, else the last prediction, with
        absolute PE, and attends over the whole history."""
        B, prior_t = prompt.shape
        prompt = prompt.long()
        gen = self._sample_generator(seed)
        caches = [{} for _ in self.model.layers]
        was = self.training
        self.eval()
        preds, cur = [], prompt[:, 0]
        try:
            for t in range(prior_t + n_steps - 1):
                tok = prompt[:, t] if t < prior_t else cur
                out = self.decode_step((tok[:, None],), t, caches, temperature, gen)
                cur = out[0].reshape(B)
                if t >= prior_t - 1:
                    preds.append(cur)
        finally:
            self.train(was)
        return torch.cat([prompt, torch.stack(preds, 1)], 1)

    @torch.no_grad()
    def generate(self, prompts: Tuple, n_steps: int, temperature: Temperature = None,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor]:
        """Decode ``n_steps`` tokens after each prompt.  ``temperature`` None
        is argmax; one value, or one a prompt.  Returns a tuple of one (B,
        prior_t + n_steps) tensor (prompt + generation) on the network's
        device."""
        return self._generate(prompts, n_steps, temperature, seed, None)

    def _generate(self, prompts: Tuple, n_steps: int, temperature, seed, built):
        """``generate``, with what its route builds once given (a re-feed
        stream builds it once: K6's weight pack, or the window route's net,
        ``_window_net()``) or built here."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temps = row_temperatures(temperature, B, prompt.device)
        if seed is None:
            seed = self.next_seed()
        if prior_t < self.rf:
            out = self._kv_cache_loop(prompt, n_steps, temperature, seed)
        elif self._k6_route(B):
            if built is None:
                built = transformer_weight_pack(self)
            out = torch.cat([prompt, decode_window(built, prompt, n_steps, seed, temps)], 1)
        else:
            out = self._window_loop(prompt, n_steps, temperature, seed, built)
        return (out.to(torch.as_tensor(prompts[0]).dtype),)

    def _k6_route(self, B: int) -> bool:
        """Whether ``generate`` decodes B streams (after a prompt of at
        least rf) through K6."""
        return B <= self._K6_MAX_BATCH and supports_kernel_decode(self)

    def stream(self, prompts: Tuple, chunk_steps: int, temperature: Temperature = None,
               seed: Optional[int] = None):
        """Unbounded generation: yield (B, chunk_steps) numpy token chunks
        forever.  Default: window re-feeding (exact: the window is the decode
        state).  ``MMK_DECODE_KV=1``: the O(1)-a-step KV-ring decode (K7),
        absolute PE and the rings carried on the card between launches of
        ``max(chunk_steps, 64)`` steps; its noise is keyed by absolute step,
        so every chunking draws the same tokens.  ``MMK_DECODE_BF16=1``: K7
        on a bfloat16 weight pack where K7's bf16 scope admits the net (else
        the f32 route, with a warning), and the re-feed's window route in
        bf16."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temps = row_temperatures(temperature, B, prompt.device)
        if seed is None:
            seed = self.next_seed()
        from ..loops.streaming import _read_behind_chunks, _refeed_stream

        kv = os.environ.get("MMK_DECODE_KV") == "1"
        if not kv or not supports_kernel_decode(self) or prior_t < 1:
            built = transformer_weight_pack(self) if self._k6_route(B) else self._window_net()

            def generate(prompts, n_steps, temperature, seed):
                return self._generate(prompts, n_steps, temperature, seed, built)

            yield from _refeed_stream(self, prompt, chunk_steps, temperature, seed, generate)
            return
        C = max(chunk_steps, self._KV_MIN_CHUNK)
        bf16 = _decode_bf16() and supports_kernel_decode(self, wbytes=2)
        pack = transformer_weight_pack(self, torch.bfloat16 if bf16 else torch.float32)
        prompt_T = prompt.t().contiguous()
        state = init_kv_state(pack, prompt)

        def dev_chunks():
            t_abs = 1
            while True:
                with torch.no_grad():
                    out = decode_chunk(pack, prompt_T, state, t_abs, C, temps, seed)
                drop = min(C, max(0, prior_t - t_abs))  # prompt echo rows
                t_abs += C
                yield out, drop

        yield from _read_behind_chunks(dev_chunks(), chunk_steps)


# -- JukeBox --------------------------------------------------------------------------

class TransformerTier(nn.Module):
    """A SampleRNN-style tier with a transformer in place of the RNN
    (``transformers.py:859-910``): the input module (a
    ``ZipReduceVariables`` of framed heads), ``+ x_upper``, the positional
    encoding, the decoder stack, tanh, then the linear up-sampler.  The
    bottom tier (``model_dim=None``) is its input module alone."""

    def __init__(self, input_module: nn.Module, model_dim: Optional[int] = 256, n_heads: int = 8,
                 feedforward_dim: int = 1024, num_layers: int = 8, with_layer_norm: bool = False,
                 dropout: float = 0.0, activation: str = "Mish", norm_first: bool = False,
                 positional_encoding: Optional[int] = 4096, up_sampling: Optional[int] = None):
        super().__init__()
        self.input_module = input_module
        self.model_dim = model_dim
        if model_dim is not None:
            self.pe = (PositionalEncoding(model_dim, dropout=0.0, max_len=positional_encoding)
                       if positional_encoding is not None else None)
            self.model = DecoderStack(
                model_dim=model_dim, n_heads=n_heads, feedforward_dim=feedforward_dim,
                num_layers=num_layers, dropout=dropout, activation=activation,
                norm_first=norm_first, with_layer_norm=with_layer_norm,
            )
        self.up_sampler = None
        if up_sampling is not None:
            self.up_sampler = LinearResampler(model_dim, t_factor=up_sampling, d_factor=1)

    def forward(self, inputs: Tuple, x_upper=None):
        x = self.input_module(inputs)
        if x_upper is not None:
            x = x + x_upper
        if self.model_dim is not None:
            if self.pe is not None:
                x = self.pe(x)
            x = _PLAIN["Tanh"](self.model(x))
        if self.up_sampler is not None:
            x = self.up_sampler(x)
        return x


class JukeBoxCore(nn.Module):
    """The tier pyramid (``transformers.py:913-940``).  Each upper tier of
    frame size fs reads ``x[:, fs0 - fs : T - fs]``; the bottom tier reads
    ``x[:, fs0 - fs : T - 1]``, so the final input token is never read (in
    training it is the last target).  In eval only the last bottom position
    goes to the heads."""

    def __init__(self, frame_sizes: Tuple[int, ...], tiers, output_modules):
        super().__init__()
        self.frame_sizes = tuple(frame_sizes)
        self.tiers = nn.ModuleList(tiers)
        self.output_modules = nn.ModuleList(output_modules)

    def forward(self, inputs: Tuple, train: bool = False, temperature=None,
                generator: Optional[torch.Generator] = None):
        prev = None
        fs0 = self.frame_sizes[0]
        for tier, fs in zip(self.tiers[:-1], self.frame_sizes[:-1]):
            prev = tier(tuple(x[:, fs0 - fs : x.shape[1] - fs] for x in inputs), prev)
        fs = self.frame_sizes[-1]
        prev = self.tiers[-1](tuple(x[:, fs0 - fs : x.shape[1] - 1] for x in inputs), prev)
        if train:
            return tuple(mod(prev, train=True) for mod in self.output_modules)
        return tuple(mod(prev[:, -1:], train=False, temperature=temperature, generator=generator)
                     for mod in self.output_modules)


class JukeBox(_StatefulTransformerARM, JukeBoxCore):
    """JukeBox: transformer tiers over framed mu-law tokens
    (``transformers.py:956-1416``).

    Its decode window leads the write position by one (``_decode_win_lead``,
    PARITY.md #6): the window for position t is ``buf[t - W + 1 : t + 1]``,
    whose last slot, the placeholder for t, the core never reads."""

    _decode_win_lead = 1

    @dtc.dataclass
    class Config(NetworkConfig):
        io_spec: "IOSpec" = None  # noqa: F821
        frame_sizes: Tuple[int, ...] = (32, 16, 4)
        model_dim: int = 256
        n_heads: int = 8
        feedforward_dim: int = 1024
        num_layers: int = 1
        layer_activation: str = "Mish"
        norm_first: bool = False
        with_layer_norm: bool = False
        dropout: float = 0.0
        positional_encoding: Optional[int] = 4096
        weight_norm: bool = False
        input_dropout: float = 0.0
        rf: int = 64
        ref_compat: bool = False

    @classmethod
    def from_config(cls, config: "JukeBox.Config", device=None, seed: int = 0) -> "JukeBox":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed``.  ``weight_norm``, ``ref_compat`` and embedding
        inputs (``EmbeddingConv1d``) are not ported (``ROADMAP.md``)."""
        device = resolve_device(device)
        if config.weight_norm or config.ref_compat:
            raise NotImplementedError(
                f"JukeBox weight_norm={config.weight_norm}, ref_compat={config.ref_compat}: weight"
                " norm and the Conv1dResampler scramble are not ported (ROADMAP.md)")
        for spec in config.io_spec.inputs:
            if not isinstance(spec.module, FramedLinearIO):
                raise NotImplementedError(
                    f"JukeBox inputs of {type(spec.module).__name__} (EmbeddingConv1d in the"
                    " bottom tier) are not ported (ROADMAP.md)")
        d, fs_list = config.model_dim, tuple(config.frame_sizes)
        tiers = []
        for i, fs in enumerate(fs_list[:-1]):
            mods = tuple(spec.module.copy().set(frame_size=fs, hop_length=fs, out_dim=d).module()
                         for spec in config.io_spec.inputs)
            tiers.append(TransformerTier(
                ZipReduceVariables(mode="sum", heads=mods), model_dim=d, n_heads=config.n_heads,
                feedforward_dim=config.feedforward_dim, num_layers=config.num_layers,
                with_layer_norm=config.with_layer_norm, dropout=config.dropout,
                activation=str(config.layer_activation), norm_first=config.norm_first,
                positional_encoding=config.positional_encoding,
                up_sampling=fs // (fs_list[i + 1] if i < len(fs_list) - 2 else 1),
            ))
        mods = []
        for spec in config.io_spec.inputs:
            params = (dict(class_size=spec.elem_type.size)
                      if isinstance(spec.elem_type, Discrete) else {})
            mods.append(FramedConv1dIO().set(**params, frame_size=fs_list[-1], hop_length=1,
                                             out_dim=d).module())
        tiers.append(TransformerTier(ZipReduceVariables(mode="sum", heads=tuple(mods)),
                                     model_dim=None))
        outputs = [spec.module.copy().set(in_dim=d).module() for spec in config.io_spec.targets]
        net = cls(config=config, frame_sizes=fs_list, tiers=tiers, output_modules=outputs)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    def _window_len(self) -> int:
        """The tier pyramid frames evenly at every level: ``rf`` rounded up to
        a multiple of ``frame_sizes[0]``, at least two top frames
        (``transformers.py:1091-1098``)."""
        fs0 = self._config.frame_sizes[0]
        return max(2 * fs0, -(-self.rf // fs0) * fs0)

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """Stepwise callers feed the lead-0 window ``[t - W, t)`` and write
        the result at t: drop the oldest token and append the placeholder
        slot, the same one-token lead as the fast decode
        (``transformers.py:972-987``)."""
        shifted = tuple(
            torch.cat([torch.as_tensor(x)[:, 1:], torch.as_tensor(x).new_zeros(len(x), 1)], 1)
            for x in inputs
        )
        return super().generate_step(shifted, t=t, **parameters)

    # -- batch specs (transformers.py:1387-1416) --------------------------------
    def train_batch(self, item_spec: ItemSpec):
        fs0 = self._config.frame_sizes[0]
        return tuple(
            spec.to_batch_item(ItemSpec(shift=0, length=fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        fs0 = self._config.frame_sizes[0]
        return tuple(
            spec.to_batch_item(item_spec.to(spec.unit)) for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(ItemSpec(shift=fs0, length=-fs0, unit=spec.unit) + item_spec)
            for spec in self.config.io_spec.targets
        )

    # -- serving -------------------------------------------------------------------
    def _padded(self, prompt: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """The prompt left-padded with zeros to the window (``:1160-1165``)
        and the pad's length."""
        pad = max(self._window_len() - prompt.shape[1], 0)
        if pad:
            prompt = torch.cat([prompt.new_zeros(prompt.shape[0], pad), prompt], 1)
        return prompt, pad

    @torch.no_grad()
    def generate(self, prompts: Tuple, n_steps: int, temperature: Temperature = None,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor]:
        """Decode ``n_steps`` tokens after each prompt (``:1216-1247``); a
        prompt shorter than the window is left-padded with zeros, then
        stripped.  A net in the kernel's scope decodes in one launch of the
        tier-pyramid kernel (K8) at every B, the cluster kernel up to
        ``_K8_CLUSTER_MAX_B`` streams, the group kernel up to
        ``K8_GROUP_ROUTE``'s limit, the block kernel beyond; others run the
        window re-feed.
        ``temperature`` None is argmax; one value, or one a prompt.  Returns
        a tuple of one (B, prior_t + n_steps) tensor on the network's
        device."""
        return self._generate(prompts, n_steps, temperature, seed, None)

    def _generate(self, prompts: Tuple, n_steps: int, temperature, seed, net):
        """``generate``, with the window route's net (``_window_net()``)
        given (a re-feed stream builds it once) or built here."""
        prompt = self._prompt(prompts)
        temps = row_temperatures(temperature, prompt.shape[0], prompt.device)
        if seed is None:
            seed = self.next_seed()
        x, pad = self._padded(prompt)
        if jbd.supports_kernel_decode(self):
            window = jbd.lead_window(x, self._window_len())
            toks = jbd.decode_pyramid(jbd.jukebox_weight_pack(self), window, x.shape[1], n_steps,
                                      seed, temps)
            out = torch.cat([x, toks.to(x.dtype)], 1)
        else:
            out = self._window_loop(x, n_steps, temperature, seed, net)
        return (out[:, pad:].to(torch.as_tensor(prompts[0]).dtype),)

    def stream(self, prompts: Tuple, chunk_steps: int, temperature: Temperature = None,
               seed: Optional[int] = None):
        """Unbounded generation: yield (B, chunk_steps) numpy token chunks
        forever (``:1249-1385``).  In the kernel's scope: one K8 launch a
        chunk (the cluster, group or block kernel, chosen by B alone, so one
        for the whole stream), the (B, W) lead window — JukeBox's whole decode
        state — carried on the device between launches, the weight pack
        built once; noise is
        keyed by absolute position, so the stream equals one long ``generate``
        with the same seed, argmax or sampled.  Otherwise the window
        re-feed."""
        prompt = self._prompt(prompts)
        temps = row_temperatures(temperature, prompt.shape[0], prompt.device)
        if seed is None:
            seed = self.next_seed()
        from ..loops.streaming import _read_behind_chunks, _refeed_stream

        if not jbd.supports_kernel_decode(self):
            net = self._window_net()

            def generate(prompts, n_steps, temperature, seed):
                return self._generate(prompts, n_steps, temperature, seed, net)

            yield from _refeed_stream(self, prompt, chunk_steps, temperature, seed, generate)
            return
        x, _ = self._padded(prompt)
        pack = jbd.jukebox_weight_pack(self)
        window = jbd.lead_window(x, self._window_len())

        def dev_chunks():
            t = x.shape[1]
            while True:
                with torch.no_grad():
                    out = jbd.decode_pyramid(pack, window, t, chunk_steps, seed, temps)
                t += chunk_steps
                yield out, 0

        yield from _read_behind_chunks(dev_chunks(), chunk_steps)
