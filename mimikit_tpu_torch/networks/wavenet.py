"""WaveNet: gated dilated convolutions, PyTorch port.

Counterpart of ``mimikit_tpu/networks/wavenet.py``.  Layers take and return
feature-last (B, T, D) tensors, the JAX package's layout; the convolutions
are ``nn.Conv1d`` under PyTorch mimikit's state_dict names (``layers.{i}.
conv_dil.0.0``, ``layers.{i}.conv_skip``, ``input_modules.0.0``,
``output_modules.0.estimator.0.fc.{k}``), the names
``mimikit_tpu/migrate.py:wavenet_params_from_state_dict`` reads.

Serving.  ``generate`` and ``stream`` run on the network's device.  A net in
the decode kernel's scope (:func:`~..ops.wavenet_decode.supports_kernel_decode`)
with a prompt of at least ``rf + 1`` samples goes through the hand-written
kernel: ``decode_single`` for fewer than ``_CHUNKED_MIN_B`` streams,
``decode_chunk`` (``_CHUNK`` steps a launch, state carried) for wider
batches and for every stream.  On the CPU the same wrappers run the plain
PyTorch twin.  A shorter prompt, or a net outside the scope, decodes with
the plain step loop over :meth:`WaveNetCore.warm_up` and
:meth:`WaveNetCore.decode_step` (a short prompt zero-padded on the left, as
the JAX scan decoder does), and streams by re-feeding its last ``rf + 1``
samples (``loops.streaming._refeed_stream``).

``tie_io_weights``: the JAX package ties an output Dense to the input
Dense's kernel at apply time; an embedding input has no such kernel and an
MLP head takes none, so with the port's IO modules (embedding in, MLP head
out) the flag changes nothing, exactly as in JAX.
"""
from __future__ import annotations

import dataclasses as dtc
import operator as opr
from itertools import accumulate, chain
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..features.item_spec import ItemSpec, Step
from ..modules.activations import _PLAIN
from ..modules.misc import causal_pad
from ..modules.rounding import bias_add
from ..ops.wavenet_decode import (
    decode_chunk,
    decode_single,
    init_decode_state,
    supports_kernel_decode,
    wavenet_weight_pack,
)
from ..ops.temperature import Temperature, row_temperatures
from ..utils import resolve_device
from .arm import ARM, NetworkConfig

__all__ = ["WNLayer", "WaveNetCore", "WaveNet"]


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d (or a Sequential around one) on a feature-last (B, T, C)
    tensor.  Below f32 the product is rounded before the bias is added, as
    flax's ``nn.Conv`` does with bf16 parameters, and on the CPU the bias's
    gradient is summed as JAX's (``rounding.bias_add``)."""
    cv = conv[0] if isinstance(conv, nn.Sequential) else conv
    if x.dtype == torch.float32 or cv.bias is None:
        return conv(x.transpose(1, 2)).transpose(1, 2)
    y = F.conv1d(x.transpose(1, 2), cv.weight, None, cv.stride, cv.padding, cv.dilation,
                 cv.groups)
    return bias_add(y.transpose(1, 2), cv.bias)


class WNLayer(nn.Module):
    """One gated dilated block (``mimikit_tpu/networks/wavenet.py:37-205``).

    ``forward(inputs_dilated, inputs_1x1, skips)`` -> ``(y, skips)``.  With
    ``decode=True`` the inputs are exact ``cause + 1``-long windows and no
    padding or trimming applies."""

    def __init__(self, input_dim: Optional[int] = None, dims_dilated: Tuple[int, ...] = (128,),
                 dims_1x1: Tuple[int, ...] = (), residuals_dim: Optional[int] = None,
                 apply_residuals: bool = False, skips_dim: Optional[int] = None,
                 kernel_size: int = 2, groups: int = 1, act_f: str = "Tanh",
                 act_g: Optional[str] = "Sigmoid", pad_side: int = 1, stride: int = 1,
                 use_bias: bool = True, dilation: int = 1, with_affine_residuals: bool = False):
        super().__init__()
        self.input_dim, self.dims_dilated, self.dims_1x1 = input_dim, tuple(dims_dilated), tuple(dims_1x1)
        self.residuals_dim, self.apply_residuals = residuals_dim, apply_residuals
        self.skips_dim, self.kernel_size, self.groups = skips_dim, kernel_size, groups
        self.act_f, self.act_g = act_f, act_g
        self.pad_side, self.stride, self.use_bias = pad_side, stride, use_bias
        self.dilation, self.with_affine_residuals = dilation, with_affine_residuals
        in_dim, inner, outer = self._dims()
        mult = 2 if self.has_gated_units else 1
        # only the first dilated conv is ever applied (as in the JAX layer)
        self.conv_dil = nn.ModuleList([nn.Sequential(nn.Conv1d(
            in_dim, self.dims_dilated[0] * mult, kernel_size, stride=stride, dilation=dilation,
            groups=groups, bias=use_bias))])
        self.conv_1x1 = nn.ModuleList([
            nn.Sequential(nn.Conv1d(d, inner * mult, 1, stride=stride, bias=use_bias))
            for d in self.dims_1x1
        ])
        if self.has_skips:
            self.conv_skip = nn.Conv1d(inner, skips_dim, 1, bias=use_bias)
        if self.has_residuals:
            self.conv_res = nn.Conv1d(inner, outer, 1, bias=use_bias)
        if with_affine_residuals:
            self.aff_res = nn.Linear(in_dim, 3 * in_dim)

    @property
    def cause(self) -> int:
        return (self.kernel_size - 1) * self.dilation

    @property
    def needs_padding(self) -> bool:
        return self.pad_side != 0

    @property
    def has_gated_units(self) -> bool:
        return self.act_g is not None

    @property
    def has_skips(self) -> bool:
        return self.skips_dim is not None

    @property
    def has_residuals(self) -> bool:
        return self.residuals_dim is not None and (
            self.input_dim is None or self.input_dim == self.residuals_dim
        )

    def _dims(self):
        if self.residuals_dim is None:
            inner = outer = self.dims_dilated[0]
        else:
            outer, inner = self.residuals_dim, self.dims_dilated[0]
        return (outer if self.input_dim is None else self.input_dim), inner, outer

    def _affine(self, x):
        x_hat, a, b = torch.chunk(self.aff_res(x), 3, dim=-1)
        return x_hat * a + b

    def trim_cause(self, x):
        cs = self.cause
        if cs == 0:
            return x
        return x[:, cs:] if self.pad_side >= 0 else x[:, :-cs]

    def forward(self, inputs_dilated: Tuple, inputs_1x1: Tuple = (), skips=None,
                decode: bool = False):
        act_f = _PLAIN[str(self.act_f)]
        x_in = inputs_dilated[0]
        if self.needs_padding and not decode:
            x_in = causal_pad(x_in, (self.pad_side * self.cause, 0))
        trim_1x1 = not self.needs_padding and not decode
        if self.has_gated_units:
            act_g = _PLAIN[str(self.act_g)]
            cond_f, cond_g = 0.0, 0.0
            for conv, c in zip(self.conv_1x1, inputs_1x1):
                y_f, y_g = torch.chunk(_conv(conv, self.trim_cause(c) if trim_1x1 else c), 2, -1)
                cond_f, cond_g = cond_f + y_f, cond_g + y_g
            if self.with_affine_residuals:
                x_in = self._affine(x_in)
            x_f, x_g = torch.chunk(_conv(self.conv_dil[0], x_in), 2, -1)
            y = act_f(x_f + cond_f) * act_g(x_g + cond_g)
        else:
            cond = 0.0
            for conv, c in zip(self.conv_1x1, inputs_1x1):
                if trim_1x1:
                    c = self.trim_cause(c)
                if self.with_affine_residuals:
                    c = self._affine(c) + c
                cond = cond + _conv(conv, c)
            if self.with_affine_residuals:
                x_in = self._affine(x_in)
            y = act_f(_conv(self.conv_dil[0], x_in) + cond)
        if self.has_skips:
            if skips is not None and not self.needs_padding and not decode:
                skips = self.trim_cause(skips)
            z = _conv(self.conv_skip, y)
            skips = z if skips is None else z + skips
        if self.has_residuals:
            if decode:
                x_res = inputs_dilated[0][:, -1:]
            elif not self.needs_padding:
                x_res = self.trim_cause(inputs_dilated[0])
            else:
                x_res = inputs_dilated[0]
            y = x_res + _conv(self.conv_res, y)
        return y, skips


class WaveNetCore(nn.Module):
    """Input modules -> layer stack -> output heads
    (``mimikit_tpu/networks/wavenet.py:208-322``)."""

    def __init__(self, layers_cfg: Tuple[dict, ...], input_modules, output_modules,
                 skips_dim: Optional[int], pad_side: int, layerwise_inputs: bool,
                 reverse_layer_order: bool):
        super().__init__()
        cfgs = tuple(reversed(layers_cfg)) if reverse_layer_order else tuple(layers_cfg)
        self.input_modules = nn.ModuleList(input_modules)
        self.layers = nn.ModuleList([WNLayer(**cfg) for cfg in cfgs])
        self.output_modules = nn.ModuleList(output_modules)
        self.skips_dim, self.pad_side = skips_dim, pad_side
        self.layerwise_inputs = layerwise_inputs

    @property
    def eval_slice(self):
        return slice(-1, None) if self.pad_side == 1 else slice(0, 1)

    def _adapt_inputs(self, inputs):
        return tuple(mod(x) for mod, x in zip(self.input_modules, inputs))

    def _heads(self, y, train: bool, temperature=None, generator=None):
        if train:
            return tuple(mod(y, train=True) for mod in self.output_modules)
        return tuple(mod(y, train=False, temperature=temperature, generator=generator)
                     for mod in self.output_modules)

    def forward(self, inputs: Tuple, train: bool = False, temperature=None,
                generator: Optional[torch.Generator] = None):
        """Train: per-target (B, T', Q) logits.  Eval: the heads' samples at
        the eval position (``eval_slice``), argmax when ``temperature`` is
        None."""
        xs = self._adapt_inputs(inputs)
        dilated, in_1x1, skips = xs[0], xs[1:], None
        for layer in self.layers:
            dilated, skips = layer((dilated,), in_1x1, skips)
            if self.layerwise_inputs:
                dilated = dilated + xs[0][:, -dilated.shape[1]:]
            if not layer.needs_padding:
                in_1x1 = tuple(layer.trim_cause(x) for x in in_1x1)
        y = skips if self.skips_dim is not None else dilated
        if not train:
            y = y[:, self.eval_slice]
        return self._heads(y, train, temperature, generator)

    # -- step-wise decode --------------------------------------------------------
    def warm_up(self, inputs: Tuple):
        """Run the stack over an rf-long window; returns each layer's last
        ``cause`` inputs (the state :meth:`decode_step` expects)."""
        xs = self._adapt_inputs(inputs)
        dilated, in_1x1 = xs[0], xs[1:]
        buffers, skips = [], None
        for layer in self.layers:
            buffers.append(dilated[:, -layer.cause:] if layer.cause > 0 else dilated[:, :0])
            dilated, skips = layer((dilated,), in_1x1, skips)
            if self.layerwise_inputs:
                dilated = dilated + xs[0][:, -dilated.shape[1]:]
            if not layer.needs_padding:
                in_1x1 = tuple(layer.trim_cause(x) for x in in_1x1)
        return tuple(buffers)

    def decode_step(self, samples: Tuple, buffers, temperature=None,
                    generator: Optional[torch.Generator] = None):
        """One step: ``samples`` are the newest (B, 1) input values; returns
        (the heads' samples, the new buffers)."""
        xs = self._adapt_inputs(samples)
        dilated, in_1x1 = xs[0], xs[1:]
        skips, new_buffers = None, []
        for layer, buf in zip(self.layers, buffers):
            window = torch.cat([buf, dilated], dim=1)
            new_buffers.append(window[:, 1:] if layer.cause > 0 else buf)
            dilated, skips = layer((window,), in_1x1, skips, decode=True)
            if self.layerwise_inputs:
                dilated = dilated + xs[0]
        y = skips if self.skips_dim is not None else dilated
        return self._heads(y, False, temperature, generator), tuple(new_buffers)


class WaveNet(WaveNetCore, ARM):
    @dtc.dataclass
    class Config(NetworkConfig):
        io_spec: "IOSpec" = None  # noqa: F821
        kernel_sizes: Tuple[int, ...] = (2,)
        blocks: Tuple[int, ...] = (4,)
        dims_dilated: Tuple[int, ...] = (128,)
        dims_1x1: Tuple[int, ...] = ()
        residuals_dim: Optional[int] = None
        apply_residuals: bool = False
        skips_dim: Optional[int] = None
        with_affine_residuals: bool = False
        groups: int = 1
        act_f: str = "Tanh"
        act_g: Optional[str] = "Sigmoid"
        pad_side: int = 0
        stride: int = 1
        bias: bool = True
        use_fast_generate: bool = True
        tie_io_weights: bool = False
        layerwise_inputs: bool = False
        reverse_layer_order: bool = False

    # streams below this decode in one launch (decode_single); at and above
    # it, and for every stream, in _CHUNK-step launches (decode_chunk)
    _CHUNKED_MIN_B = 32
    _CHUNK = 1024

    @classmethod
    def get_kernels_and_dilation(cls, kernel_sizes, blocks):
        """The four block/kernel spellings (``wavenet.py:349-379``)."""
        if not blocks:
            dilation = accumulate([1, *kernel_sizes], opr.mul)
        elif len(set(blocks)) == 1 and set(blocks).pop() == len(kernel_sizes):
            dilation = chain(*[
                list(accumulate([1, *kernel_sizes[:-1]], opr.mul)) for _ in range(len(blocks))
            ])
            kernel_sizes = chain(*([kernel_sizes] * len(blocks)))
        elif len(kernel_sizes) == sum(blocks):
            cum_blocks = list(accumulate(blocks, opr.add))
            dilation = []
            for start, stop in zip([0] + cum_blocks, cum_blocks):
                dilation += list(accumulate([1, *kernel_sizes[start : stop - 1]], opr.mul))
        elif len(kernel_sizes) == 1:
            k = kernel_sizes[0]
            kernel_sizes = (k for _ in range(sum(blocks)))
            dilation = (k ** i for block in blocks for i in range(block))
        else:
            raise ValueError(
                "number of layers and number of kernel sizes not compatible."
                f" Got kernel_sizes={kernel_sizes} ; blocks={blocks}"
            )
        return kernel_sizes, dilation

    @classmethod
    def get_layers_cfg(cls, config: "WaveNet.Config") -> List[dict]:
        kernel_sizes, dilation = cls.get_kernels_and_dilation(config.kernel_sizes, config.blocks)
        pairs = list(zip(kernel_sizes, dilation))
        n_layers = len(pairs)
        return [
            dict(
                input_dim=config.dims_dilated[0],
                dims_dilated=tuple(config.dims_dilated),
                dims_1x1=tuple(config.dims_1x1),
                residuals_dim=config.residuals_dim if n != n_layers - 1 else None,
                apply_residuals=config.apply_residuals and n != 0,
                skips_dim=config.skips_dim,
                kernel_size=k,
                groups=config.groups,
                act_f=str(config.act_f),
                act_g=str(config.act_g) if config.act_g is not None else None,
                pad_side=config.pad_side,
                stride=config.stride,
                use_bias=config.bias,
                dilation=d,
                with_affine_residuals=config.with_affine_residuals,
            )
            for n, (k, d) in enumerate(pairs)
        ]

    @classmethod
    def from_config(cls, config: "WaveNet.Config", device=None, seed: int = 0) -> "WaveNet":
        """Build the network on ``device`` (default: the card), with weights
        drawn from ``seed``."""
        device = resolve_device(device)
        io = config.io_spec
        if len(io.inputs) != 1 or config.dims_1x1:
            raise NotImplementedError(
                "multi-input WaveNets (a second io_spec input feeding dims_1x1) are not ported"
            )
        all_dims = [*config.dims_dilated, *config.dims_1x1]
        input_modules = [
            spec.module.copy().set(out_dim=h).module() for spec, h in zip(io.inputs, all_dims)
        ]
        out_dim = config.skips_dim if config.skips_dim is not None else all_dims[0]
        output_modules = [spec.module.copy().set(in_dim=out_dim).module() for spec in io.targets]
        net = cls(
            config=config,
            layers_cfg=tuple(cls.get_layers_cfg(config)),
            input_modules=input_modules,
            output_modules=output_modules,
            skips_dim=config.skips_dim,
            pad_side=config.pad_side,
            layerwise_inputs=config.layerwise_inputs,
            reverse_layer_order=config.reverse_layer_order,
        )
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(device)

    def __init__(self, *, config: "WaveNet.Config", **core):
        super().__init__(**core)
        self._config = config
        self._gen_buffers = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for the convolutions and dense layers and N(0, 1) for the embedding,
        drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    @property
    def config(self) -> "WaveNet.Config":
        return self._config

    @property
    def rf(self) -> int:
        return 1 + sum((c["kernel_size"] - 1) * c["dilation"]
                       for c in self.get_layers_cfg(self.config))

    @property
    def shift(self) -> int:
        return 1 if self.config.pad_side == 1 else self.rf

    def output_length(self, n_input_steps: int) -> int:
        if self.config.pad_side != 0:
            return n_input_steps
        return n_input_steps - self.shift + 1

    @property
    def use_fast_generate(self) -> bool:
        return self.config.use_fast_generate

    @property
    def generate_params(self):
        out = set()
        for t_spec in self.config.io_spec.targets:
            sampler = t_spec.objective.get_sampler()
            out |= set(getattr(sampler, "sampling_params", ()) or ())
        return out

    def _sample_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.next_seed())

    def forward(self, inputs: Tuple, **parameters):
        """Train mode: per-target (B, T', Q) logits.  Eval mode: one sample
        per stream at the eval position, tempered by ``temperature``.  An
        input shorter than the receptive field raises (``pad_side=0``)."""
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        if self.config.pad_side == 0 and inputs[0].shape[1] < self.rf:
            raise RuntimeError(
                f"input length {inputs[0].shape[1]} is below the receptive field {self.rf}"
            )
        if self.training:
            return super().forward(inputs, train=True)
        return super().forward(inputs, train=False, temperature=parameters.get("temperature"),
                               generator=self._sample_generator())

    # -- batch specs (wavenet.py:535-546) -------------------------------------
    def train_batch(self, item_spec: ItemSpec):
        return tuple(
            spec.to_batch_item(item_spec) for spec in self.config.io_spec.inputs
        ), tuple(
            spec.to_batch_item(
                item_spec + ItemSpec(self.shift, self.output_length(0), unit=Step())
            )
            for spec in self.config.io_spec.targets
        )

    def test_batch(self, item_spec: ItemSpec):
        return self.train_batch(item_spec)

    # -- serving -------------------------------------------------------------------
    def _prompt(self, prompts: Tuple) -> torch.Tensor:
        if len(prompts) != 1 or len(self.config.io_spec.targets) != 1:
            raise NotImplementedError("decoding supports one input and one target")
        return torch.as_tensor(prompts[0]).to(self.device, torch.int32).contiguous()

    def _kernel_route(self, prior_t: int) -> bool:
        return prior_t >= self.rf + 1 and supports_kernel_decode(self)

    @torch.no_grad()
    def _step_loop(self, prompt: torch.Tensor, n_steps: int, temperature, seed: int):
        """The plain step loop (the JAX scan decoder's semantics): warm up on
        the rf samples before ``prior_t - 1`` (a short prompt zero-padded on
        the left), then one :meth:`decode_step` a sample."""
        B, prior_t = prompt.shape
        rf = self.rf
        pad_left = max(0, rf + 1 - prior_t)
        buf = torch.cat([prompt.new_zeros(B, pad_left), prompt, prompt.new_zeros(B, n_steps)], 1)
        buf = buf.long()
        start = prior_t + pad_left
        gen = torch.Generator(device=self.device).manual_seed(seed)
        buffers = self.warm_up((buf[:, start - 1 - rf : start - 1],))
        for t in range(start, start + n_steps):
            outs, buffers = self.decode_step((buf[:, t - 1 : t],), buffers, temperature, gen)
            buf[:, t] = outs[0][:, 0]
        return buf[:, pad_left:]

    @torch.no_grad()
    def generate(self, prompts: Tuple, n_steps: int, temperature: Temperature = None,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor]:
        """Decode ``n_steps`` new samples after each prompt.  ``temperature``
        None is argmax; one value, or one a prompt.  Returns a tuple of one
        (B, prior_t + n_steps) tensor (prompt + generation) on the network's
        device."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temps = row_temperatures(temperature, B, prompt.device)
        if seed is None:
            seed = self.next_seed()
        if not self._kernel_route(prior_t):
            out = self._step_loop(prompt, n_steps, temperature, seed)
        else:
            temperature = temps
            pack = wavenet_weight_pack(self)
            if B < self._CHUNKED_MIN_B:
                toks = decode_single(pack, prompt, n_steps, seed, temperature)
            else:
                state = init_decode_state(pack, prompt)
                end, chunks = prior_t + n_steps, []
                for t0 in range(1, end, self._CHUNK):
                    n = min(self._CHUNK, end - t0)
                    chunks.append(decode_chunk(pack, prompt, state, t0, n, seed, temperature))
                # column j of the chunks holds position 1 + j
                toks = torch.cat(chunks, dim=1)[:, prior_t - 1 :]
            out = torch.cat([prompt, toks], dim=1)
        return (out.to(torch.as_tensor(prompts[0]).dtype),)

    def stream(self, prompts: Tuple, chunk_steps: int, temperature: Temperature = None,
               seed: Optional[int] = None):
        """Unbounded generation: yield (B, chunk_steps) numpy token chunks
        forever, continuing exactly across chunks.  In the kernel's route the
        token carry and the rings stay on the card between ``decode_chunk``
        launches of ``chunk_steps`` steps, and the noise is keyed by absolute
        step, so argmax and sampled streams both equal one ``generate`` with
        the same seed.  Otherwise the last ``rf + 1`` samples are re-fed
        (exact for WaveNet, whose state is that window)."""
        prompt = self._prompt(prompts)
        B, prior_t = prompt.shape
        temps = row_temperatures(temperature, B, prompt.device)
        if seed is None:
            seed = self.next_seed()
        from ..loops.streaming import _read_behind_chunks, _refeed_stream

        if not self._kernel_route(prior_t):
            yield from _refeed_stream(self, prompt, chunk_steps, temperature, seed)
            return
        temperature = temps
        pack = wavenet_weight_pack(self)
        state = init_decode_state(pack, prompt)

        def dev_chunks():
            t_abs = 1
            while True:
                with torch.no_grad():
                    out = decode_chunk(pack, prompt, state, t_abs, chunk_steps, seed, temperature)
                drop = min(chunk_steps, max(0, prior_t - t_abs))  # prompt echo rows
                t_abs += chunk_steps
                yield out, drop

        yield from _read_behind_chunks(dev_chunks(), chunk_steps)

    # -- step-wise generation API (wavenet.py:995-1027) --------------------------
    def before_generate(self, prompts: Tuple, batch_index: int) -> None:
        self._gen_buffers = None

    @torch.no_grad()
    def generate_step(self, inputs: Tuple, *, t: int = 0, **parameters):
        """One step of a step-wise generation loop.  The first call warms the
        buffers up on the full window and answers from the forward (by
        argmax, as the JAX package does); later calls decode one step from
        the window's last sample."""
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        if not self.use_fast_generate:
            return self.forward(inputs, **parameters)
        if self._gen_buffers is None:
            self._gen_buffers = self.warm_up(inputs)
            return WaveNetCore.forward(self, inputs, train=False,
                                       generator=self._sample_generator())
        outs, self._gen_buffers = self.decode_step(
            tuple(x[:, -1:] for x in inputs), self._gen_buffers,
            parameters.get("temperature"), self._sample_generator(),
        )
        return outs

    def after_generate(self, final_outputs: Tuple, batch_index: int) -> None:
        self._gen_buffers = None
