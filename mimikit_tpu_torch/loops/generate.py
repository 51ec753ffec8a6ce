"""Autoregressive generation over prompts drawn from a dataset
(counterpart of ``mimikit_tpu/loops/generate.py``).

``GenerateLoopV2`` serves batches of prompts from the dataset and decodes
each batch through the network's whole-decode ``generate`` (on the card the
net's decode kernel: K1/K2 for SampleRNN, K4/K5 for WaveNet, K6 for
SimpleTransformer, K8 for JukeBox) when its signature takes every sampler
parameter; otherwise through the stepwise loop, which calls the ARM
contract's ``generate_step`` once a step (the reference semantics,
multi-step ``until`` writes included).  The outputs leave the device once
a batch, then go through the targets' inverse transforms to the
``AudioLogger`` (``Functional.apply_to_outputs``: mu-law expansion on the
host, Griffin-Lim, ``MagSpec``'s inverse, on the network's device).

``EncodeDecodeLoop`` (``:427-494``) is the autoencoders' loop: it re-encodes
each prompt in windows of the net's ``rf`` (one pass over the whole prompt
where ``rf`` is 0, ``TiedAE``), writing each window's outputs in place over
the window's last samples (JAX's write, ``tensor[:, t - n_out : t]`` with
``n_out = min(len(out), prior_t - t)``: at ``t == prior_t`` that is no
sample, so a one-pass net leaves the prompt as it was), on the net's
device; the buffers leave the device once a batch.
"""
from __future__ import annotations

import dataclasses as dtc
import inspect
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.batch import Getter, Input, process_batch
from ..data.samplers import IndicesSampler
from ..features.item_spec import Frame, ItemSpec, Sample, Second, convert
from .callbacks import tqdm
from .logger import AudioLogger

__all__ = ["GenerateLoopV2", "EncodeDecodeLoop", "prepare_prompt", "generate_tqdm"]


def prepare_prompt(prompt, n_blanks: int, at_least_nd: int = 2):
    """Each array of ``prompt`` (a nested batch) with at least
    ``at_least_nd`` dims and ``n_blanks`` zero steps appended."""
    def _prepare(p):
        p = np.asarray(p)
        while p.ndim < at_least_nd:
            p = p[None]
        if n_blanks > 0:
            blanks = np.zeros((p.shape[0], n_blanks, *p.shape[2:]), p.dtype)
            return np.concatenate((p, blanks), axis=1)
        return p

    return process_batch(prompt, lambda x: isinstance(x, np.ndarray), _prepare)


def generate_tqdm(rng):
    return tqdm(rng, desc="Generate", dynamic_ncols=True, leave=False, unit="step",
                mininterval=1.0)


def _fill(x, prior_t: int, n_steps: int) -> np.ndarray:
    """[prompt | zeros]: the output buffer."""
    x = np.asarray(x)
    blanks = np.zeros((x.shape[0], n_steps, *x.shape[2:]), x.dtype)
    return np.concatenate([x, blanks], axis=1)


class PromptIndices(Input):
    """Pseudo-input yielding the drawn prompt index itself."""

    def __init__(self, n: int):
        super().__init__(data=None, getter=Getter(n=n))

    def __call__(self, item, file=None, **kwargs):
        return np.array([item], dtype=np.int32)


class GenerateLoopV2:
    @dtc.dataclass
    class Config(Config):
        output_duration_sec: float = 1.0
        prompts_length_sec: float = 1.0
        prompts_position_sec: Tuple[Optional[float], ...] = (None,)
        parameters: Optional[Dict[str, Any]] = None
        batch_size: int = 1
        downsampling: int = 1

        output_name_template: Optional[str] = None
        display_waveform: bool = True
        write_waveform: bool = False
        yield_inversed_outputs: bool = True
        callback: Optional[Callable] = None

    @classmethod
    def get_n_steps(cls, config: "GenerateLoopV2.Config", network) -> int:
        io_spec = network.config.io_spec
        output_n_samples = int(io_spec.sr * config.output_duration_sec)
        if isinstance(io_spec.unit, Frame):
            return convert(output_n_samples, Sample(1), io_spec.unit, as_length=True) + 1
        return output_n_samples

    @classmethod
    def get_dataloader(cls, config, dataset, network):
        """Batches of ``(prompt index, *the net's test_batch inputs)`` at the
        prompt positions: each of ``prompts_position_sec`` in seconds, or
        drawn (a fresh draw every pass) where it is None."""
        sr = network.config.io_spec.sr
        prompt_n_samples = int(sr * config.prompts_length_sec)
        max_i = dataset.signal.shape[0] - prompt_n_samples
        prompt_spec = ItemSpec(0, length=config.prompts_length_sec, unit=Second(sr))
        prompt_batch, _ = network.test_batch(prompt_spec)
        prompt_batch = (PromptIndices(n=max_i), *prompt_batch)
        indices = tuple(int(x * sr) if x is not None else x for x in config.prompts_position_sec)
        return dataset.serve(
            prompt_batch,
            sampler=IndicesSampler(N=len(indices), indices=indices, max_i=max_i, redraw=True,
                                   sampling_stride=config.downsampling),
            shuffle=False,
            batch_size=config.batch_size,
        )

    @classmethod
    def from_config(cls, config: "GenerateLoopV2.Config", dataset, network):
        n_steps = cls.get_n_steps(config, network)
        dataloader = cls.get_dataloader(config, dataset, network)
        logger = AudioLogger(
            sr=network.config.io_spec.sr,
            file_template=config.output_name_template if config.write_waveform else None,
            title_template=config.output_name_template if config.display_waveform else None,
        )
        return cls(config, network, n_steps, dataloader, logger)

    def __init__(self, config, network, n_steps, dataloader, logger=None):
        self.config = config
        self.network = network
        self.n_steps = n_steps
        self.dataloader = dataloader
        self.logger = logger
        self.template_vars = {}
        self._was_training = False

    def setup(self):
        self._was_training = self.network.training
        self.network.eval()

    def teardown(self):
        if self._was_training:
            self.network.train()

    def _gather_params(self) -> dict:
        params = self.config.parameters or {}
        return {k: v for k, v in params.items() if k in self.network.generate_params}

    def run(self):
        self.setup()
        for batch in self.dataloader:
            prompt_idx, batch = batch[0], batch[1:]
            prompt_idx = np.asarray(prompt_idx).reshape(-1)
            params = self._gather_params()
            if self._fast_path_accepts(params):
                # the whole decode in one call, every gathered sampler parameter
                # passed on: the host prompts go to the net's device once, the
                # outputs leave it once
                dev = self.network.device
                prompts = tuple(torch.as_tensor(b).to(dev) for b in batch)
                final_outputs = tuple(
                    b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
                    for b in self.network.generate(prompts, self.n_steps, **params)
                )
            else:
                if (getattr(self.network, "generate", None) is not None
                        and not getattr(self, "_warned_stepwise", False)
                        and self._device_step_fn(params) is None):
                    # a parameter that generate does not take sends the decode
                    # to the stepwise loop, orders of magnitude slower: say so
                    unsupported = sorted(
                        set(params) - set(inspect.signature(self.network.generate).parameters))
                    warnings.warn(
                        f"{type(self.network).__name__} has a fast whole-decode `generate`,"
                        f" but sampler param(s) {unsupported} are not in its signature —"
                        " falling back to the per-step reference loop, which can be"
                        " >10,000x slower. Drop the unsupported param(s) to use the fast"
                        " path.",
                        stacklevel=2,
                    )
                    self._warned_stepwise = True
                final_outputs = self._stepwise(batch, prompt_idx, params)
            outputs = self.process_outputs(final_outputs, prompt_idx, **self.template_vars)
            yield outputs
            if self.config.callback is not None:
                self.config.callback(outputs)
        self.teardown()

    def _fast_path_accepts(self, params: dict) -> bool:
        """True when the network has a whole-decode ``generate`` whose
        signature covers every gathered sampler parameter."""
        gen = getattr(self.network, "generate", None)
        if gen is None:
            return False
        sig = inspect.signature(gen)
        if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
            return True
        return set(params) <= set(sig.parameters)

    def _device_step_fn(self, params: dict):
        """The network's ``stepwise_step_fn(params)``, or None."""
        get = getattr(self.network, "stepwise_step_fn", None)
        if get is None:
            return None
        try:
            return get(params)
        except Exception:
            return None

    def _stepwise(self, batch, prompt_idx, params):
        """The reference-semantics loop: at each step t not yet written, the
        last ``rf`` steps of every buffer go to ``generate_step`` (or to the
        net's ``stepwise_step_fn``), and each output of width w is written
        at t .. t + w - 1 (the last write truncated at the buffer's end).  The
        buffers stay on the net's device."""
        net = self.network
        dev = net.device
        net.before_generate(batch, prompt_idx)
        step_fn = self._device_step_fn(params)
        rf, prior_t, n_steps = net.rf, np.shape(batch[0])[1], self.n_steps
        tensors = [torch.as_tensor(_fill(x, prior_t, n_steps)).to(dev) for x in batch]
        until = 0
        with torch.no_grad():
            for t in generate_tqdm(range(prior_t, prior_t + n_steps)):
                if t < until:
                    continue
                inputs = tuple(tensor[:, t - rf : t] for tensor in tensors)
                if step_fn is not None:
                    gen = torch.Generator(device=dev).manual_seed(net.next_seed())
                    outputs = step_fn(inputs, gen)
                else:
                    outputs = net.generate_step(inputs, t=t, **params)
                if not isinstance(outputs, tuple):
                    outputs = (outputs,)
                for tensor, out in zip(tensors, outputs):
                    if out is not None:
                        out = torch.as_tensor(out).to(dev)
                        if out.ndim < tensor[:, :1].ndim:
                            out = out[:, None]
                        n_out = min(out.shape[1], tensor.shape[1] - t)
                        tensor[:, t : t + n_out] = out[:, :n_out].to(tensor.dtype)
                        until = t + n_out
        final_outputs = tuple(tensor.cpu().numpy() for tensor in tensors)
        net.after_generate(final_outputs, prompt_idx)
        return final_outputs

    def process_outputs(self, final_outputs, prompt_idx, **template_vars):
        """The targets' inverse transforms of the outputs (mu-law tokens to
        audio), each example written and shown by the logger as the config
        asks; returns those, or the raw outputs (``yield_inversed_outputs``
        False)."""
        if (self.logger is None
                or (not self.config.write_waveform and not self.config.display_waveform)) \
                and not self.config.yield_inversed_outputs:
            return final_outputs
        features = self.network.config.io_spec.targets
        outputs = tuple(feature.inv.apply_to_outputs(out, self.network.device)
                        for feature, out in zip(features, final_outputs))
        for output in outputs:
            for example, idx in zip(output, prompt_idx):
                if self.config.write_waveform:
                    self.logger.write(example, prompt_idx=int(idx), **template_vars)
                if self.config.display_waveform:
                    self.logger.display(example, prompt_idx=int(idx), **template_vars)
        return outputs if self.config.yield_inversed_outputs else final_outputs


class EncodeDecodeLoop(GenerateLoopV2):
    """Reconstruction loop for autoencoders: steps ``range(rf, prior_t, rf)``
    re-encoding the prompt in place (``mimikit_tpu/loops/generate.py:
    427-494``)."""

    @dtc.dataclass
    class Config(Config):
        prompts_length_sec: float = 1.0
        prompts_position_sec: Tuple[Optional[float], ...] = (None,)
        parameters: Optional[Dict[str, Any]] = None
        batch_size: int = 1
        downsampling: int = 1

        output_name_template: Optional[str] = None
        display_waveform: bool = True
        write_waveform: bool = False
        yield_inversed_outputs: bool = True
        callback: Optional[Callable] = None

    @classmethod
    def from_config(cls, config, dataset, network):
        dataloader = cls.get_dataloader(config, dataset, network)
        logger = AudioLogger(
            sr=network.config.io_spec.sr,
            file_template=config.output_name_template if config.write_waveform else None,
            title_template=config.output_name_template if config.display_waveform else None,
        )
        return cls(config, network, 0, dataloader, logger)

    def run(self):
        self.setup()
        net = self.network
        dev = net.device
        for batch in self.dataloader:
            prompt_idx, batch = batch[0], batch[1:]
            prompt_idx = np.asarray(prompt_idx).reshape(-1)
            params = self._gather_params()
            net.before_generate(batch, prompt_idx)
            rf, prior_t = net.rf, np.shape(batch[0])[1]
            # rf == 0 (TiedAE has no receptive field): the whole prompt in one pass
            rf = rf if rf and rf > 0 else prior_t
            tensors = [torch.as_tensor(np.array(x)).to(dev) for x in batch]
            until = 0
            with torch.no_grad():
                for t in generate_tqdm(range(rf, prior_t + (rf == prior_t), rf)):
                    if t < until:
                        continue
                    inputs = tuple(tensor[:, t - rf : t] for tensor in tensors)
                    outputs = net.generate_step(inputs, t=t, **params)
                    if not isinstance(outputs, tuple):
                        outputs = (outputs,)
                    for tensor, out in zip(tensors, outputs):
                        if out is not None:
                            out = torch.as_tensor(out).to(dev)
                            n_out = min(out.shape[1], tensor.shape[1] - t)
                            tensor[:, t - n_out : t] = out[:, :n_out].to(tensor.dtype)
                            until = t + n_out
            final_outputs = tuple(tensor.cpu().numpy() for tensor in tensors)
            net.after_generate(final_outputs, prompt_idx)
            outputs = self.process_outputs(final_outputs, prompt_idx, **self.template_vars)
            yield outputs
            if self.config.callback is not None:
                self.config.callback(outputs)
        self.teardown()
