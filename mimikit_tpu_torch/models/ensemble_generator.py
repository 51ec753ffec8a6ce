"""Checkpoint-chaining generation: one audio stream, many models.

Counterpart of ``mimikit_tpu/models/ensemble_generator.py``.  An event
stream yields ``Event(generator, seconds, temperature)`` dicts; for each
event the prompt window (the last ``prompt`` length of the output so far)
is resampled on the host from the base rate to the network's
(``Resample``'s numpy path), transformed by the network's input specs,
decoded by a nested :class:`GenerateLoopV2` (on the card the network's
decode kernels: K1/K2 for SampleRNN, K4/K5 for WaveNet), inverse-
transformed, resampled back and written after the window.  A
``temperature`` of None decodes argmax (``parameters == {}``); a number is
every row's temperature.  One departure from the JAX package: the resampled
window is clipped to [-1, 1] before the input transform (``run_event``).
"""
from __future__ import annotations

import dataclasses as dtc
from pprint import pprint
from typing import Generator, Optional, Union

import numpy as np
import torch

from ..checkpoint import Checkpoint
from ..features.functionals import Resample
from ..features.item_spec import Sample, convert
from ..loops.generate import GenerateLoopV2
from .nnn import NearestNextNeighbor

__all__ = ["Event", "EnsembleGenerator", "VotingEnsemble"]


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor comes off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class VotingEnsemble:
    """The weighted sum of several nets' ``generate_step`` outputs."""

    def __init__(self, networks, weights=None):
        self.nets = list(networks)
        N = len(self.nets)
        W = [1 / N] * N if weights is None else list(weights)
        if len(W) != N:
            raise ValueError(f"Expected `weights` to be of length {N} but got {len(W)}")
        s = sum(W)
        self.weights = [w / s for w in W]

    def before_generate(self, prompts, batch_index):
        for net in self.nets:
            net.before_generate(prompts, batch_index)

    def generate_step(self, inputs, *, t: int = 0, **parameters):
        out = None
        for w, net in zip(self.weights, self.nets):
            o = net.generate_step(inputs, t=t, **parameters)
            o = _host(o[0] if isinstance(o, tuple) else o)
            out = o * w if out is None else out + o * w
        return out

    def after_generate(self, final_outputs, batch_index):
        for net in self.nets:
            net.after_generate(final_outputs, batch_index)
        return self


@dtc.dataclass
class Event:
    generator: Union[object, Checkpoint, NearestNextNeighbor]
    seconds: float
    temperature: Optional[float] = None


class EnsembleGenerator:
    """Generate from a prompt (B, n) at ``base_sr`` by chaining the events of
    ``stream`` until ``max_seconds`` of output or the stream's end."""

    def __init__(
        self,
        prompt: np.ndarray,
        max_seconds: float = 10.0,
        base_sr: int = 22050,
        stream: Generator = (),
        print_events: bool = False,
    ):
        self.prompt = _host(prompt)
        self.max_seconds = max_seconds
        self.base_sr = base_sr
        self.stream = iter(stream)
        self.print_events = print_events

    def run(self) -> np.ndarray:
        prompt_length = t = self.prompt.shape[-1]
        n_samples = int(self.max_seconds * self.base_sr)
        output = np.zeros((self.prompt.shape[0], n_samples), dtype=np.float32)
        output[:, :t] = self.prompt
        while t < n_samples:
            prompt = output[:, t - prompt_length : t]
            step_output = self.generate_step(t, prompt)
            if step_output is None:
                break
            n = min(step_output.shape[1], n_samples - t)
            output[:, t : t + n] = step_output[:, :n]
            t += n
        return output

    def generate_step(self, t, inputs):
        if t >= int(self.max_seconds * self.base_sr):
            return None
        try:
            event, net, n_steps, params = self.next_event()
        except StopIteration:
            return None
        if (t / self.base_sr + event.seconds) < self.max_seconds:
            if self.print_events:
                e = dtc.asdict(event)
                e.update({"start": t / self.base_sr})
                pprint(e)
            return self.run_event(inputs, net, n_steps, params)
        return np.zeros((inputs.shape[0], int(self.max_seconds * self.base_sr - t)), np.float32)

    def run_event(self, inputs: np.ndarray, net, n_steps: int, params: dict):
        """One event: the window resampled to the net's rate and transformed
        on the host, decoded through ``GenerateLoopV2`` (which hands the host
        prompts to the net's device), the outputs back on the host past the
        prompt, resampled to the base rate."""
        network_sr = net.config.io_spec.sr
        resample = Resample(self.base_sr, network_sr)
        # a window holding an earlier event's resampled output can pass +-1 (the
        # FIR's overshoot): mu-law then gives a class past q - 1 (or below 0), which
        # the JAX package's embedding reads as NaN and a kernel would read out of
        # bounds, so the window is clipped to [-1, 1]
        inputs_resampled = np.clip(np.stack([resample(x) for x in inputs]), -1.0, 1.0)
        prompt = tuple(
            np.stack([in_spec.transform(x) for x in inputs_resampled])
            for in_spec in net.config.io_spec.inputs
        )
        # an STFT uses fewer input samples than it is given
        n_prompt_samples = convert(prompt[0].shape[1], net.config.io_spec.targets[0].unit,
                                   Sample(sr=network_sr), True)
        cfg = GenerateLoopV2.Config(
            parameters=params,
            display_waveform=False,
            write_waveform=False,
            yield_inversed_outputs=True,
        )
        loop = GenerateLoopV2(cfg, network=net, n_steps=n_steps,
                              dataloader=[[np.ones(1), *prompt]], logger=None)
        for outputs in loop.run():
            inv_resample = Resample(network_sr, self.base_sr)
            return np.stack([inv_resample(x) for x in _host(outputs[0])[:, n_prompt_samples:]])
        return None

    def next_event(self):
        event = Event(**next(self.stream))
        if isinstance(event.generator, Checkpoint):
            net = event.generator.network
        elif isinstance(event.generator, NearestNextNeighbor):
            net = event.generator
        else:
            raise TypeError(f"event generator type '{type(event.generator)}' not supported")
        cfg = GenerateLoopV2.Config(output_duration_sec=event.seconds)
        n_steps = GenerateLoopV2.get_n_steps(cfg, net)
        params = dict(temperature=event.temperature) if event.temperature is not None else {}
        return event, net, n_steps, params
