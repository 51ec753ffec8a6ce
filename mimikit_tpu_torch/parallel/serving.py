"""Any network's decode batch sharded across devices, with no collectives.

Counterpart of ``mimikit_tpu/parallel/serving.py``.  Every decoder of the
zoo is row-independent (streams never interact), so serving on several
devices needs no communication: a copy of the net on each device, one slice
of the batch each, the slices' decodes launched back to back so the devices
run at once, and the host gathering the slices' rows.  It works with any
net's ``generate`` and ``stream`` (each copy takes its own kernel route for
its slice's B), because it composes at the call boundary.

Argmax rows equal the unsharded call's rows; sampled slices draw from their
own seed each (one ``torch.Generator`` a slice), so their noise differs from
the unsharded call's.  With fewer than two devices, or a batch the devices
do not divide, the call decodes unsharded on the net's device and warns why.
"""
from __future__ import annotations

import copy
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sharded_generate", "sharded_stream_tokens"]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    """``devices`` as torch devices, a CUDA device without an index as the
    current one; by default every CUDA device."""
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def _unsharded_reason(B: int, devices: List[torch.device]) -> Optional[str]:
    if len(devices) < 2:
        return f"{len(devices)} device(s) given, sharding needs at least 2"
    if B % len(devices):
        return f"B={B} streams do not divide over {len(devices)} devices"
    return None


def _device_copies(net, devices: List[torch.device]) -> dict:
    """A copy of ``net`` on each device (the net itself on its own device),
    cached on the net against its parameters as they stand: the cache holds
    the parameter objects and their in-place version counters, so a training
    step, a loaded state_dict or a replaced parameter makes new copies."""
    params = list(net.parameters())
    stamp = [p._version for p in params]
    cache = getattr(net, "_copies_by_device", None)
    if (cache is None or len(cache[0]) != len(params)
            or any(a is not b for a, b in zip(cache[0], params)) or cache[1] != stamp):
        cache = (params, stamp, {})
        net._copies_by_device = cache
    copies = cache[2]
    for dev in devices:
        if dev not in copies:
            if dev == net.device:
                copies[dev] = net
            else:
                del net._copies_by_device  # not copied into the twin
                try:
                    copies[dev] = copy.deepcopy(net).to(dev)
                finally:
                    net._copies_by_device = cache
    return copies


def _slice_temperature(temperature, i: int, sl: int, B: int):
    """The slice's temperature: one value as it is, one a stream sliced."""
    if temperature is None or np.ndim(temperature) == 0:
        return temperature
    t = temperature.detach().cpu() if isinstance(temperature, torch.Tensor) else np.asarray(
        temperature)
    if len(t) != B:
        raise ValueError(f"{len(t)} temperatures for {B} streams")
    return t[i * sl : (i + 1) * sl]


def _slice_seeds(net, seed: Optional[int], n: int) -> List[int]:
    """One seed a slice, drawn from a generator seeded with ``seed``
    (default: the net's next seed)."""
    g = torch.Generator().manual_seed(net.next_seed() if seed is None else seed)
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=g)) for _ in range(n)]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sharded_generate(net, prompts: Tuple, n_steps: int, temperature=None,
                     seed: Optional[int] = None, devices=None) -> Tuple[np.ndarray, ...]:
    """Decode ``prompts`` with the stream batch sharded across ``devices``
    (default: every CUDA device), an equal slice each; returns the same
    tuple of (B, prior_t + n_steps) buffers as ``net.generate``, on the
    host.  The slices' decodes are launched back to back and read after the
    last launch."""
    devices = _devices(devices)
    B = np.shape(prompts[0])[0]
    why = _unsharded_reason(B, devices)
    if why is not None:
        warnings.warn(f"sharded_generate decodes unsharded: {why}", stacklevel=2)
        return tuple(_host(o) for o in net.generate(prompts, n_steps, temperature=temperature,
                                                    seed=seed))
    n = len(devices)
    sl = B // n
    copies = _device_copies(net, devices)
    outs = []
    for i, (dev, s) in enumerate(zip(devices, _slice_seeds(net, seed, n))):
        part = tuple(torch.as_tensor(np.asarray(p)[i * sl : (i + 1) * sl]).to(dev)
                     for p in prompts)
        outs.append(copies[dev].generate(part, n_steps,
                                         temperature=_slice_temperature(temperature, i, sl, B),
                                         seed=s))
    return tuple(np.concatenate([_host(o[v]) for o in outs], axis=0)
                 for v in range(len(outs[0])))


def sharded_stream_tokens(net, prompts: Tuple, chunk_steps: int, temperature=None,
                          seed: Optional[int] = None, devices=None) -> Iterator[np.ndarray]:
    """``stream_tokens`` with the stream batch sharded across ``devices``
    (default: every CUDA device): each device streams its slice on its copy
    of the net (the net's state-carrying stream, or the window re-feed), and
    each yield is the slices' ``(B, chunk_steps)`` chunks stacked, forever.
    Each slice's stream reads one chunk behind its launches
    (``loops/streaming.py``), so while the host reads one slice the other
    devices compute."""
    from ..loops.streaming import stream_tokens

    devices = _devices(devices)
    B = np.shape(prompts[0])[0]
    why = _unsharded_reason(B, devices)
    if why is not None:
        warnings.warn(f"sharded_stream_tokens streams unsharded: {why}", stacklevel=2)
        yield from stream_tokens(net, prompts, chunk_steps, temperature=temperature, seed=seed)
        return
    n = len(devices)
    sl = B // n
    copies = _device_copies(net, devices)
    streams = [
        stream_tokens(copies[dev],
                      tuple(torch.as_tensor(np.asarray(p)[i * sl : (i + 1) * sl]).to(dev)
                            for p in prompts),
                      chunk_steps, temperature=_slice_temperature(temperature, i, sl, B), seed=s)
        for i, (dev, s) in enumerate(zip(devices, _slice_seeds(net, seed, n)))
    ]
    try:
        while True:
            yield np.concatenate([next(s) for s in streams], axis=0)
    finally:
        for s in streams:
            s.close()
