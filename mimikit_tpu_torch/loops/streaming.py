"""Unbounded streaming generation in bounded-latency chunks.

Counterpart of ``mimikit_tpu/loops/streaming.py`` for networks with an exact
state-carrying ``stream`` (SampleRNN):

* ``stream_tokens(net, prompts, chunk_steps)`` yields ``(B, chunk_steps)``
  host token arrays forever (the caller breaks out);
* ``stream_audio(...)`` applies the IOSpec target's inverse transform
  (``MuLawExpand``) to every chunk, yielding float audio.

Read-behind pipeline: on the card each chunk's device-to-host copy is
enqueued on a side CUDA stream into pinned memory (``non_blocking``) as soon
as the chunk's kernel is launched, and the host reads a chunk only after the
NEXT chunk's kernel has been launched — so the copy and the host-side
conversion overlap the next chunk's device work.  Tokens are unchanged; only
the read moves one chunk behind.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["stream_tokens", "stream_audio"]


def _to_host_async(x: torch.Tensor, copy_stream):
    """Enqueue ``x``'s copy to pinned host memory on ``copy_stream`` after the
    work already queued on the current stream; return (host tensor, event
    marking the copy's completion)."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    ready = torch.cuda.current_stream(x.device).record_event()
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(ready)
        host.copy_(x, non_blocking=True)
        x.record_stream(copy_stream)
        done = copy_stream.record_event()
    return host, done


def _read_behind_chunks(dev_chunks, chunk_steps: int) -> Iterator[np.ndarray]:
    """Shared tail for the state-carrying streams.

    ``dev_chunks`` yields ``(out, drop)`` pairs where advancing the generator
    launches the next chunk (``out`` is a (B, C) tensor, possibly still being
    computed on the card) and ``drop`` counts prompt warm-up columns to
    discard.  Re-chunks the read columns into exact ``(B, chunk_steps)``
    yields, one chunk behind the launch front."""
    buf = None
    copy_stream = None

    def emit(host: np.ndarray, drop: int):
        nonlocal buf
        new = host[:, drop:]
        buf = new if buf is None else np.concatenate([buf, new], axis=1)
        while buf.shape[1] >= chunk_steps:
            out, buf = buf[:, :chunk_steps], buf[:, chunk_steps:]
            yield out

    pending = None
    for out, drop in dev_chunks:
        if out.is_cuda:
            if copy_stream is None:
                copy_stream = torch.cuda.Stream(out.device)
            entry = (*_to_host_async(out, copy_stream), drop)
        else:
            entry = (out, None, drop)
        if pending is not None:
            host, done, d = pending
            if done is not None:
                done.synchronize()
            yield from emit(host.numpy(), d)
        pending = entry


def stream_tokens(net, prompts: Tuple, chunk_steps: int, temperature=None,
                  seed=None) -> Iterator[np.ndarray]:
    """Yield ``(B, chunk_steps)`` generated tokens forever, continuing exactly
    across chunks (``net.stream``)."""
    yield from net.stream(prompts, chunk_steps, temperature=temperature, seed=seed)


def stream_audio(net, prompts: Tuple, chunk_steps: int, temperature=None,
                 seed=None, inv=None) -> Iterator[np.ndarray]:
    """Like :func:`stream_tokens` but each chunk is inverse-transformed to
    float audio (host numpy) with the IOSpec target's ``inv`` — MuLawExpand
    for the mu-law models."""
    if inv is None:
        inv = net.config.io_spec.targets[0].inv
    for chunk in stream_tokens(net, prompts, chunk_steps, temperature=temperature, seed=seed):
        yield np.asarray(inv(chunk))
