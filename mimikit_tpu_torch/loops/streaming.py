"""Unbounded streaming generation in bounded-latency chunks.

Counterpart of ``mimikit_tpu/loops/streaming.py``:

* ``stream_tokens(net, prompts, chunk_steps)`` yields ``(B, chunk_steps)``
  host token arrays forever (the caller breaks out): through ``net.stream``
  where the network has one (SampleRNN and WaveNet carry their decode state
  across chunks exactly), else by re-feeding the last ``_window_len()``
  samples (``rf + 1`` for a net without one) as the next prompt
  (:func:`_refeed_stream`: exact for nets whose decode state is that
  window);
* ``stream_audio(...)`` applies the IOSpec target's inverse transform
  (``MuLawExpand``) to every chunk, yielding float audio.

Read-behind pipeline: on the card each chunk's device-to-host copy is
enqueued on a side CUDA stream into pinned memory (``non_blocking``) as soon
as the chunk's kernel is launched, and the host reads a chunk only after the
NEXT chunk's kernel has been launched — so the copy and the host-side
conversion overlap the next chunk's device work.  Tokens are unchanged; only
the read moves one chunk behind.  ``MMK_STREAM_PIPELINE=0`` opts out (as in
the JAX package, ``mimikit_tpu/loops/streaming.py:35``): each chunk is read
as soon as it is launched, with a plain synchronous copy, and the chunks are
the same.
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["stream_tokens", "stream_audio"]


def _pipeline_on() -> bool:
    """False under ``MMK_STREAM_PIPELINE=0``."""
    return os.environ.get("MMK_STREAM_PIPELINE", "1") != "0"


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
    yields, one chunk behind the launch front (under ``MMK_STREAM_PIPELINE=0``
    at it: each chunk copied and read before the next is launched)."""
    buf = None
    copy_stream = None
    pipelined = _pipeline_on()

    def emit(host: np.ndarray, drop: int):
        nonlocal buf
        new = host[:, drop:]
        buf = new if buf is None else np.concatenate([buf, new], axis=1)
        while buf.shape[1] >= chunk_steps:
            out, buf = buf[:, :chunk_steps], buf[:, chunk_steps:]
            yield out

    pending = None
    for out, drop in dev_chunks:
        if not pipelined:
            yield from emit(out.cpu().numpy(), drop)
            continue
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


def _refeed_stream(net, prompt, chunk_steps: int, temperature, seed,
                   generate=None) -> Iterator[np.ndarray]:
    """Stream by re-feeding (``mimikit_tpu/loops/streaming.py:50-105``): each
    chunk is one ``net.generate`` call (or ``generate``, its stand-in with
    the same arguments: SimpleTransformer's holds a weight pack built once a
    stream) whose prompt is the last samples so far, with a seed drawn per
    chunk from ``seed``; read one chunk behind.
    The prompt spans what the net's decode conditions on: ``_window_len()``
    where the net has one (JukeBox rounds rf up to a multiple of its top
    frame; re-feeding only rf + 1 would zero-pad that history and part from
    one long decode), else ``rf + 1``."""
    if not callable(getattr(net, "generate", None)):
        raise TypeError(
            f"{type(net).__name__} has no batch `generate` — streaming needs one"
            " (autoencoder models run under EncodeDecodeLoop instead)"
        )
    # block-AR nets are exact only when chunk boundaries fall on block ones
    hop = getattr(getattr(net, "config", None), "hop", None)
    if hop and hop > 1 and chunk_steps % hop:
        raise ValueError(
            f"{type(net).__name__} decodes in blocks of hop={hop}: chunk_steps={chunk_steps}"
            " must be a multiple of hop for the stream to match one long decode (round"
            f" chunk_steps up to {-(-chunk_steps // hop) * hop})"
        )
    if callable(getattr(net, "_window_len", None)):
        window = int(net._window_len())
    else:
        window = int(net.rf) + 1
    seeds = torch.Generator().manual_seed(0 if seed is None else seed)
    if generate is None:
        generate = net.generate

    def dev_chunks():
        buf = torch.as_tensor(prompt)
        while True:
            sub = int(torch.randint(0, 2**31 - 1, (1,), generator=seeds))
            out = generate((buf,), chunk_steps, temperature=temperature, seed=sub)[0]
            new, buf = out[:, buf.shape[1]:].contiguous(), out[:, -window:]
            yield new, 0

    yield from _read_behind_chunks(dev_chunks(), chunk_steps)


def stream_tokens(net, prompts: Tuple, chunk_steps: int, temperature=None,
                  seed=None) -> Iterator[np.ndarray]:
    """Yield ``(B, chunk_steps)`` generated tokens forever: ``net.stream``
    where the network has one, else :func:`_refeed_stream`."""
    if hasattr(net, "stream"):
        yield from net.stream(prompts, chunk_steps, temperature=temperature, seed=seed)
        return
    yield from _refeed_stream(net, prompts[0], chunk_steps, temperature, seed)


def stream_audio(net, prompts: Tuple, chunk_steps: int, temperature=None,
                 seed=None, inv=None) -> Iterator[np.ndarray]:
    """Like :func:`stream_tokens` but each chunk is inverse-transformed to
    float audio (host numpy) with the IOSpec target's ``inv`` — MuLawExpand
    for the mu-law models."""
    if inv is None:
        inv = net.config.io_spec.targets[0].inv
    for chunk in stream_tokens(net, prompts, chunk_steps, temperature=temperature, seed=seed):
        yield np.asarray(inv(chunk))
