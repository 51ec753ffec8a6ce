"""On-device batch serving: gather training windows on the card.

Counterpart of ``mimikit_tpu/loops/device_loader.py:50-201``.  Each feature
array goes to the network's device once; a batch is a gather of windows by
plain tensor indexing plus the transform's ``torch_func`` (mu-law and
friends), so the steady state moves only the (B,) start indices.  Index
selection (shuffling, TBPTT chunk walking, jitter) stays on the host, in the
same order and with the same RNG draws as the host ``DataLoader``, so the
batches are the host loader's.  A window's start is clamped so the window
fits the array, as ``jax.lax.dynamic_slice`` clamps it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.batch import AsSlice, Input, process_batch
from ..data.samplers import TBPTTSampler
from ..features.functionals import Functional
from ..features.item_spec import ItemSpec

__all__ = ["DeviceBatcher", "supports_device_batching", "make_train_loader"]


def _leaves(batch) -> list:
    leaves = []
    process_batch(batch, lambda x: isinstance(x, Input), lambda x: leaves.append(x) or x)
    return leaves


def supports_device_batching(batch) -> bool:
    """True when every Input leaf is an AsSlice read whose transform has a
    torch path."""
    for leaf in _leaves(batch):
        if leaf.data is None or not isinstance(leaf.getter, AsSlice):
            return False
        t = leaf.transform
        if t is not None and type(t).torch_func is Functional.torch_func:
            return False
    return True


class DeviceBatcher:
    """Iterable of on-device batches over a nested Input tree."""

    def __init__(self, db, batch, device, batch_size: int = 16, shuffle: bool = True,
                 batch_sampler=None, sampling_jitter: int = 0):
        self.batch = batch
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.batch_sampler = batch_sampler
        self.sampling_jitter = sampling_jitter
        self._rng = np.random.RandomState()  # TrainARMLoop seeds it (data_seed)
        self.leaves = _leaves(batch)
        self._arrays = {}
        for leaf in self.leaves:
            if leaf.data not in self._arrays:
                arr = np.asarray(db.get_array(leaf.data)[:])
                self._arrays[leaf.data] = torch.from_numpy(arr).to(self.device)
        ns = [leaf.getter.n_items(self._arrays[leaf.data].shape[0]) for leaf in self.leaves]
        self.n_items = max(0, min(ns))

    def gather(self, idx: torch.Tensor) -> tuple:
        """(B,) int64 start indices on the device -> one tensor per leaf."""
        outs = []
        for leaf in self.leaves:
            arr = self._arrays[leaf.data]
            g: AsSlice = leaf.getter
            span = g.length * g.downsampling
            start = (idx + g.shift).clamp(0, max(0, arr.shape[0] - span))
            offsets = torch.arange(0, span, g.downsampling, device=self.device)
            win = arr[start[:, None] + offsets]
            if leaf.transform is not None:
                win = leaf.transform.torch_func(win)
            outs.append(win)
        return tuple(outs)

    def _index_batches(self):
        for idx in self._raw_index_batches():
            if self.sampling_jitter:
                j = self._rng.randint(-self.sampling_jitter, self.sampling_jitter + 1, len(idx))
                idx = np.clip(np.asarray(idx, np.int64) + j, 0, max(0, self.n_items - 1))
            yield idx

    def _raw_index_batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        order = np.arange(self.n_items)
        if self.shuffle:
            self._rng.shuffle(order)
        for k in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield order[k : k + self.batch_size]

    def __iter__(self):
        for idx in self._index_batches():
            idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device, non_blocking=True)
            it = iter(self.gather(idx))
            yield process_batch(self.batch, lambda x: isinstance(x, Input), lambda x: next(it))

    def __len__(self):
        if self.batch_sampler is not None and hasattr(self.batch_sampler, "__len__"):
            return len(self.batch_sampler)
        return self.n_items // self.batch_size


def make_train_loader(dataset, net, cfg, on_device: bool = True):
    """The training loader (``TrainARMLoop.get_dataloader``): the device
    batcher when ``on_device`` and every transform has a torch path, else the
    host loader; TBPTT chunks when ``cfg.tbptt_chunk_length`` is set."""
    user_spec = ItemSpec(shift=0, length=cfg.batch_length, stride=cfg.downsampling,
                         unit=net.config.io_spec.unit)
    batch = net.train_batch(user_spec)
    batch_sampler = None
    if cfg.tbptt_chunk_length is not None:
        batch_sampler = TBPTTSampler(
            dataset.signal.shape[0], batch_size=cfg.batch_size,
            chunk_length=cfg.tbptt_chunk_length, seq_len=cfg.batch_length,
            oversampling=cfg.oversampling,
        )
    if on_device and supports_device_batching(batch):
        return DeviceBatcher(
            dataset, batch, net.device, batch_size=cfg.batch_size,
            shuffle=batch_sampler is None, batch_sampler=batch_sampler,
            sampling_jitter=cfg.sampling_jitter,
        )
    if batch_sampler is not None:
        return dataset.serve(batch, batch_sampler=batch_sampler,
                             sampling_jitter=cfg.sampling_jitter)
    return dataset.serve(batch, batch_size=cfg.batch_size, shuffle=True,
                         sampling_jitter=cfg.sampling_jitter)
