"""Checkpoint banks: ``<root_dir>/<id>/epoch=N.ckpt``.

Counterpart of ``mimikit_tpu/checkpoint.py``, in the same layout, so each
package reads the other's banks: the network's parameters as the flax tree
under ``network/state_dict/<path>`` (the port maps its state_dict there and
back with the maps of :mod:`.weights`), the network, dataset and training
configs as YAML attrs, and the trainer state.  The optimizer state goes to a
sibling ``epoch=N.opt`` as torch's own ``state_dict`` (``torch.save``).
Files go through :mod:`.data.h5`.  SampleRNN, WaveNet (FreqNet too),
SimpleTransformer, JukeBox, Seq2SeqLSTMNetwork and TiedAE networks are
ported.
"""
from __future__ import annotations

import dataclasses as dtc
import os
from functools import cached_property
from typing import Optional

import numpy as np
import torch
import yaml

from .config import Config
from .data import h5
from .features.dataset import DatasetConfig
from .weights import (
    jukebox_params_to_jax,
    jukebox_state_dict_from_jax,
    samplernn_params_to_jax,
    samplernn_state_dict_from_jax,
    seq2seq_params_to_jax,
    seq2seq_state_dict_from_jax,
    tiedae_params_to_jax,
    tiedae_state_dict_from_jax,
    transformer_params_to_jax,
    transformer_state_dict_from_jax,
    wavenet_params_to_jax,
    wavenet_state_dict_from_jax,
)

__all__ = ["Checkpoint", "CheckpointBank"]


# flax names may contain '/': escape them so the h5 path round trip is exact
def _esc(key: str) -> str:
    return key.replace("%", "%25").replace("/", "%2F")


def _unesc(key: str) -> str:
    return key.replace("%2F", "/").replace("%25", "%")


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{_esc(str(k))}" if prefix else _esc(str(k))
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for path, arr in flat.items():
        parts = [_unesc(p) for p in path.split("/")]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def _weight_maps(network):
    """(state_dict -> flax tree, flax tree -> state_dict) for ``network``."""
    from .networks.s2s_lstm import Seq2SeqLSTMNetwork
    from .networks.sample_rnn import SampleRNN
    from .networks.tied_autoencoder import TiedAE
    from .networks.transformers import JukeBox, SimpleTransformer
    from .networks.wavenet import WaveNet

    if isinstance(network, SampleRNN):
        return samplernn_params_to_jax, samplernn_state_dict_from_jax
    if isinstance(network, Seq2SeqLSTMNetwork):
        return seq2seq_params_to_jax, seq2seq_state_dict_from_jax
    if isinstance(network, TiedAE):
        return tiedae_params_to_jax, tiedae_state_dict_from_jax
    if isinstance(network, WaveNet):
        return wavenet_params_to_jax, wavenet_state_dict_from_jax
    if isinstance(network, SimpleTransformer):
        n_heads = network.config.n_heads
        return (lambda sd: transformer_params_to_jax(sd, n_heads)), transformer_state_dict_from_jax
    if isinstance(network, JukeBox):
        n_heads = network.config.n_heads
        return (lambda sd: jukebox_params_to_jax(sd, n_heads)), jukebox_state_dict_from_jax
    raise NotImplementedError(f"checkpoints of {type(network).__name__} are not ported")


class CheckpointBank:
    """Writer of one ``epoch=N.ckpt`` file."""

    @classmethod
    def save(cls, filename: str, network, training_config=None, optimizer_state=None,
             trainer_state: Optional[dict] = None) -> str:
        to_jax, _ = _weight_maps(network)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        with h5.File(filename, "w") as f:
            f.create_group("network").attrs["config"] = network.config.serialize()
            sd = f.create_group("network/state_dict")
            for path, arr in _flatten(to_jax(network.state_dict())).items():
                sd.create_dataset(path, data=arr)
            if training_config is not None:
                f.attrs["dataset"] = training_config.dataset.serialize()
                f.attrs["training"] = training_config.training.serialize()
            else:
                # a minimal dataset config keeps the network alone loadable
                specs = [*network.config.io_spec.inputs, *network.config.io_spec.targets]
                schema = {s.extractor_name: s.extractor for s in specs}
                f.attrs["dataset"] = DatasetConfig(
                    filename="unknown", sources=(), extractors=tuple(schema.values())
                ).serialize()
            if trainer_state is not None:
                f.attrs["trainer_state"] = yaml.safe_dump(trainer_state)
        if optimizer_state is not None:
            torch.save(optimizer_state, os.path.splitext(filename)[0] + ".opt")
        return filename


@dtc.dataclass
class Checkpoint:
    """One bank entry; ``device`` is where :attr:`network` is built (default:
    the card)."""

    id: str
    epoch: int
    root_dir: str = "./"
    device: Optional[str] = None

    def create(self, network, training_config=None, optimizer_state=None,
               trainer_state: Optional[dict] = None):
        CheckpointBank.save(self.os_path, network, training_config, optimizer_state,
                            trainer_state)
        return self

    @staticmethod
    def get_id_and_epoch(path):
        id_, epoch = path.split("/")[-2:]
        return id_.strip("/"), int(epoch.split(".ckpt")[0].split("=")[-1])

    @staticmethod
    def from_path(path, device=None):
        basename = os.path.dirname(os.path.dirname(path))
        return Checkpoint(*Checkpoint.get_id_and_epoch(path), root_dir=basename, device=device)

    @property
    def os_path(self):
        return os.path.join(self.root_dir, f"{self.id}/epoch={self.epoch}.ckpt")

    def delete(self):
        os.remove(self.os_path)

    def _attr(self, key, group=None):
        with h5.File(self.os_path, "r") as f:
            node = f[group] if group else f
            return node.attrs.get(key, None)

    @cached_property
    def dataset_config(self) -> DatasetConfig:
        return Config.deserialize(self._attr("dataset"), as_type=DatasetConfig)

    @cached_property
    def network_config(self):
        return Config.deserialize(self._attr("config", "network"))

    @cached_property
    def training_config(self):
        return Config.deserialize(self._attr("training"))

    @cached_property
    def state_dict(self) -> dict:
        """The stored flax parameter tree (nested dicts of numpy arrays)."""
        flat = {}
        with h5.File(self.os_path, "r") as f:
            def visit(name, obj):
                if h5.is_dataset(obj):
                    flat[name] = np.asarray(obj[()])

            f["network/state_dict"].visititems(visit)
        return _unflatten(flat)

    @cached_property
    def network(self):
        cfg = self.network_config
        cfg.io_spec.bind_to(self.dataset_config)
        net = cfg.owner_class.from_config(cfg, device=self.device)
        _, from_jax = _weight_maps(net)
        net.load_state_dict(from_jax(self.state_dict), strict=True)
        return net

    @cached_property
    def dataset(self):
        ds: DatasetConfig = self.dataset_config
        if os.path.exists(ds.filename):
            return ds.get(mode="r")
        return ds.create(mode="w")

    @cached_property
    def optimizer_state(self):
        opt_path = os.path.join(self.root_dir, f"{self.id}/epoch={self.epoch}.opt")
        if os.path.isfile(opt_path):
            return torch.load(opt_path, weights_only=True)
        return None

    @cached_property
    def trainer_state(self):
        raw = self._attr("trainer_state")
        return yaml.safe_load(raw) if raw is not None else None
