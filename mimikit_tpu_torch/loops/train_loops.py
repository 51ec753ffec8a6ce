"""Training loop: TBPTT steps, Adam on the one-cycle schedule, checkpoints,
monitoring.

Counterpart of ``mimikit_tpu/loops/train_loops.py``.  One step is the
network's train forward, the loss, the backward (through the fused LSTM
kernels on the card) and an optimizer update (``optim.TrainOptimizer``).
The RNN carry persists across contiguous batches and is detached between
steps: TBPTT never back-propagates across windows
(``train_loops.py:410-435``).  It resets at the start of every epoch, at
every TBPTT chunk boundary and when the batch size changes, as the JAX
package's default (device-batched) route does.  The JAX loop's
K-steps-in-one-dispatch ``lax.scan`` is a dispatch trick of its TPU; here
the steps are a plain Python loop.

``trainer_kwargs`` keys the port runs: ``device_batching`` (default True),
``data_seed``, ``gradient_clip_val``, ``accumulate_grad_batches``,
``nan_check_every``, and

* ``param_dtype`` (``"bfloat16"``, ``"float16"``, ``"float32"``): the mixed-
  precision policy of ``mimikit_tpu/loops/train_loops.py:394-408``.  The
  master parameters and the optimizer state stay f32; each step casts the
  parameters, the float inputs and the carry to the policy's dtype
  (``precision.cast_parameters``, ``torch.func.functional_call``), runs the
  forward inside ``precision.compute``, casts the outputs and the new carry
  to f32, takes the loss in f32 and steps the f32 masters with the
  gradients that come back through the casts.  SampleRNN's LSTM tiers then
  run the bf16-stream LSTM kernels;
* ``matmul_precision``: JAX's matmul precision names mapped to
  ``torch.set_float32_matmul_precision`` for each step (``"float32"`` /
  ``"highest"``: full f32; ``"tensorfloat32"`` / ``"high"`` /
  ``"bfloat16_3x"``: TF32; ``"bfloat16"`` / ``"default"`` / ``"fastest"``:
  ``"medium"``), the previous value restored after the step;
* ``steps_per_dispatch`` and ``flat_optimizer``: accepted and ignored.  They
  group TPU dispatches and lay out the optimizer state for XLA
  (``train_loops.py:568,788``); the port's loop runs one step a call;
* ``remat``: the train forward under ``torch.utils.checkpoint.checkpoint``
  (non-reentrant), its activations recomputed in the backward
  (``train_loops.py:352-391``).  ``True`` recomputes everything; a JAX policy
  name maps to its PyTorch counterpart (``REMAT_POLICIES``), another name
  raises ``NotImplementedError``; a callable is a selective-checkpoint policy
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``); any
  other value raises ``TypeError``.  On the card the LSTM forward kernel then
  runs twice a step;
* ``loss_logs_file``: each epoch's averages written to ``<run dir>/<path>``
  by ``LossLogger``.

Every other key raises ``NotImplementedError`` naming it (``data_parallel``,
``n_model``, ``fsdp``, ...).  ``MONITOR_TRAINING`` and ``OUTPUT_TRAINING``
add a ``GenerateCallback``: every ``every_n_epochs`` epochs,
``GenerateLoopV2`` decodes ``n_examples`` prompts of the dataset at
``temperature`` (one value, or one an example), shows them
(``MONITOR_TRAINING``) and writes them to ``outputs/epoch{e}_prm{i}.wav``
(``OUTPUT_TRAINING``); a net that is not an ``ARM`` (``TiedAE``) is
monitored by ``EncodeDecodeLoop``'s reconstructions instead.  A net whose
forward returns ``(y, indp)`` with no carry (``TiedAE``) trains as the
stateless nets do: the loss zips its outputs with the targets.
"""
from __future__ import annotations

import contextlib
import dataclasses as dtc
import functools
import hashlib
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as torch_checkpoint
from torch.func import functional_call

from .. import precision
from ..config import Config
from ..features.dataset import DatasetConfig
from ..networks.arm import ARM, ARMWithHidden
from ..optim import TrainOptimizer, onecycle_schedule
from .callbacks import GenerateCallback, MMKCheckpoint, tqdm
from .device_loader import make_train_loader
from .generate import EncodeDecodeLoop, GenerateLoopV2
from .logger import EpochMetrics, LossLogger

__all__ = ["TrainARMConfig", "ARMHP", "TrainARMLoop"]

PORTED_TRAINER_KWARGS = frozenset({
    "device_batching", "data_seed", "gradient_clip_val", "accumulate_grad_batches",
    "nan_check_every", "param_dtype", "matmul_precision", "steps_per_dispatch",
    "flat_optimizer", "remat", "loss_logs_file",
})
# JAX's matmul precision names -> torch.set_float32_matmul_precision's
MATMUL_PRECISION = {
    "float32": "highest", "highest": "highest",
    "tensorfloat32": "high", "high": "high", "bfloat16_3x": "high",
    "bfloat16": "medium", "default": "medium", "fastest": "medium",
}
# jax.checkpoint_policies names -> the ops whose outputs the backward keeps (None:
# none, everything is recomputed); "everything_saveable" recomputes nothing
_DOTS = ("mm", "addmm", "bmm")
REMAT_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
}


@dtc.dataclass
class TrainARMConfig(Config):
    root_dir: str = "./trainings"
    batch_size: int = 16
    batch_length: int = 32
    downsampling: int = 1
    oversampling: int = 1
    sampling_jitter: int = 0
    shift_error: int = 0
    tbptt_chunk_length: Optional[int] = None

    max_epochs: int = 2
    limit_train_batches: Optional[int] = None
    max_lr: float = 5e-4
    betas: Tuple[float, float] = (0.9, 0.93)
    div_factor: float = 3.0
    final_div_factor: float = 1.0
    pct_start: float = 0.0
    cycle_momentum: bool = False

    CHECKPOINT_TRAINING: bool = True
    MONITOR_TRAINING: bool = True
    OUTPUT_TRAINING: str = ""

    save_optimizer: bool = False
    every_n_epochs: int = 2
    n_examples: int = 3
    prompt_length_sec: float = 0.5
    outputs_duration_sec: float = 1.0
    temperature: Optional[Tuple[float, ...]] = None
    trainer_kwargs: Dict = dtc.field(default_factory=dict)


@dtc.dataclass
class ARMHP(Config):
    dataset: DatasetConfig
    network: object  # NetworkConfig (typed via its own tag)
    training: TrainARMConfig


def _check_ported(cfg: TrainARMConfig) -> None:
    for key in cfg.trainer_kwargs:
        if key not in PORTED_TRAINER_KWARGS:
            raise NotImplementedError(f"trainer_kwargs['{key}'] is not ported")
    name = cfg.trainer_kwargs.get("matmul_precision")
    if name is not None and str(name).lower() not in MATMUL_PRECISION:
        raise ValueError(f"unknown matmul_precision {name!r}")
    remat_context(cfg.trainer_kwargs.get("remat", False))


def remat_context(remat):
    """What ``trainer_kwargs["remat"]`` asks of the train forward: None (no
    rematerialisation), or the ``context_fn`` of a non-reentrant
    ``torch.utils.checkpoint.checkpoint`` (``noop_context_fn``: everything
    recomputed).  Raises as the docstring of this module says."""
    if not remat:
        return None
    if isinstance(remat, str):
        if remat not in REMAT_POLICIES:
            raise NotImplementedError(
                f"trainer_kwargs['remat'] policy {remat!r} has no PyTorch counterpart in the"
                f" port (ported: {sorted(REMAT_POLICIES)})")
        saved = REMAT_POLICIES[remat]
        if saved == "all":
            return None
        if saved is None:
            return torch_checkpoint.noop_context_fn
        ops = [getattr(torch.ops.aten, op).default for op in saved]
        return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, ops)
    if remat is True:
        return torch_checkpoint.noop_context_fn
    if callable(remat):
        return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, remat)
    raise TypeError("trainer_kwargs['remat'] must be True, a jax.checkpoint_policies member"
                    f" name, or a selective-checkpoint policy callable — got {remat!r}")


@contextlib.contextmanager
def matmul_precision(name: Optional[str]):
    """``torch.set_float32_matmul_precision`` for JAX's precision ``name``
    inside the block (nothing for None), the previous value restored."""
    if name is None:
        yield
        return
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISION[str(name).lower()])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _detach(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return type(tree)(_detach(x) for x in tree)


class TrainARMLoop:
    """Owns the loader, the optimizer, the step, the callbacks and the run
    directory ``<root_dir>/<hash of the hp YAML>``."""

    @classmethod
    def get_os_paths(cls, cfg: ARMHP) -> Tuple[str, str, str]:
        hash_ = hashlib.sha256(cfg.serialize().encode("utf-8")).hexdigest()[:8]
        root_dir = os.path.join(cfg.training.root_dir, hash_)
        output_dir = os.path.join(root_dir, "outputs")
        return root_dir, hash_, os.path.join(output_dir, "epoch{epoch}_prm{prompt_idx}.wav")

    @classmethod
    def get_dataloader(cls, dataset, net, cfg: TrainARMConfig):
        """The device batcher by default (``trainer_kwargs["device_batching"]``
        False: the host loader); either way seeded by ``data_seed``."""
        on_device = cfg.trainer_kwargs.get("device_batching", True)
        return cls._apply_data_seed(make_train_loader(dataset, net, cfg, on_device), cfg)

    @staticmethod
    def _apply_data_seed(loader, cfg: TrainARMConfig):
        """``trainer_kwargs={"data_seed": N}`` seeds the loader's and its
        samplers' RNGs (``train_loops.py:138-169``): the same seed draws the
        same batches as the JAX package."""
        seed = cfg.trainer_kwargs.get("data_seed")
        if seed is not None:
            seeded = False
            for obj in (loader, getattr(loader, "batch_sampler", None),
                        getattr(loader, "sampler", None)):
                if obj is not None and hasattr(obj, "_rng"):
                    obj._rng = np.random.RandomState(int(seed))
                    seeded = True
            if not seeded:
                warnings.warn("data_seed was set but the loader exposes no seedable sampler"
                              " RNG: batch order will NOT be reproducible", stacklevel=3)
        return loader

    @classmethod
    def get_optimizer(cls, net, dl, cfg: TrainARMConfig) -> TrainOptimizer:
        steps_per_epoch = (
            min(len(dl), cfg.limit_train_batches)
            if cfg.limit_train_batches is not None else len(dl)
        )
        accumulate = int(cfg.trainer_kwargs.get("accumulate_grad_batches", 1))
        # the schedule ticks once per optimizer update, not per micro-batch
        total_steps = max(2, steps_per_epoch * cfg.max_epochs // accumulate)
        # a zero-length warm-up divides by zero in optax's schedule: floor it
        # at one step (train_loops.py:181-184)
        pct_start = max(cfg.pct_start, 1.0 / total_steps + 1e-9)
        schedule = onecycle_schedule(total_steps, cfg.max_lr, pct_start, cfg.div_factor,
                                     cfg.final_div_factor)
        return TrainOptimizer(net.parameters(), schedule, cfg.betas,
                              clip=cfg.trainer_kwargs.get("gradient_clip_val"),
                              accumulate=accumulate)

    @classmethod
    def from_config(cls, train_cfg: TrainARMConfig, dataset, network, opt=None):
        _check_ported(train_cfg)
        loader = cls.get_dataloader(dataset, network, train_cfg)
        ds_cfg = (
            dataset.config if getattr(dataset, "config", None) is not None
            else DatasetConfig(filename=dataset.filename, sources=tuple(dataset.index))
        )
        hp = ARMHP(training=train_cfg, network=network.config, dataset=ds_cfg)
        return cls(hp, dataset, loader, network, network.config.io_spec.loss_fn, opt)

    @classmethod
    def from_checkpoint(cls, checkpoint) -> "TrainARMLoop":
        dataset, network = checkpoint.dataset, checkpoint.network
        train_cfg = checkpoint.training_config
        _check_ported(train_cfg)
        loader = cls.get_dataloader(dataset, network, train_cfg)
        loop = cls(
            ARMHP(training=train_cfg, network=network.config, dataset=checkpoint.dataset_config),
            dataset, loader, network, network.config.io_spec.loss_fn,
        )
        loop._restored_opt_state = checkpoint.optimizer_state
        ts = checkpoint.trainer_state
        if ts is not None:
            loop.start_epoch = int(ts["fit_loop"]["epoch"])
            loop.global_step = int(ts["fit_loop"].get("global_step", 0))
        return loop

    def __init__(self, hp: ARMHP, dataset, loader, net, loss_fn, opt=None):
        self._config = hp
        self.train_cfg = hp.training
        _check_ported(self.train_cfg)
        self.root_dir, self.hash_, self.output_template = self.get_os_paths(hp)
        self.dataset = dataset
        self.loader = loader
        self.loss_fn = loss_fn
        self.net = net
        self._carries_hidden = isinstance(net, ARMWithHidden)
        self.half = precision.resolve_dtype(self.train_cfg.trainer_kwargs.get("param_dtype"))
        self.remat = remat_context(self.train_cfg.trainer_kwargs.get("remat", False))
        self.tbptt_len = self.train_cfg.tbptt_chunk_length
        if self.tbptt_len is not None:
            self.tbptt_len //= self.train_cfg.batch_length
        self.opt = opt
        self.global_step = 0
        self.start_epoch = 0
        self.metrics = EpochMetrics()
        self._restored_opt_state = None
        self.callbacks = self.get_callbacks(net, dataset, self.root_dir, self.output_template,
                                            self.train_cfg)

    @property
    def config(self) -> ARMHP:
        return self._config

    @classmethod
    def get_callbacks(cls, net, dataset, root_dir, filename_template, cfg: TrainARMConfig):
        """``MMKCheckpoint`` (``CHECKPOINT_TRAINING``), then a
        ``GenerateCallback`` (``MONITOR_TRAINING`` or ``OUTPUT_TRAINING``) over
        ``GenerateLoopV2`` for an ``ARM``, over ``EncodeDecodeLoop`` for any
        other net (an autoencoder: its prompts as long as the larger of
        ``prompt_length_sec`` and ``outputs_duration_sec``), as
        ``train_loops.py:281-329``."""
        callbacks = []
        if cfg.CHECKPOINT_TRAINING:
            callbacks.append(MMKCheckpoint(epochs=cfg.every_n_epochs, root_dir=root_dir))
        if cfg.MONITOR_TRAINING or cfg.OUTPUT_TRAINING:
            common = dict(
                prompts_position_sec=(None,) * cfg.n_examples,
                parameters=dict(temperature=cfg.temperature),
                batch_size=cfg.n_examples,
                downsampling=cfg.downsampling,
                output_name_template=filename_template,
                display_waveform=cfg.MONITOR_TRAINING,
                write_waveform=bool(cfg.OUTPUT_TRAINING),
            )
            if isinstance(net, ARM):
                gen_loop = GenerateLoopV2.from_config(
                    GenerateLoopV2.Config(output_duration_sec=cfg.outputs_duration_sec,
                                          prompts_length_sec=cfg.prompt_length_sec, **common),
                    dataset=dataset, network=net)
            else:
                gen_loop = EncodeDecodeLoop.from_config(
                    EncodeDecodeLoop.Config(
                        prompts_length_sec=max(cfg.prompt_length_sec, cfg.outputs_duration_sec),
                        **common),
                    dataset=dataset, network=net)
            callbacks.append(GenerateCallback(generate_loop=gen_loop,
                                              every_n_epochs=cfg.every_n_epochs))
        return callbacks

    def _batches(self):
        """The loader's batches as tensors on the network's device."""
        dev = self.net.device
        for inputs, targets in self.loader:
            yield (tuple(torch.as_tensor(x).to(dev) for x in inputs),
                   tuple(torch.as_tensor(x).to(dev) for x in targets))

    def _apply_train(self, inputs, hidden):
        """The train forward: (outputs, new carry).  A net without a hidden
        carry (not an ``ARMWithHidden``: WaveNet, SimpleTransformer, JukeBox)
        is called without one and carries None, as the JAX loop's uniform
        ``apply_train`` gets None back from them.  Under ``param_dtype`` the
        parameters, float inputs and carry are cast to the policy's dtype,
        the forward runs inside ``precision.compute``, and the outputs and the
        new carry come back in f32 (``train_loops.py:397-408``).  Under
        ``remat`` the forward (the cast parameters' use included) runs inside
        a non-reentrant ``torch.utils.checkpoint.checkpoint``."""
        if self.half is None:
            if self._carries_hidden:
                return self._remat(self.net, inputs, hidden)
            return self._remat(self.net, inputs), None
        params = precision.cast_parameters(self.net, self.half)
        args = (precision.cast_tree(inputs, self.half),)
        if self._carries_hidden:
            args += (precision.cast_tree(hidden, self.half),)

        def forward(*args):
            with precision.compute(self.half):
                return functional_call(self.net, params, args)

        out = self._remat(forward, *args)
        outputs, new_hidden = out if self._carries_hidden else (out, None)
        return (precision.cast_tree(outputs, torch.float32),
                precision.cast_tree(new_hidden, torch.float32))

    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint.checkpoint`` with the
        loop's ``remat`` context where it asks for one."""
        if self.remat is None:
            return fn(*args)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           context_fn=self.remat)

    def _loss_logger(self) -> Optional[LossLogger]:
        """``trainer_kwargs={"loss_logs_file": path}``: a ``LossLogger`` at
        ``<run dir>/<path>`` (``train_loops.py:886-894``)."""
        path = self.train_cfg.trainer_kwargs.get("loss_logs_file")
        return LossLogger(os.path.join(self.root_dir, path)) if path else None

    def train_step(self, inputs, targets, hidden):
        """One step: forward from the (detached) carry ``hidden``, loss (in
        f32), backward, optimizer update of the f32 parameters, under the
        step's ``matmul_precision``.  Returns the detached loss dict and the
        detached new carry."""
        with matmul_precision(self.train_cfg.trainer_kwargs.get("matmul_precision")):
            outputs, new_hidden = self._apply_train(inputs, hidden)
            d = self.loss_fn(outputs, targets)
            d["loss"].backward()
            self.opt.step()
        return {k: v.detach() for k, v in d.items()}, _detach(new_hidden)

    def run(self) -> "TrainARMLoop":
        os.makedirs(os.path.join(self.root_dir, "outputs"), exist_ok=True)
        self.save_hp()
        print("*" * 64)
        print("training's id is:", self.hash_)
        print("*" * 64)
        cfg = self.train_cfg
        # the JAX loop draws one batch before the first epoch (it initialises
        # parameters from it, train_loops.py:545-549); drawing it here too
        # keeps one data_seed's batch stream identical in both packages
        next(iter(self.loader))
        if self.opt is None:
            self.opt = self.get_optimizer(self.net, self.loader, cfg)
        if self._restored_opt_state is not None:
            self.opt.load_state_dict(self._restored_opt_state)
            self._restored_opt_state = None
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_start"):
                cb.on_fit_start(self)
        self.metrics.on_fit_start()
        self.net.train()
        nan_check_every = int(cfg.trainer_kwargs.get("nan_check_every", 25))
        epoch, interrupted = self.start_epoch, False
        try:
            for epoch in range(self.start_epoch + 1, cfg.max_epochs + 1):
                self.metrics.on_epoch_start()
                sums, n_batches, hidden, last_B = None, 0, None, None
                bar = tqdm(self._batches(), total=len(self.loader), desc=f"Epoch {epoch}",
                           leave=False, mininterval=1.0)
                for batch_idx, (inputs, targets) in enumerate(bar):
                    if cfg.limit_train_batches is not None and batch_idx >= cfg.limit_train_batches:
                        break
                    B = inputs[0].shape[0]
                    if B != last_B or (self.tbptt_len and batch_idx % self.tbptt_len == 0):
                        hidden = None
                    last_B = B
                    d, hidden = self.train_step(inputs, targets, hidden)
                    self.global_step += 1
                    n_batches += 1
                    sums = d if sums is None else {k: sums[k] + v for k, v in d.items()}
                    if batch_idx % nan_check_every == 0:
                        self.metrics.check_loss(float(d["loss"]))
                if hasattr(bar, "close"):
                    bar.close()
                if sums is not None:
                    avgs = {k: float(v) / n_batches for k, v in sums.items()}
                    self.metrics.check_loss(avgs["loss"])
                    self.metrics.log_output(avgs)
                self.metrics.flush_epoch(epoch, logger=self._loss_logger())
                # the checkpoint, then generation, then the overridable hook
                # (train_loops.py:760-767)
                for cb in self.callbacks:
                    if isinstance(cb, GenerateCallback):
                        cb.on_train_epoch_end(self, epoch)
                    else:
                        cb.on_train_epoch_end(self, epoch, self.global_step)
                self.on_train_epoch_end(epoch)
        except KeyboardInterrupt:
            interrupted = True
        if interrupted:
            for cb in self.callbacks:
                if isinstance(cb, MMKCheckpoint):
                    cb.on_train_epoch_end(self, epoch, self.global_step, interrupted=True)
        self.metrics.on_fit_end()
        self.dataset.close()
        return self

    def on_train_epoch_end(self, *args):
        """Overridable per-epoch hook."""

    def teardown(self, stage: str = "fit"):
        """For the JAX loop's API: the loop holds nothing to release."""

    def save_hp(self):
        with open(os.path.join(self.root_dir, "hp.yaml"), "w") as fp:
            fp.write(self.config.serialize())
