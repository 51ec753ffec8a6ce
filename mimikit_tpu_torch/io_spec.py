"""IOSpec: the wiring layer between data features and modules.

Counterpart of ``mimikit_tpu/io_spec.py``, reduced to ``mulaw_io`` (with a
framed-linear input for SampleRNN or an embedding input for WaveNet) and
``magspec_io`` (STFT magnitude frames in and out, the "reconstruction"
objective, for ``Seq2SeqLSTMNetwork`` and FreqNet):
``InputSpec``/``TargetSpec`` bind an extractor to a transform and an
IO-module and turn a network's ``ItemSpec`` into a windowed read
(``to_batch_item``); ``TargetSpec.loss_fn``/``IOSpec.loss_fn`` score
outputs (a dict with ``loss`` and one key per objective, weights applied);
``IOSpec`` aggregates the specs and derives sr/unit.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Dict, Mapping, Tuple

from .config import Config, private_runtime_field
from .data.batch import AsSlice, Input
from .features.extractor import Extractor
from .features.functionals import (
    Compose,
    Continuous,
    Discrete,
    FileToSignal,
    Functional,
    MagSpec,
    MuLawCompress,
    Normalize,
    RemoveDC,
)
from .features.item_spec import Frame, ItemSpec, Sample, Unit
from .modules import loss_functions as lfuncs
from .modules.activations import ActivationConfig
from .modules.io import ChunkedLinearIO, EmbeddingIO, FramedLinearIO, IOModule, MLPIO
from .modules.targets import CategoricalSampler

__all__ = [
    "InputSpec",
    "Objective",
    "TargetSpec",
    "IOSpec",
]


@dtc.dataclass
class _FeatureSpec(Config, type_field=False):
    extractor_name: str
    transform: Functional
    module: IOModule
    extractor: Extractor = private_runtime_field(None)

    def bind_to(self, extractor: Extractor):
        self.extractor = extractor
        return self

    @property
    def units(self):
        return [
            f.unit
            for f in [self.extractor.functional, self.transform]
            if f.unit is not None
        ]

    @property
    def unit(self) -> Unit:
        return self.units[-1]

    @property
    def elem_type(self):
        el = tuple(
            f.elem_type
            for f in [self.extractor.functional, self.transform]
            if f.elem_type is not None
        )
        return el[-1]

    @property
    def sr(self):
        srs = [
            f.unit.sr
            for f in [self.extractor.functional, self.transform]
            if isinstance(f.unit, Sample) and f.unit.sr is not None
        ]
        return srs[-1] if any(srs) else None

    @property
    def hop_length(self):
        hops = [
            f.unit.hop_length
            for f in [self.extractor.functional, self.transform]
            if isinstance(f.unit, Frame)
        ]
        return hops[-1] if any(hops) else None

    def to_batch_item(self, item_spec: ItemSpec) -> Input:
        """A network ItemSpec as a windowed read of the extractor's array
        (``mimikit_tpu/io_spec.py:102-116``)."""
        item_spec = item_spec.to(self.extractor.functional.unit)
        return Input(
            data=self.extractor.name,
            getter=AsSlice(
                dim=0,
                shift=item_spec.shift,
                length=item_spec.length,
                downsampling=item_spec.stride,
            ),
            transform=self.transform,
        )

    @property
    def inv(self):
        return self.transform.inv


@dtc.dataclass
class InputSpec(_FeatureSpec, type_field=False):
    def bind_to(self, extractor: Extractor):
        super().bind_to(extractor)
        if isinstance(self.elem_type, Discrete):
            self.module.set(class_size=self.elem_type.size)
        elif isinstance(self.elem_type, Continuous):
            self.module.set(in_dim=self.elem_type.size)
        return self


@dtc.dataclass
class Objective(Config, type_field=False):
    objective_type: str
    params: Dict = dtc.field(default_factory=lambda: {})
    weight: float = 1.0

    def get_criterion(self):
        """The loss of this objective: ``MeanL1Prop(**params)`` for
        'reconstruction', cross-entropy for 'categorical_dist', the loss of
        ``modules/loss_functions.py`` of that name for the other objectives
        (``WeightedL1``, ``DiffOverTime``, ``MaximizeMagnitude``,
        ``MaximizeStd``, ``ElementWiseAngularDistance``), built with
        ``params``; none for 'none' (a target served but not scored), as
        ``mimikit_tpu/io_spec.py:150-158``."""
        ot = str(self.objective_type)
        if ot == "reconstruction":
            return lfuncs.MeanL1Prop(**self.params)
        if ot == "categorical_dist":
            return lfuncs.cross_entropy
        if hasattr(lfuncs, ot):
            return getattr(lfuncs, ot)(**self.params)
        return None

    def get_sampler(self):
        """'categorical_dist' -> a :class:`CategoricalSampler` whose ``impl``
        is the objective's ``sampler_impl`` param (default "jax")."""
        if str(self.objective_type) == "categorical_dist":
            return CategoricalSampler(impl=str(self.params.get("sampler_impl", "jax")))
        return None


@dtc.dataclass
class TargetSpec(_FeatureSpec, type_field=False):
    objective: Objective = None
    extra_loss_terms: Tuple[Objective, ...] = ()

    def bind_to(self, extractor: Extractor):
        super().bind_to(extractor)
        ot = str(self.objective.objective_type)
        if ot == "reconstruction":
            if not isinstance(self.elem_type, Continuous):
                raise TypeError("reconstruction needs a Continuous target")
            self.module.set(out_dim=self.elem_type.size)
        elif ot == "categorical_dist":
            if not isinstance(self.elem_type, Discrete):
                raise TypeError("categorical_dist needs a Discrete target")
            self.module.set(
                out_dim=self.elem_type.size, sampler=self.objective.get_sampler()
            )
        return self

    def loss_fn(self, output, target) -> Dict:
        """``{"loss": total, <objective>: weighted term, ...}``
        (``mimikit_tpu/io_spec.py:193-205``)."""
        L = {}
        crit = self.objective.get_criterion()
        if crit is not None:
            L[str(self.objective.objective_type)] = crit(output, target) * self.objective.weight
        for obj in self.extra_loss_terms:
            extra = obj.get_criterion()
            if extra is not None:
                L[str(obj.objective_type)] = extra(output, target) * obj.weight
        return {"loss": sum(L.values()) if L else 0.0, **L}


@dtc.dataclass
class IOSpec(Config, type_field=False):
    inputs: Tuple[InputSpec, ...]
    targets: Tuple[TargetSpec, ...]

    def bind_to(self, extractors):
        """Bind every feature to its extractor.  ``extractors`` maps names to
        :class:`Extractor` s, or has a ``schema`` attribute that does (the
        JAX package's ``DatasetConfig``)."""
        schema: Mapping[str, Extractor] = getattr(extractors, "schema", extractors)
        for f in [*self.inputs, *self.targets]:
            f.bind_to(schema[f.extractor_name])
        return self

    def _unanimous(self, attr: str, label: str):
        values = {getattr(s, attr) for s in [*self.inputs, *self.targets]}
        if len(values) > 1:
            raise RuntimeError(
                f"Expected to find a single {label} but found several:"
                f" '{values}'"
            )
        return values.pop()

    @property
    def sr(self):
        return self._unanimous("sr", "sample_rate")

    @property
    def hop_length(self):
        return self._unanimous("hop_length", "hop_length")

    @property
    def unit(self) -> Unit:
        return self._unanimous("unit", "time unit")

    @property
    def loss_fn(self):
        """outputs, targets (tuples, one per target) -> the merged loss dict
        of every target, ``loss`` their sum (``mimikit_tpu/io_spec.py:243-255``)."""

        def func(output, target):
            per_target = [
                spec.loss_fn(o, t) for spec, o, t in zip(self.targets, output, target)
            ]
            total = sum(d.pop("loss") for d in per_target)
            merged = {k: v for d in per_target for k, v in d.items()}
            merged["loss"] = total
            return merged

        return func

    @dtc.dataclass
    class MuLawIOConfig(Config):
        sr: int = 16000
        q_levels: int = 256
        compression: float = 1.0
        input_module_type: str = "framed_linear"
        mlp_dim: int = 128
        n_mlp_layers: int = 0
        min_temperature: float = 1e-4
        # "pallas": sample through the categorical kernel (ops/categorical.py);
        # the name is the JAX package's, so YAML reads the same in both
        sampler_impl: str = "jax"

    @staticmethod
    def mulaw_io(config: "IOSpec.MuLawIOConfig", extractor: Extractor = None):
        c = config
        if extractor is None:
            extractor = Extractor(
                "signal", Compose(FileToSignal(c.sr), Normalize(), RemoveDC())
            )
        mu_law = MuLawCompress(c.q_levels, c.compression)
        if c.input_module_type == "framed_linear":
            module_type = FramedLinearIO
        elif c.input_module_type == "embedding":
            module_type = EmbeddingIO
        else:
            raise ValueError(f"Unimplemented input_module_type: '{c.input_module_type}'")
        return IOSpec(
            inputs=(
                InputSpec(
                    extractor_name=extractor.name,
                    transform=mu_law,
                    module=module_type(),
                ).bind_to(extractor),
            ),
            targets=(
                TargetSpec(
                    extractor_name=extractor.name,
                    transform=mu_law,
                    module=MLPIO(
                        hidden_dim=c.mlp_dim,
                        n_hidden_layers=c.n_mlp_layers,
                        min_temperature=c.min_temperature,
                    ),
                    objective=Objective(
                        "categorical_dist",
                        # as the JAX package writes it: no params for "jax"
                        params=(
                            {"sampler_impl": c.sampler_impl}
                            if c.sampler_impl != "jax"
                            else {}
                        ),
                    ),
                ).bind_to(extractor),
            ),
        )

    @dtc.dataclass
    class MagSpecIOConfig(Config):
        sr: int = 22050
        n_fft: int = 2048
        hop_length: int = 512
        activation: str = "Abs"

    @staticmethod
    def magspec_io(config: "IOSpec.MagSpecIOConfig", extractor: Extractor = None):
        """STFT magnitude frames (``MagSpec``, not centered, hann) in and out:
        a ``ChunkedLinearIO`` input head, a ``ChunkedLinearIO`` output head
        with ``config.activation``, and the "reconstruction" objective
        (``mimikit_tpu/io_spec.py:316-348``)."""
        c = config
        if extractor is None:
            extractor = Extractor(
                "signal", Compose(FileToSignal(c.sr), Normalize(), RemoveDC())
            )
        return IOSpec(
            inputs=(
                InputSpec(
                    extractor_name=extractor.name,
                    transform=MagSpec(c.n_fft, c.hop_length, center=False, window="hann"),
                    module=ChunkedLinearIO(n_chunks=1),
                ).bind_to(extractor),
            ),
            targets=(
                TargetSpec(
                    extractor_name=extractor.name,
                    transform=MagSpec(c.n_fft, c.hop_length, center=False, window="hann"),
                    module=ChunkedLinearIO(
                        n_chunks=1, activation=ActivationConfig(act=c.activation),
                    ),
                    objective=Objective("reconstruction"),
                ).bind_to(extractor),
            ),
        )
