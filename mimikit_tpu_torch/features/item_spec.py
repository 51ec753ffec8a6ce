"""Time-unit bookkeeping for exact sample/frame/second arithmetic.

A verbatim copy of ``mimikit_tpu/features/item_spec.py`` (the port imports
nothing of the JAX package), itself a rebuild of mimikit's unit algebra
(``features/item_spec.py:23-151``).  Networks express
receptive-field needs as ``ItemSpec`` arithmetic; the data layer converts them
to window reads.  The semantics here are pinned by the STFT alignment tests:

* a *length* expressed in frames corresponds to ``n_frames * hop`` samples
  **plus** the ``frame_size - hop`` edge, unless the frame unit is padded
  (centered STFT), in which case the edge vanishes;
* a *shift* (a position) in frames is just ``n_frames * hop`` samples, with a
  one-frame correction when the frame unit is padded.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Any, Optional, Union

__all__ = [
    "Sample",
    "Frame",
    "Step",
    "Second",
    "Unit",
    "ItemSpec",
    "convert",
]


class _UnitBase:
    # finer units come first: adding specs aligns to the finer unit
    _order = ("Sample", "Frame", "Second", "Step")

    def __lt__(self, other):
        return self._order.index(type(self).__name__) < self._order.index(
            type(other).__name__
        )


@dtc.dataclass
class Sample(_UnitBase):
    sr: Optional[int]

    def __hash__(self):
        return hash(repr(self))


@dtc.dataclass
class Frame(_UnitBase):
    frame_size: int
    hop_length: int
    padding: Optional[Any] = None

    def __hash__(self):
        return hash(repr(self))


@dtc.dataclass
class Second(_UnitBase):
    sr: Optional[int]

    def __hash__(self):
        return hash(repr(self))


@dtc.dataclass
class Step(_UnitBase):
    def __hash__(self):
        return hash(repr(self))


Unit = Union[Sample, Frame, Second, Step]


def _frame_edge(frame: Frame, as_length: bool) -> int:
    """The extra samples a frame-length covers beyond ``n * hop``.

    Zero for positions (shifts) and for padded (centered) frame units.
    """
    if not as_length:
        return 0
    return (frame.frame_size - frame.hop_length) * int(not bool(frame.padding))


def _resolve_sr(u: Unit, v: Unit) -> int:
    srs = {x.sr for x in (u, v) if getattr(x, "sr", None) is not None}
    assert len(srs) == 1, f"couldn't find a single sr: {u}, {v}"
    return srs.pop()


def convert(x, from_unit: Unit, to_unit: Unit, as_length: bool):
    """Convert a quantity ``x`` between time units.

    ``as_length`` selects length semantics (edge corrections apply) versus
    position semantics (no edge).  Matches the reference ``convert``
    (``item_spec.py:58-112``) including the padded-frame offset.
    """
    src, dst = type(from_unit), type(to_unit)

    if src is Sample:
        if dst is Frame:
            return int((x - _frame_edge(to_unit, as_length)) // to_unit.hop_length)
        if dst is Second:
            return x / _resolve_sr(from_unit, to_unit)
        return x

    if src is Frame:
        has_padding = bool(from_unit.padding)
        x = x - int(has_padding)
        if dst is Sample:
            return int(x * from_unit.hop_length) + _frame_edge(from_unit, as_length)
        if dst is Second:
            return (
                x * from_unit.hop_length + _frame_edge(from_unit, as_length)
            ) / to_unit.sr
        return x

    if src is Second:
        if dst is Frame:
            n_samples = int(x * from_unit.sr)
            return (n_samples - _frame_edge(to_unit, as_length)) // to_unit.hop_length
        if dst is Sample:
            return int(x * _resolve_sr(to_unit, from_unit))
        if dst is Step:
            raise TypeError("can not convert seconds to steps")
        return x

    if src is Step:
        # mirrors the reference exactly (``item_spec.py:109-112``): converting
        # a Step quantity into any concrete unit passes it through verbatim
        # (callers only combine Step offsets with like-grained units)
        if dst is Step:
            raise TypeError("can not convert steps to steps")
        return x

    raise TypeError(f"unknown unit {from_unit}")


@dtc.dataclass
class ItemSpec:
    """A windowed read: ``shift`` offset, ``length`` extent, ``stride``
    downsampling, in a given time unit."""

    shift: Union[int, float] = 0
    length: Union[int, float] = 0
    stride: Union[int, float] = 1
    unit: Unit = dtc.field(default_factory=Step)

    def __add__(self, other: "ItemSpec") -> "ItemSpec":
        if not isinstance(other, ItemSpec):
            raise TypeError(
                f"Expected other to be of type ItemSpec. Got {type(other)}"
            )
        if isinstance(self.unit, type(other.unit)) and self.unit != other.unit:
            raise ValueError(
                "Can not add unit of the same type parametrized differently:\n"
                f" {self.unit} and {other.unit}"
            )
        target_unit = min(self.unit, other.unit)
        if target_unit == self.unit:
            a = self
            b = other.to(target_unit) if other.unit != self.unit else other
        else:
            a, b = self.to(target_unit), other
        return ItemSpec(
            a.shift + b.shift,
            a.length + b.length,
            max(a.stride, b.stride),
            target_unit,
        )

    def to(self, unit: Unit) -> "ItemSpec":
        return ItemSpec(
            shift=convert(self.shift, self.unit, unit, as_length=False),
            length=convert(self.length, self.unit, unit, as_length=True),
            stride=self.stride,
            unit=unit,
        )
