"""Event-pattern mini-language for the ensemble generator.

Counterpart of ``mimikit_tpu/models/patterns.py`` (the same classes, seeded
with Python's ``random`` as there, so one seed gives one stream in both
packages).  SuperCollider-style semantics:

- a Pattern embeds a (possibly infinite) stream of values;
- ``Pbind("key", val_or_pattern, ...)`` yields event dicts until its
  SHORTEST value pattern ends (bare literals never end);
- ``Pseq(list, repeats)`` embeds each element fully, cycling ``repeats``
  times (``inf`` = forever);
- ``Pwhite(lo, hi, repeats)`` yields uniform random draws;
- ``Prand(list, repeats)`` picks random elements.

``pattern.asStream()`` returns the generator ``EnsembleGenerator``
consumes (each ``next()`` = one event dict).
"""
from __future__ import annotations

import random
from typing import Any, Iterable, Optional

__all__ = ["inf", "Pattern", "Pbind", "Pseq", "Pwhite", "Prand"]

inf = float("inf")


class Pattern:
    """Base: subclasses implement ``__stream__`` yielding values."""

    def __stream__(self):
        raise NotImplementedError

    def asStream(self):
        return self.__stream__()

    # python-side conveniences
    def __iter__(self):
        return self.__stream__()


def _value_stream(v):
    """A stream for a Pbind value: patterns embed, literals repeat forever."""
    if isinstance(v, Pattern):
        return v.__stream__()

    def forever():
        while True:
            yield v

    return forever()


class Pbind(Pattern):
    """Alternating ``key, value`` arguments; yields dicts until the
    shortest value pattern is exhausted."""

    def __init__(self, *pairs: Any, seed: Optional[int] = None):
        if len(pairs) % 2:
            raise ValueError("Pbind takes alternating key, value arguments")
        self.pairs = [(pairs[i], pairs[i + 1]) for i in range(0, len(pairs), 2)]
        self.seed = seed

    def __stream__(self):
        streams = [(k, _value_stream(v)) for k, v in self.pairs]
        while True:
            event = {}
            for k, s in streams:
                try:
                    event[k] = next(s)
                except StopIteration:
                    return
            yield event


class Pseq(Pattern):
    """Embed each element of ``lst`` fully, ``repeats`` times over."""

    def __init__(self, lst: Iterable, repeats: float = 1):
        self.lst = list(lst)
        self.repeats = repeats

    def __stream__(self):
        n = 0
        while n < self.repeats:
            for item in self.lst:
                if isinstance(item, Pattern):
                    yield from item.__stream__()
                else:
                    yield item
            n += 1


class Pwhite(Pattern):
    """Uniform random values in [lo, hi]; ``repeats`` draws per embedding."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 repeats: float = inf, seed: Optional[int] = None):
        self.lo, self.hi, self.repeats = lo, hi, repeats
        self._rng = random.Random(seed)

    def __stream__(self):
        n = 0
        while n < self.repeats:
            yield self._rng.uniform(self.lo, self.hi)
            n += 1


class Prand(Pattern):
    """Random element of ``lst`` per step; ``repeats`` draws per embedding."""

    def __init__(self, lst: Iterable, repeats: float = 1,
                 seed: Optional[int] = None):
        self.lst = list(lst)
        self.repeats = repeats
        self._rng = random.Random(seed)

    def __stream__(self):
        n = 0
        while n < self.repeats:
            item = self._rng.choice(self.lst)
            if isinstance(item, Pattern):
                yield from item.__stream__()
            else:
                yield item
            n += 1
