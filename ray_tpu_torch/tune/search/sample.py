"""Search-space sampling primitives.

The port's copy of ``ray_tpu/tune/search/sample.py``.

Reference parity: python/ray/tune/search/sample.py (Domain/Float/Integer/
Categorical with uniform/loguniform/quantized samplers) — rebuilt on
numpy.random.Generator; every domain is picklable so search spaces travel
to trial actors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class Domain:
    """A sampleable dimension of a search space."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    # Grid support: domains that can enumerate values override this.
    def grid_values(self) -> Optional[List[Any]]:
        return None


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        if upper <= lower:
            raise ValueError(f"empty range [{lower}, {upper})")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: np.random.Generator) -> float:
        if self.log:
            value = math.exp(rng.uniform(math.log(self.lower),
                                         math.log(self.upper)))
        else:
            value = rng.uniform(self.lower, self.upper)
        if self.q is not None:
            value = round(round(value / self.q) * self.q, 10)
        return float(value)

    def __repr__(self):
        kind = "loguniform" if self.log else "uniform"
        return f"{kind}({self.lower}, {self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False,
                 q: Optional[int] = None):
        if upper <= lower:
            raise ValueError(f"empty range [{lower}, {upper})")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: np.random.Generator) -> int:
        if self.log:
            value = int(math.exp(rng.uniform(math.log(self.lower),
                                             math.log(self.upper))))
        else:
            value = int(rng.integers(self.lower, self.upper))
        if self.q is not None:
            value = int(round(value / self.q) * self.q)
            hi = (self.upper // self.q) * self.q
            return int(min(max(value, self.lower), hi))
        return int(min(max(value, self.lower), self.upper - 1))

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        if not categories:
            raise ValueError("empty choice()")
        self.categories = list(categories)

    def sample(self, rng: np.random.Generator) -> Any:
        return self.categories[int(rng.integers(len(self.categories)))]

    def grid_values(self) -> List[Any]:
        return list(self.categories)

    def __repr__(self):
        return f"choice({self.categories})"


class Function(Domain):
    """sample_from: arbitrary callable, optionally taking the resolved spec."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng: np.random.Generator, spec: Any = None) -> Any:
        try:
            return self.fn(spec)
        except TypeError:
            return self.fn()

    def __repr__(self):
        return f"sample_from({self.fn})"


class GridSearch:
    """Marker for exhaustive enumeration of the given values."""

    def __init__(self, values: Sequence[Any]):
        if not values:
            raise ValueError("empty grid_search()")
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values})"


# -- public constructors (mirror ray.tune's names) --------------------------

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)
