"""Resolve search-space dicts into concrete trial configs.

The port's copy of ``ray_tpu/tune/search/variant_generator.py``.

Reference parity: python/ray/tune/search/variant_generator.py
(generate_variants — cartesian product of grid_search values crossed with
sampled Domains, nested-dict aware).
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from .sample import Domain, Function, GridSearch

Path = Tuple[str, ...]


def _walk(spec: Dict[str, Any], prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    for key, value in spec.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            yield from _walk(value, path)
        else:
            yield path, value


def _set_path(spec: Dict[str, Any], path: Path, value: Any) -> None:
    node = spec
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def count_grid_variants(spec: Dict[str, Any]) -> int:
    total = 1
    for _, value in _walk(spec):
        if isinstance(value, GridSearch):
            total *= len(value.values)
    return total


def generate_variants(spec: Dict[str, Any],
                      rng: np.random.Generator) -> Iterator[Dict[str, Any]]:
    """Yield one resolved config per grid-product element; Domain values are
    re-sampled per variant. Called repeatedly for num_samples > 1."""
    grid_paths: List[Path] = []
    grid_values: List[List[Any]] = []
    for path, value in _walk(spec):
        if isinstance(value, GridSearch):
            grid_paths.append(path)
            grid_values.append(value.values)

    for combo in itertools.product(*grid_values) if grid_paths else [()]:
        resolved = copy.deepcopy(spec)
        for path, value in zip(grid_paths, combo):
            _set_path(resolved, path, value)
        # Two passes so sample_from(spec) can read already-resolved values.
        deferred: List[Tuple[Path, Function]] = []
        for path, value in _walk(resolved):
            if isinstance(value, Function):
                deferred.append((path, value))
            elif isinstance(value, Domain):
                _set_path(resolved, path, value.sample(rng))
        for path, fn_domain in deferred:
            _set_path(resolved, path, fn_domain.sample(rng, _Spec(resolved)))
        yield resolved


class _Spec:
    """Attribute view over the resolved config for sample_from callables
    (mirrors the reference's spec.config access pattern)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = _AttrDict(config)


class _AttrDict(dict):
    def __init__(self, data: Dict[str, Any]):
        super().__init__(data)

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc
        return _AttrDict(value) if isinstance(value, dict) else value
