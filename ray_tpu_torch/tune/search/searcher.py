"""Searcher interface + built-in implementations.

The port's copy of ``ray_tpu/tune/search/searcher.py``.

Reference parity: python/ray/tune/search/searcher.py (Searcher ABC),
search/basic_variant.py (BasicVariantGenerator — grid x random), and
search/concurrency_limiter.py. External-library adapters (Optuna/HyperOpt/
...) are out of scope: the Searcher ABC is the plugin point they'd use.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .variant_generator import count_grid_variants, generate_variants


class Searcher:
    """Suggest configs; observe results. Subclass to plug in external
    optimizers (the reference's OptunaSearch etc. implement this shape)."""

    #: Sentinel return of suggest(): the search space is exhausted.
    #: Plain None means "no suggestion available right now, retry later"
    #: (e.g. under a ConcurrencyLimiter or an async optimizer backend).
    FINISHED = "FINISHED"

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric, self.mode = metric, mode

    def set_search_properties(self, metric: Optional[str], mode: Optional[str],
                              config: Dict[str, Any]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config; Searcher.FINISHED when exhausted; None to retry."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid search crossed with random sampling: each of `num_samples`
    repetitions emits the full grid product with Domains re-sampled."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None, metric: Optional[str] = None,
                 mode: str = "max"):
        super().__init__(metric, mode)
        self.space = space
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)
        # initial RNG state: experiment restore replays the emitted
        # prefix from here (the live rng has advanced past it)
        self._rng_init_state = self.rng.bit_generator.state
        self._iter = self._generate()
        self.total = num_samples * count_grid_variants(space)

    def _generate(self):
        for _ in range(self.num_samples):
            yield from generate_variants(self.space, self.rng)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        try:
            config = next(self._iter)
        except StopIteration:
            return Searcher.FINISHED
        self._emitted = getattr(self, "_emitted", 0) + 1
        return config

    # Experiment snapshots pickle the searcher; a generator can't
    # pickle, but the stream is deterministic given (space, rng seed,
    # emitted count) — rebuild and fast-forward on restore.
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_iter", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.rng.bit_generator.state = self._rng_init_state
        self._iter = self._generate()
        for _ in range(getattr(self, "_emitted", 0)):
            try:
                next(self._iter)
            except StopIteration:
                break


class RandomSearch(BasicVariantGenerator):
    """Alias emphasizing pure random sampling (no grid keys)."""


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from a wrapped searcher.

    Reference parity: tune/search/concurrency_limiter.py.
    """

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self.live: List[str] = []

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self.live) >= self.max_concurrent:
            return None  # controller retries later
        config = self.searcher.suggest(trial_id)
        if config is not None and config is not Searcher.FINISHED:
            self.live.append(trial_id)
        return config

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        if trial_id in self.live:
            self.live.remove(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)
