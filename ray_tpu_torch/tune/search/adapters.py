"""External-optimizer searcher adapters (Optuna, HyperOpt).

The port's copy of ``ray_tpu/tune/search/adapters.py``.

Reference parity: python/ray/tune/search/optuna/optuna_search.py and
search/hyperopt/hyperopt_search.py — thin Searcher implementations that
translate tune Domains into the external library's space and delegate
suggest/observe. The libraries are NOT vendored: constructing an
adapter without its library installed raises ImportError with install
guidance (same behavior as the reference). The Domain translation is a
standalone pure function so it stays testable without the libraries.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .sample import Categorical, Domain, Float, GridSearch, Integer
from .searcher import Searcher


def domain_spec(dom: Domain) -> Tuple:
    """Neutral description of a Domain: the adapter materializes it in
    its library's vocabulary. ("float", lo, hi, log, q) |
    ("int", lo, hi, log, q) | ("cat", [choices])."""
    if isinstance(dom, Float):
        return ("float", float(dom.lower), float(dom.upper),
                bool(dom.log), dom.q)
    if isinstance(dom, Integer):
        return ("int", int(dom.lower), int(dom.upper),
                bool(dom.log), dom.q)
    if isinstance(dom, Categorical):
        return ("cat", list(dom.categories))
    raise ValueError(f"unsupported domain type {type(dom).__name__}")


def split_space(space: Dict[str, Any]):
    """(domains, fixed) — grid_search keys are rejected like TPE does."""
    domains: Dict[str, Tuple] = {}
    fixed: Dict[str, Any] = {}
    for key, val in space.items():
        if isinstance(val, GridSearch):
            raise ValueError(
                "external searchers do not take grid_search dimensions; "
                "use BasicVariantGenerator for grids")
        if isinstance(val, Domain):
            domains[key] = domain_spec(val)
        else:
            fixed[key] = val
    return domains, fixed


class OptunaSearch(Searcher):
    """Suggestions from an optuna.Study (TPE/CMA-ES/NSGA per sampler).

    Reference: tune/search/optuna/optuna_search.py:OptunaSearch.
    """

    def __init__(self, space: Dict[str, Any], metric: str, mode: str = "max",
                 num_samples: int = 64, sampler=None,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires optuna (`pip install optuna`); "
                "TPESearch/BOHBSearch are the no-dependency equivalents"
            ) from e
        self._optuna = optuna
        self.num_samples = num_samples
        self._suggested = 0
        self.domains, self.fixed = split_space(space)
        self._study = optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=sampler or optuna.samplers.TPESampler(seed=seed))
        self._ot_trials: Dict[str, Any] = {}

    def _distributions(self):
        d = self._optuna.distributions
        out = {}
        for key, spec in self.domains.items():
            if spec[0] == "float":
                _, lo, hi, log, q = spec
                out[key] = d.FloatDistribution(lo, hi, log=log,
                                               step=None if log else q)
            elif spec[0] == "int":
                _, lo, hi, log, q = spec
                out[key] = d.IntDistribution(lo, hi, log=log,
                                             step=(q or 1) if not log else 1)
            else:
                out[key] = d.CategoricalDistribution(spec[1])
        return out

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self.num_samples:
            return Searcher.FINISHED
        self._suggested += 1
        ot = self._study.ask(self._distributions())
        self._ot_trials[trial_id] = ot
        config = dict(ot.params)
        config.update(self.fixed)
        return config

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        ot = self._ot_trials.pop(trial_id, None)
        if ot is None:
            return
        state = self._optuna.trial.TrialState
        if error or not result or self.metric not in result:
            self._study.tell(ot, state=state.FAIL)
        else:
            self._study.tell(ot, float(result[self.metric]))


class HyperOptSearch(Searcher):
    """Suggestions from hyperopt's TPE over a translated space.

    Reference: tune/search/hyperopt/hyperopt_search.py:HyperOptSearch.
    """

    def __init__(self, space: Dict[str, Any], metric: str, mode: str = "max",
                 num_samples: int = 64, seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import hyperopt
        except ImportError as e:
            raise ImportError(
                "HyperOptSearch requires hyperopt (`pip install "
                "hyperopt`); TPESearch/BOHBSearch are the no-dependency "
                "equivalents") from e
        import numpy as np
        self._hpo = hyperopt
        self.num_samples = num_samples
        self._suggested = 0
        self.domains, self.fixed = split_space(space)
        self._hp_space = self._build_space()
        self._hp_trials = hyperopt.Trials()
        self._rng = np.random.default_rng(seed)
        self._tid_by_trial: Dict[str, int] = {}

    def _build_space(self):
        hp = self._hpo.hp
        import math
        out = {}
        for key, spec in self.domains.items():
            if spec[0] == "float":
                _, lo, hi, log, q = spec
                if log:
                    out[key] = hp.loguniform(key, math.log(lo), math.log(hi))
                elif q:
                    out[key] = hp.quniform(key, lo, hi, q)
                else:
                    out[key] = hp.uniform(key, lo, hi)
            elif spec[0] == "int":
                _, lo, hi, log, q = spec
                out[key] = hp.uniformint(key, lo, hi)
            else:
                out[key] = hp.choice(key, spec[1])
        return out

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self.num_samples:
            return Searcher.FINISHED
        self._suggested += 1
        hpo = self._hpo
        tid = len(self._hp_trials.trials)
        seed = int(self._rng.integers(2 ** 31 - 1))
        new = hpo.tpe.suggest(
            [tid], hpo.base.Domain(lambda c: 0, self._hp_space),
            self._hp_trials, seed)
        self._hp_trials.insert_trial_docs(new)
        self._hp_trials.refresh()
        self._tid_by_trial[trial_id] = tid
        vals = {k: v[0] for k, v in
                self._hp_trials.trials[tid]["misc"]["vals"].items() if v}
        config = self._decode(vals)
        config.update(self.fixed)
        return config

    def _decode(self, vals: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key, spec in self.domains.items():
            v = vals[key]
            if spec[0] == "cat":
                out[key] = spec[1][int(v)]      # hp.choice gives an index
            elif spec[0] == "int":
                out[key] = int(v)
            else:
                out[key] = float(v)
        return out

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        tid = self._tid_by_trial.pop(trial_id, None)
        if tid is None:
            return
        trial = self._hp_trials.trials[tid]
        if error or not result or self.metric not in result:
            trial["state"] = self._hpo.JOB_STATE_ERROR
        else:
            score = float(result[self.metric])
            loss = -score if self.mode == "max" else score
            trial["state"] = self._hpo.JOB_STATE_DONE
            trial["result"] = {"loss": loss, "status": "ok"}
        self._hp_trials.refresh()
