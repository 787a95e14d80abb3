"""TuneController: the experiment event loop.

The port's copy of ``ray_tpu/tune/execution/tune_controller.py``.

Reference parity: python/ray/tune/execution/tune_controller.py
(TuneController :68 — step :666 pattern: ask searcher for configs, start
trial actors up to the concurrency cap, wait on in-flight train() futures,
route each result through scheduler+searcher, apply CONTINUE/PAUSE/STOP,
save/restore for pause and PBT exploit :1691-1791). Trials run as
actors of the port's runtime; pause/exploit moves Trainable.save()
payloads through the object store. A trial's "GPU" resource becomes
``num_gpus``, so the runtime pins the trial's actor to its card.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import RayTpuError

from ..schedulers.trial_scheduler import (CONTINUE, PAUSE, STOP,
                                          FIFOScheduler, TrialScheduler)
from ..search.searcher import Searcher
from ..trainable import DONE, Trainable
from ..trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial,
                     new_trial_id)

logger = logging.getLogger(__name__)


class TuneController:
    def __init__(self, trainable_cls: type, searcher: Searcher,
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 4,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 max_failures: int = 0,
                 time_budget_s: Optional[float] = None,
                 stop: Optional[Dict[str, float]] = None,
                 experiment_path: Optional[str] = None,
                 checkpoint_period_s: float = 10.0):
        self.trainable_cls = trainable_cls
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler(searcher.metric,
                                                    searcher.mode)
        self.scheduler.set_search_properties(searcher.metric, searcher.mode)
        self.max_concurrent = max_concurrent
        self.resources = resources_per_trial or {}
        self.max_failures = max_failures
        self.time_budget_s = time_budget_s
        self.stop_criteria = stop or {}
        self.trials: List[Trial] = []
        self._failures: Dict[str, int] = {}
        self._searcher_done = False
        # Experiment-level durability (reference parity:
        # tune_controller.py:351 save_to_dir / :424 restore_from_dir —
        # searcher + scheduler + trial table persist so a killed driver
        # resumes the SWEEP, not just individual trials).
        self.experiment_path = experiment_path
        self.checkpoint_period_s = checkpoint_period_s
        self._last_experiment_save = 0.0

    # -- trial lifecycle ----------------------------------------------------

    def _make_actor_class(self):
        opts = {}
        if self.resources:
            resources = dict(self.resources)
            opts["num_cpus"] = resources.pop("cpu", resources.pop("CPU", 0.1))
            gpu = resources.pop("gpu", resources.pop("GPU", None))
            if gpu:
                opts["num_gpus"] = gpu
            if resources:
                opts["resources"] = resources
        else:
            opts["num_cpus"] = 0.1
        return rt.remote(**opts)(self.trainable_cls)

    def _request_trial(self) -> Optional[Trial]:
        if self._searcher_done:
            return None
        trial_id = new_trial_id()
        config = self.searcher.suggest(trial_id)
        if config is Searcher.FINISHED:
            self._searcher_done = True
            return None
        if config is None:     # transient: retry on a later step
            return None
        trial = Trial(trial_id, config)
        self.trials.append(trial)
        self.scheduler.on_trial_add(trial)
        return trial

    def _start_trial(self, trial: Trial) -> None:
        actor_cls = self._make_actor_class()
        trial.actor = actor_cls.remote(trial.config)
        if trial.restore_payload is not None:
            rt.get(trial.actor.restore.remote(trial.restore_payload))
            trial.restore_payload = None
        elif trial.checkpoint is not None:
            rt.get(trial.actor.restore.remote(trial.checkpoint))
        trial.status = RUNNING
        trial.inflight = trial.actor.train.remote()

    def _stop_trial(self, trial: Trial, status: str,
                    save_first: bool = False) -> None:
        if trial.actor is not None:
            try:
                if save_first:
                    trial.checkpoint = rt.get(trial.actor.save.remote())
                trial.actor.stop.remote()
                rt.kill(trial.actor)
            except RayTpuError:
                pass
            trial.actor = None
        trial.inflight = None
        trial.status = status

    # -- result handling ----------------------------------------------------

    def _complete_trial(self, trial: Trial, result: Optional[Dict[str, Any]],
                        save_first: bool = True) -> None:
        """Terminate + notify scheduler/searcher (the one place completion
        bookkeeping lives)."""
        self._stop_trial(trial, TERMINATED, save_first=save_first)
        self.scheduler.on_trial_complete(trial, result)
        self.searcher.on_trial_complete(trial.trial_id, result)

    def _handle_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        trial.last_result = {**trial.last_result, **result}
        trial.results.append(result)
        trial.iteration = int(result.get("training_iteration",
                                         trial.iteration + 1))
        hit_stop = any(result.get(key, float("-inf")) >= threshold
                       for key, threshold in self.stop_criteria.items())
        if result.get(DONE) or hit_stop:
            self._complete_trial(trial, result)
            return
        trial.tune_trials = self.trials  # PBT reads the population
        decision = self.scheduler.on_trial_result(trial, result)
        self.searcher.on_trial_result(trial.trial_id, result)
        exploit = getattr(self.scheduler, "pending_exploits", {}) \
            .pop(trial.trial_id, None)
        if exploit is not None:
            self._exploit(trial, *exploit)
            return
        if decision == STOP:
            self._complete_trial(trial, result)
        elif decision == PAUSE:
            self._stop_trial(trial, PAUSED, save_first=True)
        else:
            trial.inflight = trial.actor.train.remote()

    def _exploit(self, trial: Trial, source_trial_id: str,
                 new_config: Dict[str, Any]) -> None:
        """PBT: clone a top trial's weights+config into this one."""
        source = next((t for t in self.trials
                       if t.trial_id == source_trial_id), None)
        if source is None:
            trial.inflight = trial.actor.train.remote()
            return
        if source.actor is not None:
            payload = rt.get(source.actor.save.remote())
        else:
            payload = source.checkpoint
        trial.config = new_config
        reset_ok = False
        if trial.actor is not None:
            try:
                reset_ok = rt.get(trial.actor.reset.remote(new_config))
            except RayTpuError:
                reset_ok = False
        if not reset_ok:
            self._stop_trial(trial, PENDING)
            trial.restore_payload = payload
            self._start_trial(trial)
            return
        if payload is not None:
            rt.get(trial.actor.restore.remote(payload))
        trial.status = RUNNING
        trial.inflight = trial.actor.train.remote()

    def _handle_error(self, trial: Trial, exc: Exception) -> None:
        count = self._failures.get(trial.trial_id, 0) + 1
        self._failures[trial.trial_id] = count
        if self.max_failures < 0 or count <= self.max_failures:
            logger.warning("trial %s failed (attempt %d), retrying: %s",
                           trial.trial_id, count, exc)
            self._stop_trial(trial, PENDING)
            return
        trial.error = repr(exc)
        self._stop_trial(trial, ERROR)
        self.scheduler.on_trial_complete(trial, None)
        self.searcher.on_trial_complete(trial.trial_id, error=True)

    # -- main loop ----------------------------------------------------------

    def _live(self) -> List[Trial]:
        return [t for t in self.trials if not t.is_finished]

    def step(self) -> bool:
        """One controller iteration; False when the experiment is over."""
        # Schedulers (sync HyperBand) may decide to stop trials that are
        # currently PAUSED at a rung barrier — apply before refilling.
        pop_stops = getattr(self.scheduler, "pop_trials_to_stop", None)
        if pop_stops is not None:
            for tid in pop_stops():
                trial = next((t for t in self._live()
                              if t.trial_id == tid), None)
                if trial is not None:
                    self._complete_trial(trial, trial.last_result or None,
                                         save_first=False)
        running = [t for t in self._live() if t.status == RUNNING]
        # Fill capacity: scheduler picks among PENDING/PAUSED, searcher
        # supplies fresh configs.
        while len(running) < self.max_concurrent:
            candidate = self.scheduler.choose_trial_to_run(self._live())
            if candidate is None:
                candidate = self._request_trial()
            if candidate is None:
                break
            self._start_trial(candidate)
            running.append(candidate)
        if not running:
            return bool(self._live()) and not self._searcher_done
        refs = [t.inflight for t in running if t.inflight is not None]
        ready, _ = rt.wait(refs, num_returns=1, timeout=30.0)
        for ref in ready:
            trial = next(t for t in running if t.inflight == ref)
            trial.inflight = None
            try:
                result = rt.get(ref)
            except RayTpuError as exc:
                self._handle_error(trial, exc)
                continue
            self._handle_result(trial, result)
        return True

    # -- experiment-level save/restore -------------------------------------

    def save_experiment(self, path: Optional[str] = None) -> str:
        """Snapshot searcher + scheduler + trial table to one file.
        In-flight trials are recorded as PAUSED at their last
        checkpoint (their running actors cannot persist); a restore
        re-launches them from that checkpoint."""
        import os

        import cloudpickle
        path = path or self.experiment_path
        assert path, "no experiment_path configured"
        snap = []
        for t in self.trials:
            status = t.status
            if status not in (TERMINATED, ERROR):
                status = PAUSED if t.checkpoint is not None else PENDING
            snap.append({
                "trial_id": t.trial_id, "config": t.config,
                "status": status, "last_result": t.last_result,
                "results": t.results, "checkpoint": t.checkpoint,
                "error": t.error, "iteration": t.iteration,
            })
        state = {"searcher": self.searcher, "scheduler": self.scheduler,
                 "trials": snap, "failures": dict(self._failures),
                 "searcher_done": self._searcher_done}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, path)
        self._last_experiment_save = time.time()
        return path

    def restore_experiment(self, path: Optional[str] = None) -> None:
        """Load a save_experiment snapshot: finished trials keep their
        results, interrupted ones re-enter the queue from their last
        checkpoint, and the searcher/scheduler continue exactly where
        the sweep stopped (TPE's observation history, HyperBand rungs,
        PBT populations all survive)."""
        import cloudpickle
        path = path or self.experiment_path
        with open(path, "rb") as f:
            state = cloudpickle.load(f)
        self.searcher = state["searcher"]
        self.scheduler = state["scheduler"]
        self._failures = dict(state["failures"])
        self._searcher_done = state["searcher_done"]
        self.trials = []
        for s in state["trials"]:
            t = Trial(s["trial_id"], s["config"])
            t.status = s["status"]
            t.last_result = s["last_result"]
            t.results = s["results"]
            t.checkpoint = s["checkpoint"]
            t.error = s["error"]
            t.iteration = s["iteration"]
            if t.status == PAUSED:
                t.restore_payload = t.checkpoint
            self.trials.append(t)
        from ..trial import advance_trial_counter_past
        advance_trial_counter_past(t2.trial_id for t2 in self.trials)

    def _maybe_save_experiment(self) -> None:
        if (self.experiment_path
                and time.time() - self._last_experiment_save
                >= self.checkpoint_period_s):
            try:
                self.save_experiment()
            except Exception:
                logger.exception("experiment checkpoint failed")

    def run(self) -> List[Trial]:
        start = time.time()
        while self.step():
            self._maybe_save_experiment()
            if self.time_budget_s and time.time() - start > self.time_budget_s:
                break
        for trial in self._live():
            self._stop_trial(trial, TERMINATED, save_first=True)
            self.searcher.on_trial_complete(trial.trial_id,
                                            trial.last_result or None)
        if self.experiment_path:
            try:
                self.save_experiment()
            except Exception:
                logger.exception("final experiment checkpoint failed")
        return self.trials
