"""ray_tpu_torch.tune's experiment save/resume and Tune over the port's
TorchTrainer: ``test_tune_experiment_resume.py``'s two cases and
``test_tune_train_integration.py``'s one, mirrored on the port's runtime
(reference: tune/execution/tune_controller.py:351 save_to_dir / :424
restore_from_dir + Tuner.restore; base_trainer.py:808 as_trainable).
The sweep survives a driver crash: searcher observation history,
scheduler state and finished-trial results carry over; only unfinished
work re-runs. A restored TPE searcher also continues with the
suggestions the JAX package's would make from the same history."""

import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train, tune
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.tune import TPESearch, TuneConfig, Tuner
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.trainable import wrap_function
from ray_tpu_torch.tune.trial import ERROR, TERMINATED


@pytest.fixture(scope="module")
def ray_start():
    rt.init(num_cpus=8)
    yield rt
    rt.shutdown()


def test_controller_experiment_save_restore(ray_start, tmp_path):
    marker = str(tmp_path / "executions")

    def objective(config):
        with open(marker, "a") as f:
            f.write("x\n")
        tune.report({"loss": (config["x"] - 0.5) ** 2})

    space = {"x": tune.uniform(-1.0, 1.0)}
    snap = str(tmp_path / "exp.pkl")
    tpe = TPESearch(space, metric="loss", mode="min", num_samples=12,
                    n_startup_trials=4, seed=0)
    c1 = TuneController(wrap_function(objective), tpe,
                        max_concurrent=1, experiment_path=snap,
                        checkpoint_period_s=0.0)
    # run PART of the sweep, then "crash" (abandon the controller)
    for _ in range(200):
        finished = [t for t in c1.trials if t.is_finished]
        if len(finished) >= 5 or not c1.step():
            break
    c1.save_experiment()
    for t in c1._live():                      # reap the leaked actor
        if t.actor is not None:
            try:
                rt.kill(t.actor)
            except Exception:
                pass
    done_before = {t.trial_id for t in c1.trials if t.is_finished}
    assert 1 <= len(done_before) < 12
    runs_before = open(marker).read().count("x")

    # a fresh controller (different seed on its throwaway searcher —
    # the RESTORED searcher replaces it) resumes the sweep
    tpe2 = TPESearch(space, metric="loss", mode="min", num_samples=12,
                     n_startup_trials=4, seed=999)
    c2 = TuneController(wrap_function(objective), tpe2,
                        max_concurrent=1, experiment_path=snap)
    c2.restore_experiment()
    assert {t.trial_id for t in c2.trials
            if t.is_finished} == done_before, \
        "finished trials lost across restore"
    trials = c2.run()

    assert len(trials) == 12, "searcher did not continue the sweep"
    assert all(t.status in (TERMINATED, ERROR) for t in trials)
    assert done_before <= {t.trial_id for t in trials}
    # finished trials did NOT re-execute: total executions is 12 plus
    # at most one re-run of the trial that was in flight at the crash
    runs_total = open(marker).read().count("x")
    assert runs_total - runs_before <= (12 - len(done_before)) + 1
    # the sweep still optimizes end-to-end
    best = min(t.last_result["loss"] for t in trials
               if t.last_result and "loss" in t.last_result)
    assert best < 0.5

    # the final snapshot reflects completion: restoring it again shows
    # a finished experiment (nothing left to run)
    c3 = TuneController(wrap_function(objective), tpe2,
                        max_concurrent=1, experiment_path=snap)
    c3.restore_experiment()
    assert all(t.is_finished for t in c3.trials)
    assert len(c3.trials) == 12


def test_tuner_restore_api(ray_start, tmp_path):
    """The Tuner.restore(path, trainable) surface."""
    def objective(config):
        tune.report({"score": -abs(config["x"] - 0.25)})

    space = {"x": tune.uniform(0.0, 1.0)}
    snap = str(tmp_path / "exp2.pkl")
    tuner = Tuner(objective, param_space=space,
                  tune_config=TuneConfig(
                      metric="score", mode="max", num_samples=6,
                      max_concurrent_trials=2, experiment_path=snap,
                      checkpoint_period_s=0.0))
    grid = tuner.fit()
    assert len(grid) == 6 and os.path.exists(snap)

    restored = Tuner.restore(snap, objective,
                             tune_config=TuneConfig(
                                 metric="score", mode="max",
                                 num_samples=6))
    grid2 = restored.fit()
    # nothing re-ran: same trials, same best
    assert {r.trial_id for r in grid2.results} == \
        {r.trial_id for r in grid.results}
    assert grid2.get_best_result().metrics["score"] == \
        grid.get_best_result().metrics["score"]


def test_tuner_over_torch_trainer(ray_start, tmp_path):
    def loop(config):
        for step in range(3):
            train.report({"loss": config["lr"] * (step + 1)})

    trainer = TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="tt", storage_path=str(tmp_path)))
    tuner = Tuner(trainer,
                  param_space={"lr": tune.grid_search([0.1, 0.3])},
                  tune_config=TuneConfig(metric="loss", mode="min",
                                         max_concurrent_trials=1))
    results = tuner.fit()
    assert len(results) == 2
    assert not results.errors
    best = results.get_best_result()
    assert best.config["lr"] == 0.1


def test_restored_searcher_continues_as_reference(ray_start, tmp_path):
    """A snapshot's TPE searcher, restored into a fresh controller,
    suggests what the JAX package's TPE suggests after the same
    observations."""
    import ray_tpu.tune as jtune

    space = {"x": tune.uniform(-1.0, 1.0)}
    snap = str(tmp_path / "exp3.pkl")
    tpe = TPESearch(space, metric="loss", mode="min", num_samples=10,
                    n_startup_trials=3, seed=4)
    jtpe = jtune.TPESearch({"x": jtune.uniform(-1.0, 1.0)}, metric="loss",
                           mode="min", num_samples=10, n_startup_trials=3,
                           seed=4)
    for i in range(5):
        a, b = tpe.suggest(f"trial_{i:05d}"), jtpe.suggest(f"trial_{i:05d}")
        assert a == b
        tpe.on_trial_complete(f"trial_{i:05d}", {"loss": a["x"] ** 2})
        jtpe.on_trial_complete(f"trial_{i:05d}", {"loss": b["x"] ** 2})
    c1 = TuneController(wrap_function(lambda c: None), tpe,
                        experiment_path=snap)
    c1.save_experiment()
    c2 = TuneController(wrap_function(lambda c: None),
                        TPESearch(space, metric="loss", mode="min", seed=1),
                        experiment_path=snap)
    c2.restore_experiment()
    for i in range(5, 10):
        assert c2.searcher.suggest(f"trial_{i:05d}") == jtpe.suggest(
            f"trial_{i:05d}")
