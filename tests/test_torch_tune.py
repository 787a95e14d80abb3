"""ray_tpu_torch.tune against ray_tpu.tune: ``test_tune.py``'s twelve
cases mirrored on the port's runtime, then parity without a runtime.
The same seeds and the same scripted reports go through both packages,
which must agree exactly (the search and scheduling code is pure Python
and numpy on both sides): resolved configs from ``sample`` and
``generate_variants``, TPE and BOHB suggestions, the PB2 GP's numbers,
and every ASHA, HyperBand, median-stopping, PBT and PB2 decision."""

import numpy as np
import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch as rt
from ray_tpu.tune import trial as jtrial
from ray_tpu.tune.schedulers import trial_scheduler as jts
from ray_tpu.tune.search.variant_generator import \
    generate_variants as jgenerate
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (ASHAScheduler, BasicVariantGenerator,
                                ConcurrencyLimiter, HyperBandScheduler,
                                MedianStoppingRule, PopulationBasedTraining,
                                Trainable, TuneConfig, Tuner)
from ray_tpu_torch.tune import trial as ptrial
from ray_tpu_torch.tune.schedulers import trial_scheduler as pts
from ray_tpu_torch.tune.search.variant_generator import generate_variants


@pytest.fixture(scope="module")
def ray_start():
    rt.init(num_cpus=8)
    yield rt
    rt.shutdown()


# -- search-space resolution (no cluster needed) ---------------------------

def test_grid_and_sample_resolution():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0.0, 1.0),
        "depth": tune.grid_search([2, 4]),
        "nested": {"units": tune.choice([32, 64])},
    }
    variants = list(generate_variants(space, np.random.default_rng(0)))
    assert len(variants) == 4  # 2 x 2 grid
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    for v in variants:
        assert 0.0 <= v["wd"] < 1.0
        assert v["nested"]["units"] in (32, 64)


def test_sample_from_sees_spec():
    space = {
        "a": tune.grid_search([3, 5]),
        "b": tune.sample_from(lambda spec: spec.config.a * 10),
    }
    variants = list(generate_variants(space, np.random.default_rng(0)))
    assert sorted(v["b"] for v in variants) == [30, 50]


def test_loguniform_and_randint_bounds():
    rng = np.random.default_rng(0)
    for _ in range(100):
        assert 1e-5 <= tune.loguniform(1e-5, 1e-1).sample(rng) <= 1e-1
        assert 2 <= tune.randint(2, 9).sample(rng) < 9
        assert tune.qrandint(0, 100, 10).sample(rng) % 10 == 0


# -- end-to-end experiments ------------------------------------------------

def _objective(config):
    score = 0.0
    for step in range(5):
        score += config["lr"]
        tune.report({"score": score, "step": step})


def test_function_trainable_grid(ray_start):
    results = tune.run(_objective,
                       config={"lr": tune.grid_search([0.1, 0.5, 1.0])},
                       metric="score", mode="max")
    assert len(results) == 3
    best = results.get_best_result()
    assert best.config["lr"] == 1.0
    assert best.metrics["score"] == pytest.approx(5.0)


class _StepTrainable(Trainable):
    def setup(self, config):
        self.value = 0.0

    def step(self):
        self.value += self.config["delta"]
        return {"value": self.value}

    def save_checkpoint(self):
        return {"value": self.value}

    def load_checkpoint(self, state):
        self.value = state["value"]


class _Capped(_StepTrainable):
    """Done at iteration 7. With config["barrier"] (a directory), each
    of the `population` trials waits in setup until all have started:
    PBT compares a trial with the others only while they run, and a
    trial whose actor starts first could otherwise finish alone."""

    def setup(self, config):
        super().setup(config)
        barrier = config.get("barrier")
        if barrier:
            import os
            import time
            open(os.path.join(barrier, repr(config["delta"])), "w").close()
            deadline = time.time() + 30
            while (len(os.listdir(barrier)) < config["population"]
                   and time.time() < deadline):
                time.sleep(0.02)

    def step(self):
        result = super().step()
        result["done"] = self._iteration >= 7
        return result


def test_class_trainable_asha_stops_bad_trials(ray_start):
    tuner = Tuner(
        _StepTrainable,
        # Descending order: weak trials reach each rung after strong ones
        # have set the cutoff (async halving cuts on arrival).
        param_space={"delta": tune.grid_search([2.0, 1.0, 0.2, 0.1])},
        tune_config=TuneConfig(
            metric="value", mode="max", max_concurrent_trials=4,
            scheduler=ASHAScheduler(max_t=12, grace_period=2,
                                    reduction_factor=2)))
    results = tuner.fit()
    best = results.get_best_result()
    assert best.config["delta"] == 2.0
    # ASHA must have cut at least one weak trial before max_t
    iters = [r.metrics.get("training_iteration", 0) for r in results.results]
    assert min(iters) < 12 and max(iters) == 12


def test_median_stopping(ray_start):
    results = tune.run(
        _StepTrainable,
        config={"delta": tune.grid_search([0.01, 1.0, 1.1, 1.2])},
        metric="value", mode="max", stop={"training_iteration": 10},
        scheduler=MedianStoppingRule(grace_period=2,
                                     min_samples_required=2))
    by_delta = {r.config["delta"]: r for r in results.results}
    slow = by_delta[0.01].metrics.get("training_iteration", 99)
    fast = by_delta[1.2].metrics.get("training_iteration", 0)
    assert slow <= fast


def test_pbt_exploits_and_perturbs(ray_start, tmp_path):
    scheduler = PopulationBasedTraining(
        metric="value", mode="max", perturbation_interval=2,
        hyperparam_mutations={"delta": tune.uniform(0.5, 3.0)}, seed=0)
    tuner = Tuner(
        _Capped,
        param_space={"delta": tune.grid_search([0.01, 0.02, 2.0, 3.0]),
                     "barrier": str(tmp_path), "population": 4},
        tune_config=TuneConfig(metric="value", mode="max",
                               max_concurrent_trials=4,
                               scheduler=scheduler,
                               time_budget_s=60))
    results = tuner.fit()
    assert scheduler.num_perturbations >= 1
    best = results.get_best_result()
    assert best.metrics["value"] > 2.0


def test_concurrency_limiter(ray_start):
    searcher = ConcurrencyLimiter(
        BasicVariantGenerator({"lr": tune.uniform(0, 1)}, num_samples=5,
                              seed=1, metric="score", mode="max"),
        max_concurrent=2)
    results = tune.run(_objective, search_alg=searcher, metric="score",
                       mode="max", max_concurrent_trials=4)
    assert len(results) == 5


def test_trial_error_surfaces(ray_start):
    def bad(config):
        raise ValueError("boom")

    results = tune.run(bad, config={}, metric="x", mode="max")
    assert len(results.errors) == 1
    assert "boom" in results.errors[0]


def test_hyperband_promotes(ray_start):
    results = tune.run(
        _StepTrainable,
        config={"delta": tune.grid_search([0.1, 0.5, 1.0, 2.0])},
        metric="value", mode="max",
        scheduler=HyperBandScheduler(max_t=9, reduction_factor=3))
    best = results.get_best_result()
    assert best.config["delta"] == 2.0


def test_pb2_gp_directed_explore(ray_start, tmp_path):
    """PB2: exploit configs come from the GP-UCB bandit within
    hyperparam_bounds, not random perturbation; the experiment still
    improves the population."""
    from ray_tpu_torch.tune import PB2

    scheduler = PB2(
        metric="value", mode="max", perturbation_interval=2,
        hyperparam_bounds={"delta": (0.5, 3.0)}, seed=0)
    tuner = Tuner(
        _Capped,
        param_space={"delta": tune.grid_search([0.01, 0.02, 2.0, 3.0]),
                     "barrier": str(tmp_path), "population": 4},
        tune_config=TuneConfig(metric="value", mode="max",
                               max_concurrent_trials=4,
                               scheduler=scheduler,
                               time_budget_s=60))
    results = tuner.fit()
    assert scheduler.num_perturbations >= 1
    # every exploited config stays inside the declared bounds
    for _, (_, cfg) in list(scheduler.pending_exploits.items()):
        assert 0.5 <= cfg["delta"] <= 3.0
    assert results.get_best_result().metrics["value"] > 2.0


def test_pb2_gp_math():
    """The internal GP interpolates a smooth function and UCB prefers
    the known-good region once data exists; its numbers are the JAX
    package's, bit for bit."""
    from ray_tpu.tune.schedulers.pb2 import _GP as JGP
    from ray_tpu_torch.tune.schedulers.pb2 import _GP

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    y = np.sin(3 * x[:, 1]) + 0.01 * rng.normal(size=40)
    gp, jgp = _GP(), JGP()
    gp.fit(x, (y - y.mean()) / y.std())
    jgp.fit(x, (y - y.mean()) / y.std())
    q = np.array([[0.5, 0.5], [0.5, 0.52]])
    mu, sd = gp.predict(q)
    assert np.all(sd >= 0)
    # interpolation: prediction close to the true (normalized) function
    true = (np.sin(3 * q[:, 1]) - y.mean()) / y.std()
    assert np.all(np.abs(mu - true) < 0.35), (mu, true)
    jmu, jsd = jgp.predict(q)
    assert mu.tobytes() == jmu.tobytes() and sd.tobytes() == jsd.tobytes()


# -- parity with ray_tpu.tune, no runtime ----------------------------------

def _space(t):
    return {
        "lr": t.loguniform(1e-5, 1e-1),
        "q": t.quniform(0.0, 1.0, 0.125),
        "ql": t.qloguniform(1e-3, 1.0, 1e-3),
        "n": t.randint(2, 9),
        "qn": t.qrandint(0, 100, 10),
        "ln": t.lograndint(1, 1000),
        "act": t.choice(["relu", "gelu", "tanh"]),
        "grid": t.grid_search([1, 2, 3]),
        "nested": {"u": t.uniform(-1.0, 1.0),
                   "dep": t.sample_from(lambda spec: spec.config.grid * 2)},
    }


@pytest.mark.parametrize("seed", [0, 7])
def test_variants_and_samples_equal_reference(seed):
    got = list(generate_variants(_space(tune), np.random.default_rng(seed)))
    want = list(jgenerate(_space(jtune), np.random.default_rng(seed)))
    assert got == want and len(got) == 3
    g = BasicVariantGenerator(_space(tune), num_samples=4, seed=seed)
    j = jtune.BasicVariantGenerator(_space(jtune), num_samples=4, seed=seed)
    sug = [g.suggest(f"t{i}") for i in range(13)]
    assert sug == [j.suggest(f"t{i}") for i in range(13)]
    assert sug[-1] is tune.Searcher.FINISHED
    for name in ("uniform", "loguniform", "randint", "qrandint"):
        args = (1, 50) if "int" in name else (1e-3, 2.0)
        if name == "qrandint":
            args = (0, 100, 5)
        a = getattr(tune, name)(*args)
        b = getattr(jtune, name)(*args)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [a.sample(ra) for _ in range(50)] == [
            b.sample(rb) for _ in range(50)]


def _bowl(config):
    return (config["x"] - 0.3) ** 2 + (config["y"] + 0.5) ** 2 + (
        0.1 if config["c"] == "b" else 0.0)


def _search_space(t):
    return {"x": t.uniform(-2.0, 2.0), "y": t.loguniform(1e-2, 2.0),
            "k": t.randint(1, 6), "c": t.choice(["a", "b"])}


def test_tpe_suggestions_equal_reference():
    p = tune.TPESearch(_search_space(tune), metric="loss", mode="min",
                       num_samples=30, n_startup_trials=6, seed=3)
    j = jtune.TPESearch(_search_space(jtune), metric="loss", mode="min",
                        num_samples=30, n_startup_trials=6, seed=3)
    for i in range(31):
        a, b = p.suggest(f"t{i}"), j.suggest(f"t{i}")
        assert a == b, i
        if a is None or a is tune.Searcher.FINISHED:
            break
        loss = _bowl(a)
        p.on_trial_complete(f"t{i}", {"loss": loss})
        j.on_trial_complete(f"t{i}", {"loss": loss})
    assert i == 30


def test_bohb_suggestions_equal_reference():
    kw = dict(metric="loss", mode="min", num_samples=24, seed=5)
    p = tune.BOHBSearch(_search_space(tune), **kw)
    j = jtune.BOHBSearch(_search_space(jtune), **kw)
    for i in range(24):
        a, b = p.suggest(f"t{i}"), j.suggest(f"t{i}")
        assert a == b, i
        for it in (1, 3, 9)[: 1 + i % 3]:
            r = {"loss": _bowl(a) / it, "training_iteration": it}
            p.on_trial_result(f"t{i}", r)
            j.on_trial_result(f"t{i}", r)
        p.on_trial_complete(f"t{i}", r)
        j.on_trial_complete(f"t{i}", r)


def _simulate(mod_trial, mod_ts, sched, deltas, max_t=12):
    """Drive `sched` as the controller would, with trials whose value
    grows by `delta` an iteration; returns every decision, exploit and
    stop in order."""
    trials = [mod_trial.Trial(f"trial_{i:05d}", {"delta": d})
              for i, d in enumerate(deltas)]
    values = {t.trial_id: 0.0 for t in trials}
    log = []
    for t in trials:
        sched.on_trial_add(t)
    for _round in range(4 * max_t):
        live = [t for t in trials if not t.is_finished]
        if not live:
            break
        for t in list(live):
            if t.status not in (mod_trial.RUNNING, mod_trial.PENDING):
                continue
            t.status = mod_trial.RUNNING
            t.iteration += 1
            values[t.trial_id] += t.config["delta"]
            result = {"value": values[t.trial_id],
                      "training_iteration": t.iteration}
            t.last_result = {**t.last_result, **result}
            t.results.append(result)
            t.tune_trials = trials
            if t.iteration >= max_t:
                t.status = mod_trial.TERMINATED
                sched.on_trial_complete(t, result)
                log.append((t.trial_id, t.iteration, "done"))
                continue
            decision = sched.on_trial_result(t, result)
            log.append((t.trial_id, t.iteration, decision))
            exploit = getattr(sched, "pending_exploits", {}).pop(
                t.trial_id, None)
            if exploit is not None:
                src, cfg = exploit
                log.append(("exploit", t.trial_id, src, sorted(cfg.items())))
                t.config = cfg
                values[t.trial_id] = values[src]
            elif decision == mod_ts.STOP:
                t.status = mod_trial.TERMINATED
                sched.on_trial_complete(t, result)
            elif decision == mod_ts.PAUSE:
                t.status = mod_trial.PAUSED
        for tid in getattr(sched, "pop_trials_to_stop", lambda: [])():
            t = next(x for x in trials if x.trial_id == tid)
            if not t.is_finished:
                t.status = mod_trial.TERMINATED
                sched.on_trial_complete(t, t.last_result)
                log.append((tid, t.iteration, "stopped"))
        while True:
            c = sched.choose_trial_to_run(
                [t for t in trials if not t.is_finished])
            if c is None or c.status == mod_trial.RUNNING:
                break
            c.status = mod_trial.RUNNING
            log.append((c.trial_id, c.iteration, "resumed"))
    return log


SCHEDULERS = {
    "asha": lambda m: m.ASHAScheduler(metric="value", mode="max", max_t=12,
                                      grace_period=2, reduction_factor=2),
    "hyperband": lambda m: m.HyperBandScheduler(
        metric="value", mode="max", max_t=9, reduction_factor=3),
    "median": lambda m: m.MedianStoppingRule(
        metric="value", mode="max", grace_period=2, min_samples_required=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="value", mode="max", perturbation_interval=2,
        hyperparam_mutations={"delta": m.uniform(0.5, 3.0)}, seed=0),
    "pb2": lambda m: m.PB2(metric="value", mode="max",
                           perturbation_interval=2,
                           hyperparam_bounds={"delta": (0.5, 3.0)}, seed=0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_equal_reference(name):
    deltas = [2.0, 1.0, 0.2, 0.1, 0.01, 1.5, 0.7, 3.0]
    got = _simulate(ptrial, pts, SCHEDULERS[name](tune), deltas)
    want = _simulate(jtrial, jts, SCHEDULERS[name](jtune), deltas)
    assert got == want
    decisions = {entry[2] for entry in got if len(entry) == 3}
    if name in ("asha", "median"):
        assert pts.STOP in decisions
    if name == "hyperband":
        assert pts.PAUSE in decisions
    if name in ("pbt", "pb2"):
        assert any(entry[0] == "exploit" for entry in got)
