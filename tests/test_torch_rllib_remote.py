"""ray_tpu_torch.rllib's remote paths against ray_tpu.rllib's, on the
port's runtime (CPU; a fake node of two GPUs for the pinning cases):
``test_rllib.py``'s ``ray_start`` cases mirrored (remote runners, the
multi-learner allreduce, IMPALA's async re-arm, PPO under Tune, the
filter merge, IMPALA's async filter sync),
``test_rllib_offpolicy.py::test_tpe_searcher_optimizes``, and the
multi-agent remote group.

Parity: two learners' update from given weights and one batch against
the JAX learner's split-phase functions (``_build_grads`` /
``_build_apply``) on the same strided shards, averaged in numpy (one
minibatch covering each shard, so the learners' shuffles cannot matter;
ROADMAP.md §C), at ``test_torch_rllib_algorithms.py``'s tolerances:
parameters within 1e-6 absolute and metrics 1e-4 relative, as its update
test holds them; the first moments, a weighted mean of gradients with
weights under 1, at its gradients' tolerance (1e-4 relative, 1e-7
absolute): each learner's gradients are sums in another order than
XLA's, and their average carries that rounding into the moments."""

import os
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.env.jax_env import CartPole as JCartPole
from ray_tpu_torch.accelerators import gpu as gpu_mod
from ray_tpu_torch.rllib import (IMPALAConfig, MultiAgentPPOConfig,
                                 PPOConfig, SingleAgentEnvRunner)
from ray_tpu_torch.rllib.algorithms import appo, ppo
from ray_tpu_torch.rllib.core.learner import LearnerGroup, shard_indices
from ray_tpu_torch.rllib.core.rl_module import params_from_flax
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.torch_env import CartPole


@pytest.fixture(scope="module")
def ray_start():
    mp = pytest.MonkeyPatch()
    mp.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    mp.setattr(gpu_mod, "_NODE_VISIBLE", None)
    rt.init(num_cpus=8, num_gpus=2)
    yield rt
    rt.shutdown()
    mp.undo()


def _cpu(cfg):
    return cfg.resources(device="cpu")


# ------------------------------------------------------------ distributed

def test_ppo_remote_env_runners(ray_start):
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=32)
                .training(minibatch_size=64, num_epochs=2)).build()
    m = algo.train()
    assert m["num_env_steps_sampled"] == 2 * 4 * 32
    m = algo.train()
    assert np.isfinite(m["learner/total_loss"])
    assert [d["device"] for d in algo.env_runner_group.device_info()] == [
        "cpu", "cpu"]
    algo.stop()


def test_ppo_multi_learner_allreduce(ray_start):
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=8,
                             rollout_fragment_length=32)
                .training(minibatch_size=128, num_epochs=1)
                .learners(num_learners=2)).build()
    algo.train()
    m2 = algo.train()
    assert np.isfinite(m2["learner/total_loss"])
    assert m2["num_env_steps_sampled_lifetime"] == 2 * 8 * 32
    # every learner holds the same state after the allreduced steps
    grp = algo.learner_group
    s0, s1 = rt.get([a.get_state.remote() for a in grp._actors])
    for k in s0["params"]:
        assert np.array_equal(s0["params"][k], s1["params"][k]), k
    # 128 rows a shard, one minibatch of 128, one epoch: one step a train
    assert s0["opt_state"]["count"] == s1["opt_state"]["count"] == 2
    algo.stop()


def test_impala_async_remote_runners(ray_start):
    algo = _cpu(IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=32)).build()
    for _ in range(3):
        m = algo.train()
    assert np.isfinite(m["learner/total_loss"])
    assert m["num_env_steps_sampled_lifetime"] == 3 * 4 * 32
    # one sample in flight per runner while the learner steps
    assert len(algo.env_runner_group._inflight) == 2
    algo.stop()


@pytest.mark.parametrize("config_cls", [IMPALAConfig, appo.APPOConfig],
                         ids=["impala", "appo"])
def test_async_algorithms_with_two_learners(ray_start, config_cls):
    algo = _cpu(config_cls().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=16)
                .learners(num_learners=2)).build()
    for _ in range(2):
        m = algo.train()
    assert np.isfinite(m["learner/total_loss"])
    assert len(algo.learner_group.device_info()) == 2
    algo.stop()


# ---------------------------------------------------------- tune integration

def test_ppo_under_tune(ray_start):
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPO

    results = tune.Tuner(
        PPO,
        param_space={
            "env": "CartPole-v1",
            "device": "cpu",
            "num_envs_per_env_runner": 4,
            "rollout_fragment_length": 16,
            "minibatch_size": 32,
            "num_epochs": 1,
            "lr": tune.grid_search([1e-3, 3e-4]),
        },
        tune_config=tune.TuneConfig(stop={"training_iteration": 2}),
    ).fit()
    assert len(results) == 2
    assert all(np.isfinite(r.metrics["learner/total_loss"])
               for r in results)


def test_tpe_searcher_optimizes(ray_start):
    """TPE beats random given the same budget on a smooth 2-d bowl."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TPESearch

    def objective(config):
        x, y = config["x"], config["y"]
        tune.report({"loss": (x - 0.3) ** 2 + (y + 0.5) ** 2})

    space = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}
    tpe = TPESearch(space, metric="loss", mode="min", num_samples=40,
                    n_startup_trials=8, seed=0)
    # max_concurrent_trials=1 pins trial COMPLETION order, which pins the
    # searcher's RNG consumption
    result = tune.run(objective, config=space, search_alg=tpe,
                      metric="loss", mode="min", verbose=0,
                      max_concurrent_trials=1)
    best_tpe = result.get_best_result().metrics["loss"]
    assert best_tpe < 0.5, best_tpe
    losses = [t.last_result["loss"] for t in result._trials
              if t.last_result and "loss" in t.last_result]
    assert min(losses[8:]) < max(min(losses[:8]), 0.25), losses


# ------------------------------------------------- mean-std obs filter

def test_mean_std_filter_group_merge(ray_start):
    """Remote runners' filter states merge on sync_weights (weighted
    Welford combine) and every runner receives the merged state."""
    grp = EnvRunnerGroup("Pendulum-v1", num_env_runners=2,
                         num_envs_per_runner=2, rollout_length=16,
                         obs_filter="mean_std", device="cpu")
    grp.sample()
    grp.sync_weights(grp.get_weights())
    states = rt.get([r.get_filter_state.remote() for r in grp._remote])
    c0, m0, s0 = states[0]
    c1, m1, s1 = states[1]
    assert c0 == c1 and np.allclose(m0, m1) and np.allclose(s0, s1)
    assert c0 == 2 * 16 * 2        # both runners' obs merged EXACTLY once
    # idempotent: syncing again without sampling must not grow counts
    grp.sync_weights(grp.get_weights())
    states2 = rt.get([r.get_filter_state.remote() for r in grp._remote])
    assert states2[0][0] == c0
    grp.stop()


def test_impala_async_filter_sync(ray_start):
    """IMPALA's async re-arm path merges per-runner filter deltas into
    the group global (sync_weights never runs on this path)."""
    algo = _cpu(IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=16,
                             observation_filter="mean_std")
                .training(minibatch_size=64, num_epochs=1)).build()
    algo.train()
    algo.train()
    grp = algo.env_runner_group
    assert grp._filter_global is not None
    assert grp._filter_global[0] >= 4 * 16   # at least one batch merged
    algo.stop()


def test_remote_runners_seeded_as_reference(ray_start):
    """Runner i samples with seed + 1000 * (i + 1), as the reference's
    group seeds it: its first fragment is bit-equal to a local runner's
    of that seed."""
    grp = EnvRunnerGroup("CartPole-v1", num_env_runners=2,
                         num_envs_per_runner=3, rollout_length=8, seed=5,
                         device="cpu")
    weights = grp.get_weights()
    got = rt.get([r.sample.remote() for r in grp._remote])
    for i, res in enumerate(got):
        local = SingleAgentEnvRunner("CartPole-v1", 3, 8, 5 + 1000 * (i + 1),
                                     device="cpu")
        if i == 0:
            for k, v in local.get_weights().items():
                assert torch.equal(v, weights[k]), k
        want = local.sample()
        for k, v in want["batch"].items():
            assert np.array_equal(res["batch"][k], v), (i, k)
        assert res["stats"] == want["stats"]
    grp.stop()


# ------------------------------------------------------------ multi-agent

def _rps(**kw):
    return _cpu(MultiAgentPPOConfig().environment("RockPaperScissors")
                .multi_agent(policies={"a": None, "b": None},
                             policy_mapping_fn=lambda aid: (
                                 "a" if aid == "player_0" else "b"))
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=16, **kw)
                .training(minibatch_size=32, num_epochs=1)
                .debugging(seed=0))


def test_multi_agent_remote_runner_group(ray_start):
    algo = _rps(num_env_runners=2).learners(num_learners=2).build()
    m = algo.train()
    assert m["num_env_steps_sampled"] == 2 * 4 * 16
    assert m["num_agent_steps_sampled"] == 2 * 2 * 4 * 16
    assert set(m["agent_episode_returns"]) == {"player_0", "player_1"}
    assert np.isfinite(m["learner/a/total_loss"])
    # the runners hold the learners' weights after the sync
    w = algo.env_runner_group.get_weights()
    for pid, lr in algo.learners.items():
        for k, v in lr.get_weights().items():
            assert torch.equal(torch.as_tensor(w[pid][k]), v), (pid, k)
    algo.stop()


# ----------------------------------------------------- two-learner parity

def _ppo_minibatch(rng, n):
    f = np.float32
    return dict(obs=rng.normal(size=(n, 4)).astype(f),
                logp=(rng.normal(size=n) * 0.3 - 0.7).astype(f),
                advantages=rng.normal(size=n).astype(f),
                value_targets=rng.normal(size=n).astype(f),
                actions=rng.integers(0, 2, n).astype(np.int32))


def _by_name(module, flax_tree):
    tree = flax_tree.get("params", flax_tree)
    out = {}
    names = {id(p): n for n, p in module.named_parameters()}
    for name, layer, _ in module.flax_layers():
        out[names[id(layer.weight)]] = np.asarray(tree[name]["kernel"]).T
        out[names[id(layer.bias)]] = np.asarray(tree[name]["bias"])
    return out


def test_two_learner_update_matches_jax_split_phase(ray_start):
    jcfg, pcfg = jppo.PPOConfig(), PPOConfig()
    for c in (jcfg, pcfg):
        c.num_epochs, c.minibatch_size, c.lr = 2, 10 ** 9, 1e-3
    pcfg.device = "cpu"
    spec = CartPole().spec
    jl = jppo.PPOLearner(JCartPole().spec, jcfg)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jl.params))
    pl = ppo.PPOLearner(spec, pcfg, device="cpu")
    params_from_flax(pl.module, host)
    n, num = 97, 2
    batch = _ppo_minibatch(np.random.default_rng(4), n)
    shards = shard_indices(n, num)
    assert [list(s) for s in shards] == [list(range(0, n, 2)),
                                         list(range(1, n, 2))]
    # the JAX learner's split phase, the gradients averaged in numpy
    params, opt_state, auxes = jl.params, jl.opt_state, []
    for _ in range(2):
        outs = [jl._grads_jit(params, {k: v[s] for k, v in batch.items()})
                for s in shards]
        grads = jax.tree_util.tree_map(
            lambda *g: (np.asarray(g[0]) + np.asarray(g[1])) / np.float32(2),
            *[o[0] for o in outs])
        params, opt_state = jl._apply_jit(params, opt_state, grads)
        auxes.append([jax.device_get(o[1]) for o in outs])
    group = LearnerGroup(lambda d: ppo.PPOLearner(spec, pcfg, d),
                         num_learners=num, device="cpu")
    try:
        group.set_state(pl.get_state())
        metrics = group.update(batch)
        state = group.get_state()
        other = rt.get(group._actors[1].get_state.remote())
    finally:
        group.stop()
    for k in metrics:
        want = np.mean([np.mean([a[i][k] for a in auxes])
                        for i in range(num)])
        np.testing.assert_allclose(metrics[k], want, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert state["opt_state"]["count"] == 2
    want = _by_name(pl.module, jax.tree_util.tree_map(np.asarray, params))
    for name, v in state["params"].items():
        np.testing.assert_allclose(v, want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
        assert np.array_equal(v, other["params"][name]), name
    mu = _by_name(pl.module, jax.tree_util.tree_map(
        np.asarray, opt_state[1][0].mu))
    for name, v in state["opt_state"]["mu"].items():
        np.testing.assert_allclose(v, mu[name], rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def test_shard_indices_wrap_when_rows_are_fewer_than_learners():
    got = shard_indices(2, 3)
    assert [list(s) for s in got] == [[0], [1], [0]]


# ------------------------------------------------------- pins and CUDA


def _handle_of(pid):
    daemon = rt.current_runtime().head_daemon
    return next((h for h in daemon.workers.values() if h.pid == pid), None)


def _pinned_pids(n=6):
    @rt.remote(num_gpus=1)
    def pinned():
        time.sleep(0.05)
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    return rt.get([pinned.remote() for _ in range(n)], timeout=120)


def test_cpu_worker_that_initialized_cuda_gets_no_pin(ray_start):
    """A CPU task that initialized CUDA (here: torch reports it so) holds
    a context over every device; the daemon marks its worker and never
    hands it a GPU-pinned task after (on the card:
    ``test_torch_cuda_kernels.py::test_runtime_cpu_worker_that_used_the_card_gets_no_pin``)."""
    @rt.remote(num_cpus=1)
    def touch():
        import torch
        torch.cuda.is_initialized = lambda: True
        return os.getpid()

    pid = rt.get(touch.remote(), timeout=120)
    deadline = time.time() + 20
    while time.time() < deadline and (
            _handle_of(pid) is None or _handle_of(pid).gpu_pin != "*"):
        time.sleep(0.05)
    assert _handle_of(pid).gpu_pin == "*"
    got = _pinned_pids()
    assert all(p != pid for p, _ in got), (pid, got)
    assert {v for _, v in got} <= {"0", "1"}
