"""ray_tpu_torch.rllib's multi-agent path against ray_tpu.rllib's, on the
CPU: the eleven cases of ``tests/test_rllib_multiagent.py`` on the port
(same assertions; the port's modules own their parameters, so params
are read from the modules), plus parity with the JAX package:

- DualCartPole and RockPaperScissors step for step against the JAX envs
  (vmapped) from the same keys and actions: resets within an ulp (the
  same threefry bits; XLA's CPU backend fuses the uniform's scaling to
  +-0.05 into one fma), obs 1e-5 after 64 steps (float32 physics, XLA may
  fuse a multiply-add the port rounds twice; ``test_torch_rllib_env.py``),
  rewards and dones equal;
- MultiRLModule's forward on flax parameters: 1e-5 relative, and its
  exploration from one key: the JAX module's sample;
- the runner's first fragment against the JAX runner's on the same
  weights (agent i's keys ``fold_in(act_key, i)``): actions and dones
  equal, obs 1e-5, per-module batches regrouped alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.core.multi_rl_module import MultiRLModule as JMulti
from ray_tpu.rllib.env import multi_agent_env as jma
from ray_tpu.rllib.env.multi_agent_env_runner import (
    MultiAgentEnvRunner as JRunner)
from ray_tpu_torch.ops import threefry as tf
from ray_tpu_torch.rllib import (DualCartPole, MultiAgentEnvRunner,
                                 MultiAgentPPOConfig, MultiRLModule,
                                 RockPaperScissors)
from ray_tpu_torch.rllib.core.rl_module import params_from_flax
from ray_tpu_torch.rllib.env.multi_agent_env import (MultiAgentJaxEnv,
                                                     MultiAgentTorchEnv)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    pk = tf.split(tf.prng_key(torch.tensor(seed)), n)
    return jk, pk


def _cpu(cfg):
    return cfg.resources(device="cpu")


def _one(a):
    """A one-env batch's tensor."""
    return torch.as_tensor(np.asarray(a))[None]


# ---------------------------------------------------------------- envs

def test_dual_cartpole_shapes_and_shared_done():
    env = DualCartPole(max_episode_steps=8)
    state, obs = env.reset(tf.split(tf.prng_key(torch.tensor(0)), 1))
    assert set(obs) == {"cart_0", "cart_1"}
    assert obs["cart_0"].shape == (1, 4)
    done = False
    for _ in range(8):
        state, obs, rewards, done = env.step(
            state, {"cart_0": _one(0), "cart_1": _one(1)}, None)
        assert float(rewards["cart_0"][0]) == 1.0
    assert bool(done[0])  # truncated at the joint clock


def test_rps_zero_sum():
    env = RockPaperScissors(episode_len=4)
    state, obs = env.reset(tf.split(tf.prng_key(torch.tensor(0)), 1))
    # paper (1) beats rock (0)
    state, obs, rewards, done = env.step(
        state, {"player_0": _one(1), "player_1": _one(0)}, None)
    assert float(rewards["player_0"][0]) == 1.0
    assert float(rewards["player_1"][0]) == -1.0
    # opponent's move is observable next step
    assert int(torch.argmax(obs["player_0"][0])) == 0
    assert int(torch.argmax(obs["player_1"][0])) == 1


@pytest.mark.parametrize("name", ["DualCartPole", "RockPaperScissors"])
def test_envs_step_for_step_match_jax(name):
    """64 steps of 16 envs from the same reset keys and actions, with
    the runner's auto-reset of finished envs."""
    jenv, penv = jma.make_multi_agent_env(name), \
        {"DualCartPole": DualCartPole,
         "RockPaperScissors": RockPaperScissors}[name]()
    assert isinstance(penv, MultiAgentTorchEnv) and \
        MultiAgentJaxEnv is MultiAgentTorchEnv
    B = 16
    jk, pk = _keys(1, B)
    js, jo = jax.vmap(jenv.reset)(jk)
    ps, po = penv.reset(pk)
    for aid in penv.agents:
        np.testing.assert_allclose(po[aid].numpy(), np.asarray(jo[aid]),
                                   rtol=0, atol=1e-8)
    rng = np.random.default_rng(2)
    n_act = penv.specs[penv.agents[0]].num_actions
    jstep = jax.jit(jax.vmap(jenv.step))
    dones = 0
    for t in range(64):
        acts = {aid: rng.integers(0, n_act, B).astype(np.int32)
                for aid in penv.agents}
        js, jo, jr, jd = jstep(js, {k: jnp.asarray(v)
                                    for k, v in acts.items()},
                               jax.random.split(jax.random.PRNGKey(t), B))
        ps, po, pr, pd = penv.step(ps, {k: torch.from_numpy(v)
                                        for k, v in acts.items()}, None)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        for aid in penv.agents:
            np.testing.assert_allclose(po[aid].numpy(), np.asarray(jo[aid]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(pr[aid].numpy(),
                                          np.asarray(jr[aid]))
        # restart finished envs from fresh resets, as the runner does
        rk, rpk = _keys(100 + t, B)
        jrs, jro = jax.vmap(jenv.reset)(rk)
        prs, pro = penv.reset(rpk)
        d = np.array(jd)
        dones += int(d.sum())
        sel = lambda a, b: jnp.where(
            jnp.reshape(jnp.asarray(d), (B,) + (1,) * (a.ndim - 1)), a, b)
        js = jax.tree_util.tree_map(sel, jrs, js)
        jo = jax.tree_util.tree_map(sel, jro, jo)
        dt = torch.from_numpy(d)
        psel = lambda a, b: torch.where(
            dt.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        ps = (tuple(psel(a, b) for a, b in zip(prs, ps))
              if isinstance(ps, tuple) else psel(prs, ps))
        po = {aid: psel(pro[aid], po[aid]) for aid in penv.agents}
    assert dones > 0


# ------------------------------------------------------------- module

def test_multi_rl_module_independent_params():
    env = DualCartPole()
    mm = MultiRLModule.from_specs(
        {"p0": env.specs["cart_0"], "p1": env.specs["cart_1"]})
    mm.init_parameters(0)
    params = mm.get_weights()
    assert set(params) == {"p0", "p1"}
    # independent initializations: some kernel must differ (biases are
    # zero-init, identical by construction)
    assert any(not torch.allclose(params["p0"][k], params["p1"][k])
               for k in params["p0"])
    obs = torch.zeros(3, 4)
    with torch.no_grad():
        a, logp, vf = mm.forward_exploration(
            "p0", obs, tf.prng_key(torch.tensor(1)))
    assert a.shape == (3,) and vf.shape == (3,)


def test_multi_rl_module_forward_matches_jax():
    env = DualCartPole()
    specs = {"p0": env.specs["cart_0"], "p1": env.specs["cart_1"]}
    jmm = JMulti.from_specs(specs)
    jparams = jmm.init(jax.random.PRNGKey(4))
    mm = MultiRLModule.from_specs(specs)
    for mid in specs:
        params_from_flax(mm[mid], _np(jparams[mid]))
    obs = np.random.default_rng(3).normal(size=(32, 4)).astype(np.float32)
    for mid in specs:
        want = jmm.forward_train(mid, jparams, obs)
        got = mm.forward_train(mid, torch.from_numpy(obs))
        for k in ("action_dist_inputs", "vf"):
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{mid} {k}")
        ja, jlp, jv = jmm.forward_exploration(mid, jparams, obs,
                                              jax.random.PRNGKey(6))
        with torch.no_grad():
            pa, plp, pv = mm.forward_exploration(
                mid, torch.from_numpy(obs), tf.prng_key(torch.tensor(6)))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            mm.forward_inference(mid, torch.from_numpy(obs)).numpy(),
            np.asarray(jmm.forward_inference(mid, jparams, obs)))


# ------------------------------------------------------------- runner

def _runner(*a, **kw):
    return MultiAgentEnvRunner(*a, device="cpu", **kw)


def test_multi_agent_env_runner_batches():
    r = _runner(
        "DualCartPole", lambda aid: {"cart_0": "p0", "cart_1": "p1"}[aid],
        num_envs=4, rollout_length=16, seed=0)
    out = r.sample()
    assert set(out["batches"]) == {"p0", "p1"}
    b = out["batches"]["p0"]
    assert b["obs"].shape == (16, 4, 4)
    assert b["actions"].shape == (16, 4)
    assert b["final_vf"].shape == (4,)
    stats = out["stats"]
    assert stats["env_steps"] == 64
    assert stats["agent_steps"] == 128
    assert set(stats["agent_episode_returns"]) == {"cart_0", "cart_1"}


def test_multi_agent_runner_shared_policy_self_play():
    """Self-play: both agents map to ONE module; streams concatenate."""
    r = _runner("RockPaperScissors", lambda aid: "shared",
                num_envs=4, rollout_length=8, seed=0)
    out = r.sample()
    assert set(out["batches"]) == {"shared"}
    b = out["batches"]["shared"]
    assert b["obs"].shape == (8, 8, 3)      # 4 envs x 2 agents
    # zero-sum: the shared batch's rewards sum to ~0
    assert abs(float(b["rewards"].sum())) < 1e-5


@pytest.mark.parametrize("name,mapping", [
    ("DualCartPole", {"cart_0": "p0", "cart_1": "p1"}),
    ("RockPaperScissors", {"player_0": "shared", "player_1": "shared"}),
])
def test_runner_fragment_matches_jax(name, mapping):
    """The first two fragments of the port's runner against the JAX
    runner's on the JAX runner's weights."""
    fn = lambda aid: mapping[aid]
    jr = JRunner(name, fn, num_envs=8, rollout_length=40, seed=3)
    pr = _runner(name, fn, num_envs=8, rollout_length=40, seed=3)
    for mid in pr.module_specs:
        params_from_flax(pr.multi_module[mid], _np(jr.params[mid]))
    for _ in range(2):
        jo, po = jr.sample(), pr.sample()
        assert po["stats"] == jo["stats"] or name == "DualCartPole"
        for k in ("num_episodes", "env_steps", "agent_steps"):
            assert po["stats"][k] == jo["stats"][k], k
        for mid in jo["batches"]:
            jb, pb = jo["batches"][mid], po["batches"][mid]
            assert sorted(pb) == sorted(jb)
            for k in ("actions", "dones", "rewards"):
                np.testing.assert_array_equal(pb[k], np.asarray(jb[k]),
                                              err_msg=f"{mid} {k}")
            for k in ("obs", "final_obs"):
                np.testing.assert_allclose(pb[k], np.asarray(jb[k]), rtol=0,
                                           atol=1e-5, err_msg=f"{mid} {k}")
            for k in ("logp", "vf", "final_vf"):
                np.testing.assert_allclose(pb[k], np.asarray(jb[k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{mid} {k}")


def test_runner_weights_roundtrip():
    r = _runner("DualCartPole", lambda aid: aid, num_envs=2,
                rollout_length=4)
    w = r.get_weights()
    assert set(w) == {"cart_0", "cart_1"}
    r.set_weights(w)


def test_mapping_fn_two_arg_reference_signature():
    # reference signature: policy_mapping_fn(agent_id, episode, **kw)
    def mapping(agent_id, episode, **kw):
        return "solo"
    r = _runner("RockPaperScissors", mapping, num_envs=2, rollout_length=4)
    assert set(r.module_specs) == {"solo"}


# ----------------------------------------------------------- learning

def test_multi_agent_ppo_two_policies_learn():
    """PPO with two separate policies on DualCartPole, BOTH improving
    (each agent's return is bounded by the episode surviving, which
    needs both poles up)."""
    config = _cpu(
        MultiAgentPPOConfig()
        .environment("DualCartPole")
        .multi_agent(
            policies={"p0": None, "p1": None},
            policy_mapping_fn=lambda aid: {"cart_0": "p0",
                                           "cart_1": "p1"}[aid])
        .env_runners(num_envs_per_env_runner=16,
                     rollout_fragment_length=128)
        .training(lr=3e-4, num_epochs=4, minibatch_size=256)
        .debugging(seed=0))
    algo = config.build()
    first = algo.train()["agent_episode_returns"]
    best = {aid: -np.inf for aid in ("cart_0", "cart_1")}
    for _ in range(24):
        rets = algo.train()["agent_episode_returns"]
        for aid in best:
            best[aid] = max(best[aid], rets.get(aid, -np.inf))
        if all(v > 60 for v in best.values()):
            break
    algo.cleanup()
    assert all(v > 60 for v in best.values()), (
        f"multi-agent PPO failed to learn: first={first} best={best}")
    assert all(best[a] > first.get(a, 0) for a in best)


def _rps_config():
    return _cpu(
        MultiAgentPPOConfig()
        .environment("RockPaperScissors")
        .multi_agent(policies={"a": None, "b": None},
                     policy_mapping_fn=lambda aid: {"player_0": "a",
                                                    "player_1": "b"}[aid])
        .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=8)
        .training(num_epochs=1, minibatch_size=32))


def test_multi_agent_ppo_checkpoint_roundtrip():
    config = _rps_config()
    algo = config.build()
    algo.train()
    state = algo.save_checkpoint()
    assert set(state["learners"]) == {"a", "b"}

    algo2 = config.build()
    algo2.load_checkpoint(state)
    w1 = algo.learners["a"].get_weights()
    w2 = algo2.learners["a"].get_weights()
    for k in w1:
        np.testing.assert_allclose(w1[k].numpy(), w2[k].numpy())
    # the runner samples with the restored weights
    rw = algo2.env_runner_group.get_weights()["a"]
    for k in w1:
        np.testing.assert_array_equal(rw[k].numpy(), w1[k].numpy())
    algo.cleanup()
    algo2.cleanup()


def test_per_policy_config_overrides():
    config = _cpu(
        MultiAgentPPOConfig()
        .environment("RockPaperScissors")
        .multi_agent(
            policies={"big": {"model_config": {"hiddens": (128, 128)}},
                      "small": {"model_config": {"hiddens": (16,)}}},
            policy_mapping_fn=lambda aid: {"player_0": "big",
                                           "player_1": "small"}[aid]))
    algo = config.build()
    nb = sum(p.numel() for p in algo.learners["big"].params)
    ns = sum(p.numel() for p in algo.learners["small"].params)
    assert nb > ns
    algo.cleanup()


def test_same_arch_policies_start_distinct():
    """Per-policy learners must NOT start byte-identical (distinct seeds
    derived per policy id)."""
    algo = _rps_config().build()
    wa = algo.learners["a"].get_weights()
    wb = algo.learners["b"].get_weights()
    assert any(not torch.allclose(wa[k], wb[k]) for k in wa)
    algo.cleanup()
