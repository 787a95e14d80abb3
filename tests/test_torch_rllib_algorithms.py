"""ray_tpu_torch.rllib's learners and algorithms against ray_tpu.rllib's,
on the CPU: the PPO, IMPALA, APPO and DQN losses and gradients on one
seeded minibatch, one full ``Learner.update`` (the optimizer's order of
operations), the replay buffer and the checkpoint round trip. Float32.
(Remote runners and several learners: ``test_torch_rllib_remote.py``.)

Tolerances: losses 1e-5 relative and gradients 1e-4 relative (plus 1e-7
absolute for elements that cancel to ~0): the same sums in another
order. One update of 2 epochs with the minibatch covering the batch
(so the learners' different shuffles cannot matter; ROADMAP.md §C):
parameters within 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.env.jax_env import CartPole as JCartPole
from ray_tpu.rllib.env.jax_env import Pendulum as JPendulum
from ray_tpu.rllib.utils.replay_buffers import ReplayBuffer as JReplay
from ray_tpu_torch.rllib import (DQNConfig, IMPALAConfig, PPOConfig,
                                 ReplayBuffer)
from ray_tpu_torch.rllib.algorithms import appo, dqn, impala, ppo
from ray_tpu_torch.rllib.core.rl_module import params_from_flax
from ray_tpu_torch.rllib.env.torch_env import CartPole, Pendulum


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _pair(jcls, pcls, jcfg, pcfg, jenv, penv):
    """A JAX learner and a port learner on the JAX one's parameters."""
    jl = jcls(jenv.spec, jcfg)
    pl = pcls(penv.spec, pcfg, device="cpu")
    params_from_flax(pl.module, _np(jl.params))
    return jl, pl


def _grads_by_name(module, flax_grads):
    """A flax gradient tree in the port module's parameter names and
    layouts."""
    tree = flax_grads.get("params", flax_grads)
    out = {}
    names = {id(p): n for n, p in module.named_parameters()}
    for name, layer, _ in module.flax_layers():
        k = np.asarray(tree[name]["kernel"])
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        out[names[id(layer.weight)]] = k
        out[names[id(layer.bias)]] = np.asarray(tree[name]["bias"])
    return out


def _check_loss_and_grads(pl, mb, jloss, jgrads, jaux=None):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in mb.items()}
    loss, aux = pl.compute_loss(tb)
    grads = torch.autograd.grad(loss, pl.params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _grads_by_name(pl.module, jgrads)
    for (name, _), g in zip(pl.module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    for k, v in (jaux or {}).items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _ppo_minibatch(rng, n, obs_dim, discrete):
    f = np.float32
    mb = dict(obs=rng.normal(size=(n, obs_dim)).astype(f),
              logp=(rng.normal(size=n) * 0.3 - 0.7).astype(f),
              advantages=rng.normal(size=n).astype(f),
              value_targets=rng.normal(size=n).astype(f))
    mb["actions"] = (rng.integers(0, 2, n).astype(np.int32) if discrete
                     else rng.normal(size=(n, 1)).astype(f))
    return mb


@pytest.mark.parametrize("discrete", [True, False])
def test_ppo_loss_and_grads_match_jax(discrete):
    jenv, penv = ((JCartPole(), CartPole()) if discrete
                  else (JPendulum(), Pendulum()))
    jl, pl = _pair(jppo.PPOLearner, ppo.PPOLearner, jppo.PPOConfig(),
                   PPOConfig(), jenv, penv)
    mb = _ppo_minibatch(np.random.default_rng(0), 64, jenv.spec.obs_dim,
                        discrete)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jl.compute_loss, has_aux=True))(jl.params, mb)
    _check_loss_and_grads(pl, mb, jloss, jgrads, jaux)


def _impala_minibatch(rng, b, T):
    f = np.float32
    return dict(obs=rng.normal(size=(b, T, 4)).astype(f),
                actions=rng.integers(0, 2, (b, T)).astype(np.int32),
                logp=(rng.normal(size=(b, T)) * 0.3 - 0.7).astype(f),
                rewards=rng.normal(size=(b, T)).astype(f),
                dones=rng.random((b, T)) < 0.1,
                vf=rng.normal(size=(b, T)).astype(f),
                final_vf=rng.normal(size=b).astype(f),
                final_obs=rng.normal(size=(b, 4)).astype(f))


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_appo_loss_and_grads_match_jax(algo):
    if algo == "impala":
        jcfg, pcfg = jimpala.IMPALAConfig(), IMPALAConfig()
        classes = (jimpala.IMPALALearner, impala.IMPALALearner)
    else:
        jcfg, pcfg = jappo.APPOConfig(), appo.APPOConfig()
        classes = (jappo.APPOLearner, appo.APPOLearner)
    jl, pl = _pair(*classes, jcfg, pcfg, JCartPole(), CartPole())
    mb = _impala_minibatch(np.random.default_rng(1), 8, 16)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jl.compute_loss, has_aux=True))(jl.params, mb)
    _check_loss_and_grads(pl, mb, jloss, jgrads, jaux)


def _jax_td_loss(jl, params, target_params, batch):
    """The JAX DQNLearner's TD loss (dqn.py ``td_update``'s loss_fn),
    written out over its module: the learner jits it together with the
    optimizer, so the test holds this copy to the learner's own loss
    below."""
    module, gamma = jl.module, jl._gamma
    q = module.apply(params, batch["obs"])["action_dist_inputs"]
    q_sa = jnp.take_along_axis(
        q, batch["actions"][:, None].astype(jnp.int32), axis=-1)[:, 0]
    q_next_t = module.apply(target_params,
                            batch["next_obs"])["action_dist_inputs"]
    a_star = jnp.argmax(module.apply(
        params, batch["next_obs"])["action_dist_inputs"], axis=-1)
    v_next = jnp.take_along_axis(q_next_t, a_star[:, None], axis=-1)[:, 0]
    target = (batch["rewards"] + gamma * (1.0 - batch["dones"])
              * jax.lax.stop_gradient(v_next))
    td = q_sa - jax.lax.stop_gradient(target)
    loss = jnp.mean(td ** 2)
    return loss, {"total_loss": loss, "qf_mean": jnp.mean(q_sa),
                  "td_error_abs": jnp.mean(jnp.abs(td))}


def _dqn_batch(rng, n):
    f = np.float32
    return dict(obs=rng.normal(size=(n, 4)).astype(f),
                actions=rng.integers(0, 2, n).astype(np.int32),
                rewards=rng.normal(size=n).astype(f),
                dones=(rng.random(n) < 0.2).astype(f),
                next_obs=rng.normal(size=(n, 4)).astype(f))


def _dqn_cfgs():
    jcfg, pcfg = jdqn.DQNConfig(), DQNConfig()
    for c, q in ((jcfg, jdqn.QModule), (pcfg, dqn.QModule)):
        c.module_class, c.model_config = q, {"epsilon": 0.1}
    return jcfg, pcfg


def test_dqn_td_loss_and_grads_match_jax():
    jl, pl = _pair(jdqn.DQNLearner, dqn.DQNLearner, *_dqn_cfgs(),
                   JCartPole(), CartPole())
    rng = np.random.default_rng(2)
    # a target network apart from the online one
    target = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        _np(jl.params))
    jl.target_params = target
    params_from_flax(pl.target, target)
    batch = _dqn_batch(rng, 64)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_td_loss(jl, p, target, batch), has_aux=True))(
            jl.params)
    _check_loss_and_grads(pl, batch, jloss, jgrads, jaux)
    # the copy is the learner's own loss: its update reports it
    got = jl.update(batch)
    np.testing.assert_allclose(got["total_loss"], float(jloss), rtol=1e-6)
    pgot = pl.update(batch)
    np.testing.assert_allclose(pgot["total_loss"], float(jloss), rtol=1e-5)
    want = _grads_by_name(pl.module, _np(jl.params))
    for name, p in pl.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("discrete", [True, False])
def test_one_learner_update_matches_jax(discrete):
    """2 epochs, one minibatch covering the batch: two optimizer steps,
    each on the whole (reordered) batch."""
    jenv, penv = ((JCartPole(), CartPole()) if discrete
                  else (JPendulum(), Pendulum()))
    jcfg, pcfg = jppo.PPOConfig(), PPOConfig()
    for c in (jcfg, pcfg):
        c.num_epochs, c.minibatch_size, c.lr = 2, 10 ** 9, 1e-3
    jl, pl = _pair(jppo.PPOLearner, ppo.PPOLearner, jcfg, pcfg, jenv, penv)
    mb = _ppo_minibatch(np.random.default_rng(3), 96, jenv.spec.obs_dim,
                        discrete)
    jm = jl.update(mb)
    pm = pl.update(mb)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert pl.opt_state["count"] == 2
    want = _grads_by_name(pl.module, _np(jl.params))
    for name, p in pl.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    for side in ("mu", "nu"):
        want = _grads_by_name(pl.module,
                              _np(getattr(jl.opt_state[1][0], side)))
        for (name, _), m in zip(pl.module.named_parameters(),
                                pl.opt_state[side]):
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4,
                                       atol=1e-9, err_msg=f"{side} {name}")


def test_grad_clip_matches_optax_above_and_below_the_norm():
    """optax clips by max/norm only where the norm reaches max: a tiny
    clip scales every step, a huge one none."""
    for clip in (1e-3, 1e3):
        jcfg, pcfg = jppo.PPOConfig(), PPOConfig()
        for c in (jcfg, pcfg):
            c.num_epochs, c.minibatch_size, c.grad_clip = 1, 10 ** 9, clip
        jl, pl = _pair(jppo.PPOLearner, ppo.PPOLearner, jcfg, pcfg,
                       JCartPole(), CartPole())
        mb = _ppo_minibatch(np.random.default_rng(4), 32, 4, True)
        jl.update(mb)
        pl.update(mb)
        want = _grads_by_name(pl.module, _np(jl.opt_state[1][0].mu))
        # elements that cancel toward 0: 1e-5 of the tensor's largest
        for (name, _), m in zip(pl.module.named_parameters(),
                                pl.opt_state["mu"]):
            np.testing.assert_allclose(
                m.numpy(), want[name], rtol=1e-4,
                atol=1e-5 * np.abs(want[name]).max(), err_msg=name)


def test_replay_buffer_matches_jax_sample_for_sample():
    rng = np.random.default_rng(5)
    jb, pb = JReplay(capacity=100, seed=3), ReplayBuffer(capacity=100, seed=3)
    for n in (30, 50, 40, 120, 7):
        batch = {"x": rng.normal(size=(n, 3)).astype(np.float32),
                 "a": rng.integers(0, 4, n)}
        jb.add_batch(batch)
        pb.add_batch(batch)
        assert len(pb) == len(jb)
        for _ in range(3):
            js, ps = jb.sample(16), pb.sample(16)
            for k in js:
                np.testing.assert_array_equal(ps[k], js[k])
    with pytest.raises(ValueError, match="empty"):
        ReplayBuffer(4).sample(1)


def _small_ppo(**kw):
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16,
                         **kw)
            .training(minibatch_size=32, num_epochs=1)
            .resources(device="cpu").debugging(seed=0))


def test_checkpoint_round_trip():
    algo = _small_ppo(observation_filter="mean_std").build()
    algo.train()
    algo.train()
    ckpt = algo.save()
    state = ckpt["state"]["learner"]
    fresh = _small_ppo(observation_filter="mean_std").build()
    fresh.restore(ckpt)
    assert fresh._iteration == 2
    got = fresh.learner_group.get_state()
    for k, v in state["params"].items():
        np.testing.assert_array_equal(got["params"][k], v)
        np.testing.assert_array_equal(got["opt_state"]["mu"][k],
                                      state["opt_state"]["mu"][k])
    assert got["opt_state"]["count"] == state["opt_state"]["count"] > 0
    runner_w = fresh.env_runner_group.get_weights()
    for k, v in state["params"].items():
        np.testing.assert_array_equal(runner_w[k].numpy(), v)
    fs, fs0 = (fresh.env_runner_group.get_filter_state(),
               algo.env_runner_group.get_filter_state())
    assert fs[0] == fs0[0] == 2 * 4 * 16
    np.testing.assert_array_equal(fs[1], fs0[1])
    m = fresh.train()
    assert np.isfinite(m["learner/total_loss"])
    assert m["training_iteration"] == 3
    # DQN carries its target network and update count
    d = (DQNConfig().environment("CartPole-v1")
         .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16)
         .training(num_steps_before_learning=32, num_updates_per_iter=2,
                   target_network_update_freq=3)
         .resources(device="cpu").build())
    for _ in range(3):
        d.train()
    d2 = (DQNConfig().environment("CartPole-v1")
          .resources(device="cpu").build())
    d2.restore(d.save())
    assert d2.learner_group._local._updates == 6
    for a, b in zip(d2.learner_group._local.target.parameters(),
                    d.learner_group._local.target.parameters()):
        assert torch.equal(a, b)


def test_dqn_learns_cartpole():
    """``test_rllib_offpolicy.py``'s gate at its configuration, from the
    JAX learner's initial weights: DQN's curve hangs on them (at seed 0
    the port's own draw peaks at 19.0 from 10.6 within the 30
    iterations, under the gate), and from the same weights the port
    follows the JAX run's returns."""
    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=64)
            .training(lr=1e-3, buffer_size=20_000, train_batch_size=128,
                      num_updates_per_iter=16, num_steps_before_learning=500,
                      target_network_update_freq=50, epsilon=0.15)
            .debugging(seed=0).resources(device="cpu").build())
    # the JAX DQNLearner's draw: its QModule's init at PRNGKey(seed)
    init = jdqn.QModule(JCartPole().spec, epsilon=0.15).init(
        jax.random.PRNGKey(0))
    learner = algo.learner_group._local
    params_from_flax(learner.module, _np(init))
    params_from_flax(learner.target, _np(init))
    algo.env_runner_group.sync_weights(learner.get_weights())
    first, best = None, -np.inf
    for _ in range(30):
        m = algo.step()
        if not np.isnan(m["episode_return_mean"]):
            if first is None:
                first = m["episode_return_mean"]
            best = max(best, m["episode_return_mean"])
    algo.cleanup()
    assert first is not None
    assert best > first + 15, (first, best)


def test_config_device_defaults_to_the_card(monkeypatch):
    cfg = PPOConfig().environment("CartPole-v1")
    assert cfg.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.build()
    with pytest.raises(ValueError, match="unknown config key"):
        PPOConfig().update_from_dict({"devise": "cpu"})
    assert PPOConfig().update_from_dict({"device": "cpu"}).device == "cpu"
