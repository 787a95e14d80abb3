"""The JAX RLlib tests' learning gates, on the port, on the CPU, at the
same configurations (``tests/test_rllib.py``, ``test_rllib_appo_cql.py``,
``test_rllib_offpolicy.py``): PPO, IMPALA, APPO and DQN learn CartPole,
PPO runs on Pendulum, with the mean-std filter and with frame stacking,
and the CNN module learns the pixel catch env. The port draws JAX's
random stream but not the JAX learner's shuffles, and its modules draw
their initial weights from a torch generator, so its curves are its own;
the gates are the reference's. (DQN's gate, which hangs on the initial
weights, is in ``test_torch_rllib_algorithms.py``, from the JAX
learner's.) Torch runs these small ops on one thread: with the suite's
workers sharing the cores, more threads only contend.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import (APPOConfig, CNNRLModule, IMPALAConfig,
                                 PPOConfig)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(cfg):
    return cfg.resources(device="cpu")


def _best(algo, iters, reached, first=None):
    """The best return mean over up to `iters` iterations, stopping once
    `reached(best)`."""
    best = -np.inf if first is None else first
    for _ in range(iters):
        best = max(best, algo.train()["episode_return_mean"])
        if reached(best):
            break
    return best


def test_ppo_learns_cartpole():
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=128)
                .training(lr=3e-4, minibatch_size=256, num_epochs=4)
                .debugging(seed=0)).build()
    first = algo.train()["episode_return_mean"]
    best = _best(algo, 24, lambda b: b > 120, first)
    assert best > 120, f"PPO failed to learn: first={first} best={best}"
    ckpt = algo.save()
    algo.restore(ckpt)
    algo.stop()


def test_ppo_continuous_pendulum_runs():
    algo = _cpu(PPOConfig().environment("Pendulum-v1")
                .env_runners(num_envs_per_env_runner=8,
                             rollout_fragment_length=64)
                .training(minibatch_size=128, num_epochs=2)).build()
    m = algo.train()
    assert np.isfinite(m["learner/total_loss"])
    algo.stop()


def test_impala_learns_cartpole():
    algo = _cpu(IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(lr=2e-3, entropy_coeff=0.005)
                .debugging(seed=0)).build()
    best = _best(algo, 60, lambda b: b > 80, 0.0)
    assert best > 80, f"IMPALA failed to learn: best={best}"
    algo.stop()


def test_appo_learns_cartpole():
    algo = _cpu(APPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(lr=2e-3, entropy_coeff=0.005, num_epochs=2,
                          minibatch_size=512)
                .debugging(seed=0)).build()
    best, saw_appo_loss = 0.0, False
    for _ in range(60):
        m = algo.train()
        best = max(best, m["episode_return_mean"])
        # clip_fraction is emitted only by the APPO surrogate loss
        saw_appo_loss |= np.isfinite(m.get("learner/clip_fraction", np.nan))
        if best > 80:
            break
    algo.stop()
    assert best > 80, f"APPO failed to learn: best={best}"
    assert saw_appo_loss


def test_ppo_learns_with_obs_filter():
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=128,
                             observation_filter="mean_std")
                .training(lr=3e-4, minibatch_size=256, num_epochs=4)
                .debugging(seed=0)).build()
    best = _best(algo, 12, lambda b: b > 60)
    assert best > 60, f"filtered PPO failed to improve: best={best}"
    ckpt = algo.save()
    before = algo.env_runner_group.get_filter_state()
    algo.restore(ckpt)
    after = algo.env_runner_group.get_filter_state()
    assert after is not None and after[0] == before[0]
    assert np.allclose(after[1], before[1])
    algo.stop()


def test_framestack_ppo_trains():
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=8,
                             rollout_fragment_length=32, framestack=4)
                .training(minibatch_size=64, num_epochs=1)).build()
    for _ in range(2):
        assert np.isfinite(algo.train()["learner/total_loss"])
    algo.stop()


def test_ppo_cnn_learns_pixel_catch():
    """Random play scores about -4 per episode; the gate is +4 (>=75%
    catch rate), readable only through the CNN module."""
    algo = _cpu(PPOConfig().environment("CatchPixels-v0")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=80)
                .training(lr=1e-3, minibatch_size=320, num_epochs=4,
                          entropy_coeff=0.01)
                .rl_module(module_class=CNNRLModule)
                .debugging(seed=0)).build()
    first = algo.train()["episode_return_mean"]
    best = _best(algo, 40, lambda b: b >= 4.0, first)
    assert best >= 4.0, f"CNN PPO failed to learn: first={first} best={best}"
    algo.stop()
