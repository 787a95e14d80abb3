"""ray_tpu_torch.rllib's SingleAgentEnvRunner against ray_tpu.rllib's, on
the CPU: the same seed and the JAX runner's parameters carried over
(``params_from_flax``), so both draw JAX's stream and act alike.

The near-tie rule (CartPole): the JAX rollout is one fused XLA program,
the port's is eager PyTorch, so logits differ in the last bits and an
action can flip where the two best Gumbel-perturbed scores nearly tie.
So an env is compared step by step up to its first step whose top-two
gap is <= 1e-4 (after it the trajectories may part): actions and dones
equal, obs within 1e-4 (float32 physics, XLA's fused multiply-adds);
the runner's ``stats`` equal when no env met a near tie. Pendulum's
actions are continuous: within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.env.env_runner import (SingleAgentEnvRunner as JRunner,
                                          merge_moments as jmerge)
from ray_tpu_torch.rllib.core.rl_module import params_from_flax
from ray_tpu_torch.rllib.env.env_runner import (SingleAgentEnvRunner,
                                                merge_moments)

NEAR_TIE = 1e-4
OBS_TOL = 1e-4


def _pair(env, num_envs, T, seed=0, **kw):
    jr = JRunner(env, num_envs=num_envs, rollout_length=T, seed=seed, **kw)
    pr = SingleAgentEnvRunner(env, num_envs=num_envs, rollout_length=T,
                              seed=seed, device="cpu", **kw)
    params_from_flax(pr.module, jax.device_get(jr.params))
    return jr, pr


def _sample_with_gaps(runner):
    """sample() through its stages, and each step's gap between the two
    best Gumbel-perturbed scores [T, B]."""
    draws = runner._draw()
    out = runner._finish(runner._steps(draws))
    with torch.no_grad():
        logits = runner.module(torch.from_numpy(
            out["batch"]["obs"]))["action_dist_inputs"]
    top = (logits + draws["act"][0]).topk(2, dim=-1).values
    return out, (top[..., 0] - top[..., 1]).numpy()


def near_tie_check(jout, pout, gaps):
    """The rule above; returns the number of envs that met a near tie."""
    jb, pb = jout["batch"], pout["batch"]
    T, B = gaps.shape
    tied = 0
    for e in range(B):
        for t in range(T):
            where = f"step {t}, env {e}, gap {gaps[t, e]:.3g}"
            np.testing.assert_allclose(pb["obs"][t, e], jb["obs"][t, e],
                                       rtol=0, atol=OBS_TOL, err_msg=where)
            if gaps[t, e] <= NEAR_TIE:
                tied += 1
                break
            assert pb["actions"][t, e] == jb["actions"][t, e], where
            assert pb["dones"][t, e] == jb["dones"][t, e], where
    if not tied:
        assert pout["stats"] == jout["stats"]
        np.testing.assert_allclose(pb["final_obs"], jb["final_obs"],
                                   rtol=0, atol=OBS_TOL)
    return tied


@pytest.fixture(scope="module")
def cartpole():
    jr, pr = _pair("CartPole-v1", 16, 128)
    jout = jr.sample()
    pout, gaps = _sample_with_gaps(pr)
    return jout, pout, gaps


def test_first_cartpole_sample_matches_jax(cartpole):
    jout, pout, gaps = cartpole
    tied = near_tie_check(jout, pout, gaps)
    assert tied == 0, f"{tied} envs met a near tie at this seed"
    assert pout["stats"]["num_episodes"] > 16      # resets exercised
    jb, pb = jout["batch"], pout["batch"]
    for k in ("logp", "vf", "final_vf"):
        np.testing.assert_allclose(pb[k], jb[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(pb["rewards"], jb["rewards"])


def test_batch_keys_shapes_and_dtypes_match_jax(cartpole):
    jout, pout, _ = cartpole
    jb, pb = jout["batch"], pout["batch"]
    assert sorted(pb) == sorted(jb)
    for k in jb:
        assert pb[k].shape == jb[k].shape, k
        assert pb[k].dtype == jb[k].dtype, k
    assert sorted(pout["stats"]) == sorted(jout["stats"])
    assert pb["obs"].shape == (128, 16, 4)
    assert pout["stats"]["env_steps"] == 16 * 128


def test_first_pendulum_sample_matches_jax():
    jr, pr = _pair("Pendulum-v1", 16, 128)
    jout, pout = jr.sample(), pr.sample()
    jb, pb = jout["batch"], pout["batch"]
    np.testing.assert_allclose(pb["actions"], jb["actions"], rtol=0,
                               atol=1e-4)
    # the obs part from the last bit and drift apart as the integrator
    # carries the rounding forward (~2e-4 by step 128 at this seed):
    # only the first steps are held to OBS_TOL
    np.testing.assert_allclose(pb["obs"][:32], jb["obs"][:32], rtol=0,
                               atol=OBS_TOL)
    np.testing.assert_array_equal(pb["dones"], jb["dones"])
    assert pout["stats"]["num_episodes"] == jout["stats"]["num_episodes"]
    np.testing.assert_allclose(pout["stats"]["episode_return_mean"],
                               jout["stats"]["episode_return_mean"],
                               rtol=1e-4)


def test_mean_std_filter_state_matches_jax():
    """Two filtered Pendulum samples: the Welford state (count, mean,
    M2) folded on the host equals the JAX runner's, and the second
    fragment's normalized obs agree."""
    jr, pr = _pair("Pendulum-v1", 4, 64, obs_filter="mean_std")
    for _ in range(2):
        jout, pout = jr.sample(), pr.sample()
    jc, jm, js = jr.get_filter_state()
    pc, pm, ps = pr.get_filter_state()
    assert pc == jc == 2 * 4 * 64
    np.testing.assert_allclose(pm, jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ps, js, rtol=1e-4)
    np.testing.assert_allclose(pout["batch"]["obs"], jout["batch"]["obs"],
                               rtol=0, atol=1e-3)
    assert np.abs(pout["batch"]["obs"]).max() <= 10.0
    pr.set_filter_state((pc, pm, ps))
    assert pr.get_filter_state()[0] == pc


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_moments_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = (float(rng.integers(1, 100)), rng.normal(size=3), rng.random(3))
    b = (float(rng.integers(1, 100)), rng.normal(size=3), rng.random(3))
    for x, y in ((a, b), (b, a), (a, (0.0, b[1], b[2])),
                 ((0.0, a[1], a[2]), b)):
        got, want = merge_moments(x, y), jmerge(x, y)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_framestack_rollout_semantics():
    """Stacked obs carry the last N frames: within an episode frame t's
    window ends with obs[t] and starts with obs[t-N+1]; on reset the
    window refills with the fresh obs (mirrors the JAX test)."""
    N, T, B, D = 4, 64, 2, 4
    r = SingleAgentEnvRunner("CartPole-v1", num_envs=B, rollout_length=T,
                             seed=0, framestack=N, device="cpu")
    b = r.sample()["batch"]
    assert b["obs"].shape == (T, B, N * D)
    obs = b["obs"].reshape(T, B, N, D)
    dones = b["dones"]
    for t in range(1, T):
        for e in range(B):
            if dones[max(0, t - N):t + 1, e].any():
                continue
            np.testing.assert_allclose(obs[t, e, :-1], obs[t - 1, e, 1:],
                                       rtol=1e-6)
    hits = 0
    for t in range(T - 1):
        for e in range(B):
            if dones[t, e]:
                first = obs[t + 1, e]
                np.testing.assert_allclose(
                    first, np.tile(first[-1], (N, 1)), rtol=1e-6)
                hits += 1
    assert hits > 0, "no episode ended: reset-refill never exercised"
    assert b["final_obs"].shape == (B, N * D)


def test_framestack_sample_matches_jax():
    jr, pr = _pair("CartPole-v1", 4, 48, framestack=3)
    jout = jr.sample()
    pout, gaps = _sample_with_gaps(pr)
    near_tie_check(jout, pout, gaps)


def test_weights_copy_tensor_to_tensor():
    r = SingleAgentEnvRunner("CartPole-v1", num_envs=2, rollout_length=4,
                             device="cpu")
    w = {k: v + 1.0 for k, v in r.get_weights().items()}
    before = {k: p.data_ptr() for k, p in r.module.named_parameters()}
    r.set_weights(w)
    for k, p in r.module.named_parameters():
        assert p.data_ptr() == before[k]          # copied in place
        assert torch.equal(p, w[k])
    with pytest.raises(ValueError, match="weights hold"):
        r.set_weights({"nope": torch.zeros(1)})


def test_runner_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SingleAgentEnvRunner("CartPole-v1", num_envs=2, rollout_length=4)
