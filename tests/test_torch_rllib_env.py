"""ray_tpu_torch.rllib's batched envs against ray_tpu.rllib's JAX envs
(``jax.vmap``ped), on the CPU: resets from the same keys, steps from the
same seeded states, actions and keys; termination, truncation, the
stacked spec and the registry.

Tolerances: CatchPixels is integer arithmetic, equal. A reset's uniform
is ``f * (hi - lo) + lo``, which XLA fuses into one fma and the port
rounds twice: one ulp of the range bound (``np.spacing(hi)``), and for
Pendulum's cos/sin obs one more ulp of 1. Steps: float32 physics in the
reference's order; XLA fuses some multiply-adds, so states and rewards
agree within 1e-6, or within one ulp of the value where the value's ulp
exceeds 1e-6 (Pendulum's cost reaches ~16, where an ulp is 1.9e-6).
``done`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.env import jax_env as je
from ray_tpu_torch.ops import threefry as tf
from ray_tpu_torch.rllib.env import torch_env as te

N = 1024


def _keys(seed, n=N):
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31 - 1, n)
    return (jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)),
            tf.prng_key(torch.from_numpy(seeds)))


def _close(got, want):
    """1e-6, or one ulp of the value where that is coarser."""
    got, want = np.asarray(got), np.asarray(want)
    tol = np.maximum(1e-6, np.spacing(np.abs(want).astype(np.float32)))
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (f"{bad.sum()} of {bad.size} apart; first "
                           f"{got[bad][:4]} vs {want[bad][:4]}")


def _tree_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name,bound", [("CartPole", 0.05),
                                        ("Pendulum", np.pi),
                                        ("CatchPixels", None)])
def test_reset_matches_jax(name, bound):
    jenv, penv = getattr(je, name)(), getattr(te, name)()
    jkeys, pkeys = _keys(0)
    jstate, jobs = jax.vmap(jenv.reset)(jkeys)
    pstate, pobs = penv.reset(pkeys)
    jleaves, pleaves = _tree_np(jstate), [t.numpy() for t in pstate]
    if name == "CatchPixels":
        # the JAX state's leaves: ball_r, ball_c, pad_c, t
        for g, w in zip(pleaves, jleaves):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs))
        return
    ulp = float(np.spacing(np.float32(bound)))
    np.testing.assert_allclose(pleaves[0], jleaves[0], rtol=0, atol=ulp)
    np.testing.assert_array_equal(pleaves[1], jleaves[1])
    obs_tol = ulp + (float(np.spacing(np.float32(1))) if name == "Pendulum"
                     else 0.0)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=0,
                               atol=obs_tol)


def _random_states(name, rng):
    f = np.float32
    if name == "CartPole":
        s = rng.uniform([-2.4, -3, -0.21, -3], [2.4, 3, 0.21, 3],
                        (N, 4)).astype(f)
        return (s, rng.integers(0, 500, N).astype(np.int32))
    if name == "Pendulum":
        s = np.stack([rng.uniform(-4 * np.pi, 4 * np.pi, N),
                      rng.uniform(-8, 8, N)], -1).astype(f)
        return (s, rng.integers(0, 200, N).astype(np.int32))
    H, W, P = te.CatchPixels.H, te.CatchPixels.W, te.CatchPixels.PAD
    i32 = np.int32
    return (rng.integers(0, H - 1, N).astype(i32),
            rng.integers(0, W, N).astype(i32),
            rng.integers(P, W - P, N).astype(i32),
            rng.integers(0, 80, N).astype(i32))


def _random_actions(name, rng):
    if name == "Pendulum":
        return rng.uniform(-3, 3, (N, 1)).astype(np.float32)
    return rng.integers(0, 3 if name == "CatchPixels" else 2,
                        N).astype(np.int32)


@pytest.mark.parametrize("name", ["CartPole", "Pendulum", "CatchPixels"])
def test_step_matches_vmapped_jax(name):
    rng = np.random.default_rng(1)
    state = _random_states(name, rng)
    action = _random_actions(name, rng)
    jenv, penv = getattr(je, name)(), getattr(te, name)()
    jkeys, pkeys = _keys(2)
    jstate, jobs, jrew, jdone = jax.vmap(jenv.step)(
        tuple(jnp.asarray(x) for x in state), jnp.asarray(action), jkeys)
    pstate, pobs, prew, pdone = penv.step(
        tuple(torch.from_numpy(x) for x in state),
        torch.from_numpy(action), pkeys)
    for g, w in zip(pstate, _tree_np(jstate)):
        if w.dtype == np.float32:
            _close(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    _close(pobs.numpy(), np.asarray(jobs))
    _close(prew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(pdone.numpy(), np.asarray(jdone))
    assert pdone.any() and not pdone.all()


def test_cartpole_terminates_and_truncates():
    env = te.CartPole(max_episode_steps=10)
    s = torch.tensor([[0.0, 0.0, 0.0, 0.0], [2.399, 1.0, 0.0, 0.0],
                      [0.0, 0.0, 0.2094, 1.0], [0.0, 0.0, 0.0, 0.0]])
    t = torch.tensor([0, 0, 0, 9], dtype=torch.int32)
    (s2, t2), obs, rew, done = env.step((s, t), torch.tensor([1, 1, 1, 0]),
                                        None)
    assert done.tolist() == [False, True, True, True]
    assert rew.tolist() == [1.0] * 4 and t2.tolist() == [1, 1, 1, 10]
    assert torch.equal(obs, s2)


def test_pendulum_truncates_and_costs():
    env = te.Pendulum(max_episode_steps=3)
    _, obs = env.reset(tf.prng_key(torch.arange(4)))
    assert obs.shape == (4, 3)
    state = (torch.tensor([[np.pi, 0.0], [0.0, 0.0]], dtype=torch.float32),
             torch.tensor([0, 2], dtype=torch.int32))
    _, _, rew, done = env.step(state, torch.zeros(2, 1), None)
    assert done.tolist() == [False, True]
    assert float(rew[1]) == 0.0 and float(rew[0]) < -9.0


def test_catch_scores_catch_and_miss():
    env = te.CatchPixels()
    H = env.H
    state = tuple(torch.tensor(v) for v in (
        [H - 2, H - 2, 3], [5, 5, 0], [5, 1, 5], [0, 0, 79]))
    (r, c, p, t), obs, rew, done = env.step_from(
        state, torch.tensor([1, 1, 1]), torch.tensor([7, 7, 7]))
    assert rew.tolist() == [1.0, -1.0, 0.0]
    assert r.tolist() == [0, 0, 4] and c.tolist() == [7, 7, 0]
    assert done.tolist() == [False, False, True]
    img = obs.reshape(3, H, env.W)
    assert float(img[0, 0, 7]) == 1.0 and float(img[0, H - 1].sum()) == 1.5


def test_stacked_spec_and_registry():
    spec = te.CartPole().spec
    assert te.stacked_spec(spec, 1) is spec
    s4 = te.stacked_spec(spec, 4)
    assert s4.obs_dim == 16 and s4.num_actions == 2
    for name in ("CartPole-v1", "Pendulum-v1", "CatchPixels-v0"):
        assert vars(te.make_env(name).spec) == vars(je.make_env(name).spec)
    te.register_env("ShortPole", lambda: te.CartPole(max_episode_steps=7))
    try:
        assert te.make_env("ShortPole").spec.max_episode_steps == 7
    finally:
        te._ENV_REGISTRY.pop("ShortPole")
    env = te.Pendulum()
    assert te.make_env(env) is env
    assert isinstance(te.make_env(te.CatchPixels), te.CatchPixels)
    with pytest.raises(ValueError, match="unknown env"):
        te.make_env("NoSuchEnv")
    with pytest.raises(TypeError):
        te.make_env(3)
