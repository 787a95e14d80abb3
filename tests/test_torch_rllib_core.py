"""ray_tpu_torch.rllib's core pieces against ray_tpu.rllib's, on the CPU:
the threefry draws RLlib adds (split, normal, randint), the action
distributions, the RL modules on parameters carried over from flax, and
the GAE and V-trace recursions. Same numpy inputs from a seed on both
sides; float32.

Tolerances: split and randint are integer hashes, bit-equal. normal is
sqrt(2) erfinv(u) of a bit-equal uniform: the two backends' log1p and
sqrt round apart in the last bit, 2e-6 absolute (values reach ~5.3).
Distribution functions 1e-6 (log-softmax and sums in another order);
a DiagGaussian sample 1e-5 (its normal, scaled by exp(log_std) up to
e^2). Module forwards 1e-5 relative (the same products summed in
another order). GAE and V-trace 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.dqn import QModule as JQModule
from ray_tpu.rllib.algorithms.impala import vtrace as jvtrace
from ray_tpu.rllib.core import distributions as jd
from ray_tpu.rllib.core.postprocessing import compute_gae as jgae
from ray_tpu.rllib.core.rl_module import (CNNRLModule as JCNN,
                                          DefaultRLModule as JDefault)
from ray_tpu.rllib.env.jax_env import EnvSpec as JSpec
from ray_tpu_torch.ops import threefry as tf
from ray_tpu_torch.rllib.algorithms.dqn import QModule
from ray_tpu_torch.rllib.algorithms.impala import vtrace
from ray_tpu_torch.rllib.core import distributions as pd
from ray_tpu_torch.rllib.core.postprocessing import compute_gae
from ray_tpu_torch.rllib.core.rl_module import (CNNRLModule,
                                                DefaultRLModule,
                                                params_from_flax)
from ray_tpu_torch.rllib.env.torch_env import EnvSpec


def _keys(seed, shape):
    """The same PRNGKey(seed) keys on both sides, batched over `shape`."""
    seeds = np.asarray(
        np.random.default_rng(seed).integers(0, 2 ** 31 - 1, shape))
    flat = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds).reshape(-1))
    return (flat.reshape(shape + (2,)),
            tf.prng_key(torch.from_numpy(seeds)))


def _vmap_keys(fn, jkeys):
    """fn(key) over every key of a [..., 2] key array."""
    lead = jkeys.shape[:-1]
    out = jax.jit(jax.vmap(fn))(jkeys.reshape(-1, 2))
    return np.asarray(out).reshape(lead + out.shape[1:])


# ---------------------------------------------------------------- threefry

@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(num):
    jkeys, pkeys = _keys(0, (4, 5))
    want = _vmap_keys(lambda k: jax.random.split(k, num), jkeys)
    k1, k2 = tf.split(pkeys, num)
    np.testing.assert_array_equal(k1.numpy(), want[..., 0])
    np.testing.assert_array_equal(k2.numpy(), want[..., 1])


def test_normal_matches_jax():
    jkeys, pkeys = _keys(1, (8, 16))
    want = _vmap_keys(lambda k: jax.random.normal(k, (500,)), jkeys)
    got = tf.normal(pkeys, 500).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 3), (1, 11), (0, 12),
                                   (5, 100_000), (-7, 2 ** 30), (4, 4)])
def test_randint_matches_jax(lo, hi):
    jkeys, pkeys = _keys(2, (6, 7))
    want = _vmap_keys(lambda k: jax.random.randint(k, (50,), lo, hi), jkeys)
    np.testing.assert_array_equal(tf.randint(pkeys, 50, lo, hi).numpy(),
                                  want)


# ---------------------------------------------------------- distributions

def _inputs(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def test_categorical_matches_jax():
    logits, other = _inputs(0, (32, 5)), _inputs(1, (32, 5))
    actions = np.random.default_rng(2).integers(0, 5, 32).astype(np.int32)
    t = torch.from_numpy
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pd.Categorical.log_prob(t(logits), t(actions)).numpy(),
        np.asarray(jd.Categorical.log_prob(logits, actions)), **close)
    np.testing.assert_allclose(
        pd.Categorical.entropy(t(logits)).numpy(),
        np.asarray(jd.Categorical.entropy(logits)), **close)
    np.testing.assert_allclose(
        pd.Categorical.kl(t(logits), t(other)).numpy(),
        np.asarray(jd.Categorical.kl(logits, other)), **close)
    np.testing.assert_array_equal(
        pd.Categorical.deterministic(t(logits)).numpy(),
        np.asarray(jd.Categorical.deterministic(logits)))
    for seed in range(4):
        jkey, pkey = _keys(10 + seed, ())
        np.testing.assert_array_equal(
            pd.Categorical.sample(t(logits), pkey).numpy(),
            np.asarray(jd.Categorical.sample(logits, jkey)))


def test_diag_gaussian_matches_jax():
    params, other = _inputs(3, (32, 4)), _inputs(4, (32, 4))
    actions = _inputs(5, (32, 2))
    t = torch.from_numpy
    close = dict(rtol=1e-6, atol=1e-6)
    g, jg = pd.DiagGaussian, jd.DiagGaussian
    np.testing.assert_allclose(g.log_prob(t(params), t(actions)).numpy(),
                               np.asarray(jg.log_prob(params, actions)),
                               **close)
    np.testing.assert_allclose(g.entropy(t(params)).numpy(),
                               np.asarray(jg.entropy(params)), **close)
    np.testing.assert_allclose(g.kl(t(params), t(other)).numpy(),
                               np.asarray(jg.kl(params, other)), **close)
    np.testing.assert_allclose(g.deterministic(t(params)).numpy(),
                               np.asarray(jg.deterministic(params)), **close)
    for seed in range(4):
        jkey, pkey = _keys(20 + seed, ())
        np.testing.assert_allclose(
            g.sample(t(params), pkey).numpy(),
            np.asarray(jg.sample(params, jkey)), rtol=0, atol=1e-5)


def test_noise_over_batched_keys_is_each_keys_draw():
    """A fragment's noise drawn over [T] keys equals T draws of one key
    each, as the rollout's per-step JAX calls draw it."""
    jkeys, pkeys = _keys(6, (3,))
    logits = _inputs(7, (8, 2))
    noise = pd.Categorical.noise(pkeys, (8, 2))
    for t in range(3):
        jk = jkeys[t]
        want = np.asarray(jd.Categorical.sample(logits, jk))
        got = pd.Categorical.sample_with(torch.from_numpy(logits),
                                         noise[t]).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- modules

def _flax_params(jmodule, seed=0):
    tree = jax.jit(jmodule.init)(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_forward(jmod, pmod, obs):
    params = _flax_params(jmod)
    params_from_flax(pmod, params)
    want = jax.jit(jmod.apply)(params, obs)
    with torch.no_grad():
        got = pmod(torch.from_numpy(obs))
    for k in ("action_dist_inputs", "vf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("discrete", [True, False])
def test_default_module_forward_matches_flax(discrete):
    kw = (dict(obs_dim=6, num_actions=3) if discrete
          else dict(obs_dim=6, num_actions=0, action_dim=2))
    obs = _inputs(8, (10, 6), 1.0)
    _check_forward(JDefault(JSpec(**kw), hiddens=(32, 16)),
                   DefaultRLModule(EnvSpec(**kw), hiddens=(32, 16)), obs)


@pytest.mark.parametrize("n_frames", [1, 3])
def test_cnn_module_forward_matches_flax(n_frames):
    """SAME padding (asymmetric at stride 2), the frame-major channel
    fold and the H, W, C flatten before the dense layer."""
    kw = dict(obs_dim=10 * 12 * n_frames, num_actions=3,
              obs_shape=(10, 12, 1))
    obs = _inputs(9, (6, 10 * 12 * n_frames), 1.0)
    _check_forward(JCNN(JSpec(**kw), channels=(4, 8), dense=32),
                   CNNRLModule(EnvSpec(**kw), channels=(4, 8), dense=32),
                   obs)


def test_cnn_module_forward_odd_image_matches_flax():
    kw = dict(obs_dim=7 * 9 * 2, num_actions=2, obs_shape=(7, 9, 2))
    obs = _inputs(10, (5, 7 * 9 * 2), 1.0)
    _check_forward(JCNN(JSpec(**kw), channels=(3, 5, 4), dense=16),
                   CNNRLModule(EnvSpec(**kw), channels=(3, 5, 4), dense=16),
                   obs)


def test_q_module_forward_and_exploration_match_jax():
    spec = dict(obs_dim=4, num_actions=3)
    jmod = JQModule(JSpec(**spec), hiddens=(16, 16), epsilon=0.4)
    pmod = QModule(EnvSpec(**spec), hiddens=(16, 16), epsilon=0.4)
    obs = _inputs(11, (64, 4), 1.0)
    _check_forward(jmod, pmod, obs)
    params = _flax_params(jmod)
    explore = jax.jit(jmod.forward_exploration)
    for seed in range(3):
        jkey, pkey = _keys(30 + seed, ())
        ja, jl, jv = explore(params, obs, jkey)
        with torch.no_grad():
            pa, pl, pv = pmod.forward_exploration(torch.from_numpy(obs),
                                                  pkey)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


def test_params_from_flax_refuses_another_layout():
    """A (64, 64) module's tree (Dense_0..Dense_5) into a (64,) one."""
    tree = {"params": {f"Dense_{i}": {"kernel": np.zeros((4, 4)),
                                      "bias": np.zeros(4)}
                       for i in range(6)}}
    pmod = DefaultRLModule(EnvSpec(obs_dim=4, num_actions=2),
                           hiddens=(64,))
    with pytest.raises(ValueError, match="flax tree"):
        params_from_flax(pmod, tree)


def test_init_parameters_follow_flax_families():
    """Zero biases, orthogonal heads at their gains, truncated-normal
    kernels within 2 std; the same seed the same weights."""
    spec = EnvSpec(obs_dim=8, num_actions=4)
    a = DefaultRLModule(spec).init_parameters(3)
    b = DefaultRLModule(spec).init_parameters(3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert all(float(layer.bias.abs().max()) == 0.0
               for _, layer, _ in a.flax_layers())
    w = a.logits.weight                     # (4, 64), gain 0.01
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(4), atol=1e-9,
                               rtol=0)
    std = (1 / 8) ** 0.5 / 0.87962566103423978
    assert float(a.pi[0].weight.abs().max()) <= 2 * std


# ---------------------------------------------------------- GAE, V-trace

def _trajectory(seed, T=12, B=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(rewards=rng.normal(size=(T, B)).astype(f),
                values=rng.normal(size=(T, B)).astype(f),
                dones=rng.random((T, B)) < 0.2,
                final=rng.normal(size=(B,)).astype(f),
                blogp=(rng.normal(size=(T, B)) - 1).astype(f),
                tlogp=(rng.normal(size=(T, B)) - 1).astype(f))


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_gae_matches_jax(gamma, lam):
    d = _trajectory(0)
    want = jgae(d["rewards"], d["values"], d["dones"], d["final"],
                gamma=gamma, lam=lam)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = compute_gae(t["rewards"], t["values"], t["dones"], t["final"],
                      gamma=gamma, lam=lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_jax(rho_bar, c_bar):
    d = _trajectory(1)
    want = jvtrace(d["blogp"], d["tlogp"], d["rewards"], d["values"],
                   d["dones"], d["final"], gamma=0.97, rho_bar=rho_bar,
                   c_bar=c_bar)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = vtrace(t["blogp"], t["tlogp"], t["rewards"], t["values"],
                 t["dones"], t["final"], gamma=0.97, rho_bar=rho_bar,
                 c_bar=c_bar)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
