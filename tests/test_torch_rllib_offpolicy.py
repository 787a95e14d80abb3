"""ray_tpu_torch.rllib's SAC, CQL and offline algorithms (BC, MARWIL)
against ray_tpu.rllib's, on the CPU, plus the reference's behavioural
gates (``tests/test_rllib_offpolicy.py`` and
``test_rllib_appo_cql.py``) at their configurations.

Parity, float32, the same numpy inputs, weights and keys on both sides:
- ``_squash``: actions 1e-5 absolute (its normals are 2e-6 apart,
  ``test_torch_rllib_core.py``); log-probs 1e-4 absolute plus, for each
  action element a, 2|a| da / (1 - a^2 + 1e-6) with da the actions'
  difference plus an ulp of tanh: the term ``log(1 - a^2 + 1e-6)``
  turns an action near |a| = 1 a rounding apart into that much (~0.1
  for a saturated one);
- the SAC module's forward 1e-5 relative;
- one SAC update (critic + actor backward, clipped Adam, the
  temperature's Adam, the polyak targets) and one CQL update: metrics
  1e-4 relative plus 1e-4 absolute (the entropy and alpha loss are
  means of such log-probs); Adam's moments at the gradients' tolerance;
  parameters 1e-6 absolute plus what Adam's first step,
  lr g / (|g| + eps), makes of that tolerance where |g| is near eps;
  targets and log_alpha 1e-6 absolute;
- the CQL penalty and its gradients, the BC and MARWIL losses and
  gradients: 1e-5 relative (gradients 1e-4, plus 1e-4 of the largest
  gradient element where they cancel);
- the .npz shard format both ways: equal keys, dtypes and values.

Gates: the reference's assertions. SAC's Pendulum gate, like DQN's in
``test_torch_rllib_algorithms.py``, starts from the JAX learner's
initial weights (at seed 0 the port's own draw stays under the gate
for 40 iterations: its curve is compared with its own first return,
which the initial draw sets), read from
``chip_smoke_data/sac_pendulum_jax_init_seed0.npz``, the file the card's
gate (chip_smoke.py phase 6e) reads too; a test holds the file to a
fresh JAX draw.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import offline as joff
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.env.jax_env import CartPole as JCartPole
from ray_tpu.rllib.env.jax_env import Pendulum as JPendulum
from ray_tpu_torch.ops import threefry as tf
from ray_tpu_torch.rllib import (BCConfig, CQLConfig, MARWILConfig,
                                 OfflineData, PPOConfig, SACConfig,
                                 record_samples)
from ray_tpu_torch.rllib import offline as poff
from ray_tpu_torch.rllib.algorithms import cql, sac
from ray_tpu_torch.rllib.algorithms.dqn import _to_transitions
from ray_tpu_torch.rllib.core.rl_module import params_from_flax
from ray_tpu_torch.rllib.env.torch_env import CartPole, Pendulum


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _by_name(module, flax_tree):
    """A flax tree in the port module's parameter names and layouts."""
    tree = flax_tree.get("params", flax_tree)
    names = {id(p): n for n, p in module.named_parameters()}
    out = {}
    for name, layer, _ in module.flax_layers():
        out[names[id(layer.weight)]] = np.asarray(tree[name]["kernel"]).T
        out[names[id(layer.bias)]] = np.asarray(tree[name]["bias"])
    return out


def _assert_tree(module, flax_tree, atol, what):
    want = _by_name(module, flax_tree)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


def _assert_grads(module, grads, flax_grads):
    want = _by_name(module, flax_grads)
    top = max(np.abs(w).max() for w in want.values())
    for (name, _), g in zip(module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4 * top, err_msg=name)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _sac_pair(jcls, pcls, **over):
    jcfg, pcfg = ((jcql.CQLConfig(), CQLConfig()) if jcls is jcql.CQLLearner
                  else (jsac.SACConfig(), SACConfig()))
    for c in (jcfg, pcfg):
        c.action_scale = 2.0
        for k, v in over.items():
            setattr(c, k, v)
    jl = jcls(JPendulum().spec, jcfg)
    pl = pcls(Pendulum().spec, pcfg, device="cpu")
    params_from_flax(pl.module, _np(jl.params))
    params_from_flax(pl.target, _np(jl.params))
    return jl, pl


def _transitions(rng, n, obs_dim=3, act_dim=1):
    f = np.float32
    return dict(obs=rng.normal(size=(n, obs_dim)).astype(f),
                actions=rng.uniform(-2, 2, (n, act_dim)).astype(f),
                rewards=rng.normal(size=n).astype(f),
                dones=(rng.random(n) < 0.1).astype(f),
                next_obs=rng.normal(size=(n, obs_dim)).astype(f))


# ------------------------------------------------------------------ SAC

def _assert_logp(plp, jlp, pa, ja):
    """Log-probs within 1e-4 plus what ``log(1 - a^2 + 1e-6)`` makes of
    the actions' own difference (and an ulp of tanh)."""
    a = pa.numpy().astype(np.float64)
    da = np.abs(a - np.asarray(ja, np.float64)) + 6e-8
    tol = 1e-4 + (2 * np.abs(a) * da / (1 - a ** 2 + 1e-6)).sum(-1)
    err = np.abs(plp.numpy() - np.asarray(jlp))
    assert (err <= tol).all(), (err - tol).max()


def test_squash_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(64, 2)).astype(np.float32)
    log_std = (rng.normal(size=(64, 2)) * 3).astype(np.float32)  # clipped
    ja, jlp = jax.jit(jsac._squash)(mean, log_std, jax.random.PRNGKey(11))
    pa, plp = sac._squash(torch.from_numpy(mean), torch.from_numpy(log_std),
                          tf.prng_key(torch.tensor(11)))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    _assert_logp(plp, jlp, pa, ja)
    # batched keys draw each key's normals (CQL's vmap over keys)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ja, jlp = jax.vmap(lambda k: jsac._squash(mean, log_std, k))(keys)
    pa, plp = sac._squash(torch.from_numpy(mean), torch.from_numpy(log_std),
                          tf.split(tf.prng_key(torch.tensor(3)), 4))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    _assert_logp(plp, jlp, pa, ja)


def test_sac_module_forward_and_exploration_match_jax():
    jm = jsac.SACModule(JPendulum().spec, action_scale=2.0)
    pm = sac.SACModule(Pendulum().spec, action_scale=2.0)
    params = jm.init(jax.random.PRNGKey(4))
    params_from_flax(pm, _np(params))
    obs = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    out, pout = jm.apply(params, obs), pm(torch.from_numpy(obs))
    for k in ("action_dist_inputs", "vf"):
        np.testing.assert_allclose(pout[k].detach().numpy(),
                                   np.asarray(out[k]), rtol=1e-5, atol=1e-6)
    ja, jlp, jv = jm.forward_exploration(params, obs, jax.random.PRNGKey(5))
    with torch.no_grad():
        pa, plp, pv = pm.forward_exploration(
            torch.from_numpy(obs), tf.prng_key(torch.tensor(5)))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=2e-5)
    _assert_logp(plp, jlp, pa / 2.0, np.asarray(ja) / 2.0)
    np.testing.assert_allclose(
        pm.forward_inference(torch.from_numpy(obs)).detach().numpy(),
        np.asarray(jm.forward_inference(params, obs)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("learner", ["sac", "cql"])
def test_one_update_matches_jax(learner):
    """One update from the same weights, batch and key: the critic and
    actor losses, the clipped Adam step, the temperature's step and the
    polyak targets."""
    classes = ((jsac.SACLearner, sac.SACLearner) if learner == "sac"
               else (jcql.CQLLearner, cql.CQLLearner))
    lr = 3e-3
    jl, pl = _sac_pair(*classes, lr=lr, cql_alpha=2.0)
    batch = _transitions(np.random.default_rng(2), 128)
    jm, pm = jl.update(batch), pl.update(batch)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # Adam's first moment is a tenth of the clipped gradient, its second
    # a thousandth of its square: the gradient's tolerance
    adam = jl.opt_state[1][0]
    mus = _by_name(pl.module, _np(adam.mu))
    top = max(np.abs(m).max() for m in mus.values())
    for side, want in (("mu", mus), ("nu", _by_name(pl.module,
                                                    _np(adam.nu)))):
        for (name, _), m in zip(pl.module.named_parameters(),
                                pl.opt_state[side]):
            scale = top if side == "mu" else 10 * top ** 2
            np.testing.assert_allclose(m.numpy(), want[name], rtol=2e-4,
                                       atol=2e-4 * scale,
                                       err_msg=f"{side} {name}")
    # the first step moves each parameter by lr g / (|g| + eps): where
    # |g| is near eps, a gradient 1e-4 (of itself and of the largest)
    # apart moves it by up to lr times that over |g| + eps
    got = _by_name(pl.module, _np(jl.params))
    for name, p in pl.module.named_parameters():
        g = np.abs(mus[name]) / 0.1
        tol = 1e-6 + lr * 2e-4 * (g + 10 * top) / (g + 1e-5)
        err = np.abs(p.detach().numpy() - got[name])
        assert (err <= tol).all(), (name, (err - tol).max())
    # the targets move by tau of the parameters' step
    _assert_tree(pl.target, _np(jl.target_params), 1e-6, "target")
    np.testing.assert_allclose(pl.log_alpha.item(), float(jl.log_alpha),
                               rtol=0, atol=1e-6)
    if learner == "cql":
        assert "cql_penalty" in pm
    state = pl.get_state()
    assert set(state) >= {"params", "opt_state", "target_params",
                          "log_alpha"}


def test_cql_penalty_and_grads_match_jax():
    jl, pl = _sac_pair(jcql.CQLLearner, cql.CQLLearner, cql_alpha=2.0,
                       cql_n_actions=4)
    batch = _transitions(np.random.default_rng(3), 64)
    jpen = jl._make_critic_penalty()
    (jval, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpen(p, batch, jax.random.PRNGKey(9), 0.2),
        has_aux=True))(jl.params)
    val, aux = pl._penalty(_t(batch), tf.prng_key(torch.tensor(9)), 0.2)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(aux["cql_penalty"].item(),
                               float(jaux["cql_penalty"]), rtol=1e-5)
    _assert_grads(pl.module, torch.autograd.grad(val, pl.params),
                  _np(jgrads))


# -------------------------------------------------------------- offline

def _cartpole_batch(rng, n, returns=True):
    f = np.float32
    b = dict(obs=rng.normal(size=(n, 4)).astype(f),
             actions=rng.integers(0, 2, n).astype(np.int32))
    if returns:
        b["returns"] = (rng.normal(size=n) * 5).astype(f)
    return b


@pytest.mark.parametrize("algo", ["bc", "marwil"])
def test_bc_marwil_losses_and_grads_match_jax(algo):
    if algo == "bc":
        jcfg, pcfg = joff.BCConfig(), BCConfig()
        jl = joff.BCLearner(JCartPole().spec, jcfg.learner_hyperparams())
        pl = poff.BCLearner(CartPole().spec, pcfg.learner_hyperparams(),
                            device="cpu")
    else:
        jcfg, pcfg = joff.MARWILConfig(), MARWILConfig()
        jl = joff.MARWILLearner(JCartPole().spec, jcfg)
        pl = poff.MARWILLearner(CartPole().spec, pcfg, device="cpu")
    params_from_flax(pl.module, _np(jl.params))
    mb = _cartpole_batch(np.random.default_rng(4), 64, algo == "marwil")
    jmb = dict(mb)
    if algo == "marwil":
        # the JAX learner reads its running norm from a batch column,
        # the port's from its attribute
        jmb["_ma_sqd_adv"] = np.full(64, 3.7, np.float32)
        pl.ma_sqd_adv = float(np.float32(3.7))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jl.compute_loss, has_aux=True))(jl.params, jmb)
    loss, aux = pl.compute_loss(_t(mb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_grads(pl.module, torch.autograd.grad(
        loss, pl.params, allow_unused=True, materialize_grads=True),
        _np(jgrads))
    if algo == "marwil":
        # the running norm folds the batch's E[A^2] as the JAX one does
        for c in (jcfg, pcfg):
            c.num_epochs, c.minibatch_size = 1, 10 ** 9
        jl = joff.MARWILLearner(JCartPole().spec, jcfg)
        pl = poff.MARWILLearner(CartPole().spec, pcfg, device="cpu")
        params_from_flax(pl.module, _np(jl.params))
        jl._ma_rate = pl._ma_rate = 1e-3
        for _ in range(2):
            jm, pm = jl.update(mb), pl.update(mb)
            np.testing.assert_allclose(pm["sqd_adv"], jm["sqd_adv"],
                                       rtol=1e-5)
            np.testing.assert_allclose(pl.ma_sqd_adv, float(jl.ma_sqd_adv),
                                       rtol=1e-6)


def _rollout_batch(rng, T=8, B=3):
    f = np.float32
    return dict(obs=rng.normal(size=(T, B, 4)).astype(f),
                actions=rng.integers(0, 2, (T, B)).astype(np.int32),
                logp=rng.normal(size=(T, B)).astype(f),
                vf=rng.normal(size=(T, B)).astype(f),
                rewards=np.ones((T, B), f),
                dones=rng.random((T, B)) < 0.2,
                final_vf=rng.normal(size=B).astype(f),
                final_obs=rng.normal(size=(B, 4)).astype(f))


def test_shard_format_both_ways(tmp_path):
    """A shard the JAX record_samples writes loads in the port's
    OfflineData, and the reverse: the same keys, dtypes and values (the
    reward-to-go too); mixed shards fail as the reference's do."""
    batch = _rollout_batch(np.random.default_rng(6))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for i, gamma in enumerate((0.99, 0.9)):
        joff.record_samples(batch, jdir, shard_index=i, gamma=gamma)
        record_samples(batch, pdir, shard_index=i, gamma=gamma)
    for a, b in ((OfflineData(jdir), joff.OfflineData(pdir)),
                 (OfflineData(pdir), joff.OfflineData(jdir))):
        assert sorted(a.data) == sorted(b.data) == sorted(
            ["obs", "actions", "logp", "vf", "rewards", "dones", "returns"])
        for k in a.data:
            assert a.data[k].dtype == b.data[k].dtype, k
            np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=k)
        assert a.size == 48
        sa, sb = a.sample(16), b.sample(16)
        for k, v in sa.items():
            np.testing.assert_array_equal(v, sb[k])
    for name in sorted(os.listdir(jdir)):
        with np.load(os.path.join(jdir, name)) as zj, \
                np.load(os.path.join(pdir, name)) as zp:
            assert zj.files == zp.files
    joff.record_samples(batch, str(tmp_path / "mixed"), shard_index=0)
    record_samples(batch, str(tmp_path / "mixed"), shard_index=1,
                   gamma=0.99)
    with pytest.raises(ValueError, match="inconsistent row counts"):
        OfflineData(str(tmp_path / "mixed"))


# ----------------------------------------------------------------- gates

def _cpu(cfg):
    return cfg.resources(device="cpu")


FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke_data", "sac_pendulum_jax_init_seed0.npz")


def _fixture_tree():
    """The fixture's "layer/leaf" arrays as a flax tree."""
    tree = {}
    with np.load(FIXTURE) as z:
        for k in z.files:
            layer, leaf = k.split("/")
            tree.setdefault(layer, {})[leaf] = z[k]
    return tree


def test_sac_init_fixture_is_the_jax_draw():
    from tools.make_chip_fixtures import sac_init_arrays
    want = sac_init_arrays()
    with np.load(FIXTURE) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_sac_learns_pendulum():
    algo = _cpu(SACConfig()
                .environment("Pendulum-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(lr=3e-3, buffer_size=50_000, train_batch_size=256,
                          num_updates_per_iter=32,
                          num_steps_before_learning=1_000,
                          action_scale=2.0)
                .debugging(seed=0)).build()
    # the JAX SACLearner's draw: its SACModule's init at PRNGKey(seed)
    init = _fixture_tree()
    learner = algo.learner_group._local
    params_from_flax(learner.module, init)
    params_from_flax(learner.target, init)
    algo.env_runner_group.sync_weights(learner.get_weights())
    returns = []
    for _ in range(25):
        m = algo.step()
        if not np.isnan(m["episode_return_mean"]):
            returns.append(m["episode_return_mean"])
    algo.cleanup()
    # pendulum returns start ~-1200..-1600; learning shows clear movement up
    assert returns, "no episodes finished"
    assert max(returns[5:]) > returns[0] + 150, returns


def test_bc_from_recorded_samples(tmp_path):
    # record a few rollouts from a PPO-style default policy
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                             rollout_fragment_length=32)).build()
    for i in range(3):
        result = algo.env_runner_group.sample()
        record_samples(result["batch"], str(tmp_path / "data"),
                       shard_index=i)
    algo.cleanup()

    bc = _cpu(BCConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .offline_data(input_path=str(tmp_path / "data"))
              .training(lr=1e-3, num_updates_per_iter=8)).build()
    m1 = bc.step()
    m2 = bc.step()
    bc.cleanup()
    # the BC loss (negative data log-likelihood) must drop
    assert m2["learner/total_loss"] < m1["learner/total_loss"]


def _record_pendulum_transitions(out_dir, shards=4):
    """Mediocre-policy dataset: a briefly-trained SAC's rollouts."""
    algo = _cpu(SACConfig().environment("Pendulum-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                             rollout_fragment_length=64)
                .training(lr=3e-3, num_steps_before_learning=500,
                          num_updates_per_iter=8, action_scale=2.0)
                .debugging(seed=0)).build()
    os.makedirs(out_dir, exist_ok=True)
    for i in range(shards):
        algo.step()
        result = algo.env_runner_group.sample()
        trans = _to_transitions(result["batch"])
        np.savez(os.path.join(out_dir, f"shard-{i:05d}.npz"), **trans)
    algo.cleanup()


def test_cql_trains_offline(tmp_path):
    data = str(tmp_path / "pendulum")
    _record_pendulum_transitions(data)

    cfg = _cpu(CQLConfig().environment("Pendulum-v1")
               .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                            rollout_fragment_length=64)
               .offline_data(input_path=data)
               .training(lr=1e-3, num_updates_per_iter=16,
                         train_batch_size=256, action_scale=2.0)
               .debugging(seed=0))
    cfg.cql_alpha = 2.0
    algo = cfg.build()
    m1 = algo.step()
    pen_first = m1["learner/cql_penalty"]
    pen_last = pen_first
    for _ in range(6):
        m = algo.step()
        pen_last = m["learner/cql_penalty"]
    algo.cleanup()
    assert np.isfinite(pen_first) and np.isfinite(pen_last)
    # the optimizer drives the conservative gap (OOD Q minus data Q) down
    assert pen_last < pen_first, (pen_first, pen_last)


def test_cql_requires_next_obs(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    np.savez(d / "shard-00000.npz",
             obs=np.zeros((16, 3), np.float32),
             actions=np.zeros((16, 1), np.float32),
             rewards=np.zeros(16, np.float32),
             dones=np.zeros(16, np.float32))
    cfg = _cpu(CQLConfig().environment("Pendulum-v1")
               .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                            rollout_fragment_length=16)
               .offline_data(input_path=str(d)))
    with pytest.raises(ValueError, match="next_obs"):
        cfg.build()


def test_marwil_beats_bc_weighting(tmp_path):
    """MARWIL: advantage-weighted cloning trains from shards carrying
    reward-to-go; weights respond to advantages (mean_weight != 1) and
    the value head fits returns."""
    algo = _cpu(PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                             rollout_fragment_length=64)).build()
    for i in range(3):
        result = algo.env_runner_group.sample()
        record_samples(result["batch"], str(tmp_path / "data"),
                       shard_index=i, gamma=0.99)
    algo.cleanup()

    marwil = _cpu(MARWILConfig().environment("CartPole-v1")
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                               rollout_fragment_length=32)
                  .offline_data(input_path=str(tmp_path / "data"))
                  .training(lr=1e-3, num_updates_per_iter=8)
                  .debugging(seed=0)).build()
    m1 = marwil.step()
    for _ in range(4):
        m = marwil.step()
    marwil.cleanup()
    assert np.isfinite(m["learner/total_loss"])
    # value head is learning the recorded returns
    assert m["learner/vf_loss"] < m1["learner/vf_loss"], (
        m1["learner/vf_loss"], m["learner/vf_loss"])
    # advantage weighting is active (not plain BC)
    assert abs(m["learner/mean_weight"] - 1.0) > 1e-3


def test_marwil_requires_returns(tmp_path):
    d = tmp_path / "noreturns"
    d.mkdir()
    np.savez(d / "shard-00000.npz",
             obs=np.zeros((16, 4), np.float32),
             actions=np.zeros(16, np.int32),
             rewards=np.zeros(16, np.float32),
             dones=np.zeros(16, np.float32))
    cfg = _cpu(MARWILConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                            rollout_fragment_length=16)
               .offline_data(input_path=str(d)))
    with pytest.raises(ValueError, match="returns"):
        cfg.build()


def test_refusals():
    with pytest.raises(ValueError, match="num_learners"):
        _cpu(SACConfig().environment("Pendulum-v1")
             .learners(num_learners=2)).build()
    with pytest.raises(ValueError, match="num_learners"):
        _cpu(MARWILConfig().environment("CartPole-v1")
             .learners(num_learners=2)
             .offline_data(input_path="unused")).build()
    with pytest.raises(ValueError, match="continuous"):
        _cpu(SACConfig().environment("CartPole-v1")).build()
    with pytest.raises(ValueError, match="framestack"):
        _cpu(BCConfig().environment("CartPole-v1")
             .env_runners(framestack=2)
             .offline_data(input_path="unused")).build()
    with pytest.raises(ValueError, match="input_path"):
        _cpu(BCConfig().environment("CartPole-v1")).build()
