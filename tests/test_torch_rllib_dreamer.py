"""ray_tpu_torch.rllib's DreamerV3 against ray_tpu.rllib's, on the CPU,
plus the reference's gates (``tests/test_rllib_dreamer.py``) that run
here in seconds; its CartPole learning gate (up to 120 iterations) runs
on the card, in chip_smoke.py's phase 6e.

Parity, float32, the same numpy inputs, weights and keys on both sides:
- the GRU cell alone against flax's ``nn.GRUCell``: 1e-6;
- symlog/symexp, twohot encode/CE, the unimix logits and the
  categorical KL: 1e-6 relative (1e-6 absolute near 0); the twohot mean
  1e-5 relative and 5e-6 absolute (a sum of probabilities times bins
  of up to +-20 that cancels toward 0);
- the straight-through latent sample and the recurrent exploration step
  from one key: the same samples (argmax of the same Gumbel draws, which
  are 2^-22 x max(1, |g|) apart, ``test_torch_threefry.py``), values
  1e-5;
- the runner's recurrent branch against the JAX runner, two fragments
  (the state carried across them, finished envs re-seeded): actions and
  dones equal, obs 1e-4 (``test_torch_rllib_env.py``);
- one update (observe, world-model losses, imagination, lambda-returns,
  critic and actor losses, three clipped Adam steps): its metrics 1e-4
  relative (1e-5 absolute); each group's first Adam moment (a tenth of
  the clipped gradient) 1e-4 relative plus 1e-4 of the group's largest;
  parameters 1e-6 plus what Adam's first step, lr g / (|g| + 1e-8),
  makes of that where |g| is small; the return-scale EMA 1e-5.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import dreamer_v3 as jd
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu.rllib.env.jax_env import CartPole as JCartPole
from ray_tpu_torch.ops import threefry as tf
from ray_tpu_torch.rllib import DreamerV3Config
from ray_tpu_torch.rllib.algorithms import dreamer_v3 as pd
from ray_tpu_torch.rllib.core.rl_module import GRUCell, params_from_flax
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.torch_env import CartPole

SMALL = dict(deter=32, stoch=4, classes=4, units=32, embed=24,
             unimix=0.01, twohot_bins=15)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _named(module, tree):
    """A flax tree as the port module's parameters by name (loaded into
    a copy through params_from_flax)."""
    m = params_from_flax(copy.deepcopy(module), tree)
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


def _pair(**over):
    jm = jd.DreamerV3Module(JCartPole().spec, **dict(SMALL, **over))
    pm = pd.DreamerV3Module(CartPole().spec, **dict(SMALL, **over))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3))
    params_from_flax(pm, _np(params))
    return jm, pm, params


# ------------------------------------------------------------ the pieces

def test_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    cell = fnn.GRUCell(24)
    h = rng.normal(size=(5, 24)).astype(np.float32)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(1), h, x)
    # nonzero biases, so every bias lands where it belongs
    params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.normal(size=a.shape).astype(np.float32),
        _np(params))
    want, _ = cell.apply(params, h, x)
    pc = GRUCell(16, 24)
    pc.load_flax(params["params"])
    _close(pc(_t(h), _t(x)).detach(), want, rtol=0, atol=1e-6)
    # the port's own draw: flax's families (orthogonal recurrent gates)
    pc.init_parameters(torch.Generator().manual_seed(0))
    for g in range(3):
        w = pc.weight_hh[g * 24:(g + 1) * 24].detach().numpy()
        _close(w @ w.T, np.eye(24), atol=1e-5)
    assert not pc.bias_ih.any() and not pc.bias_hn.any()


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64,)) * 30).astype(np.float32)
    _close(pd.symlog(_t(x)), jd.symlog(x), rtol=1e-6)
    y = (rng.normal(size=(64,)) * 3).astype(np.float32)
    _close(pd.symexp(_t(y)), jd.symexp(y), rtol=1e-6)
    bins = np.linspace(-20.0, 20.0, 15).astype(np.float32)
    ys = np.concatenate([(rng.normal(size=60) * 12).astype(np.float32),
                         np.float32([-25.0, 25.0, bins[3], 0.0])])
    _close(pd.twohot_encode(_t(ys), _t(bins)),
           jd.twohot_encode(ys, bins), atol=1e-6)
    logits = rng.normal(size=(64, 15)).astype(np.float32)
    _close(pd.twohot_ce(_t(logits), _t(ys), _t(bins)),
           jd.twohot_ce(logits, ys, bins), rtol=1e-6)
    _close(pd.twohot_mean(_t(logits), _t(bins)),
           jd.twohot_mean(logits, bins), rtol=1e-5, atol=5e-6)
    lp, lq = (rng.normal(size=(2, 7, 4 * 5)) * 2).astype(np.float32)
    _close(pd._kl_categorical(_t(lp), _t(lq), 4, 5),
           jd._kl_categorical(lp, lq, 4, 5), rtol=1e-5, atol=1e-6)
    shaped = lp.reshape(7, 4, 5)
    _close(pd._unimix_logits(_t(shaped), 5, 0.01),
           jd._unimix_logits(shaped, 5, 0.01), rtol=1e-6)
    # the straight-through sample from one key: same one-hots, same
    # probabilities riding on them
    key = jax.random.PRNGKey(7)
    want = jd._sample_latent(lp, key, 4, 5, 0.01)
    noise = pd._gumbel(tf.prng_key(torch.tensor(7)), (7, 4, 5))
    got = pd._sample_latent(_t(lp), noise, 4, 5, 0.01)
    np.testing.assert_array_equal(np.round(got.numpy()),
                                  np.round(np.asarray(want)))
    _close(got, want, atol=1e-6)


def test_exploration_step_matches_jax():
    """forward_exploration with a recurrent state, three steps, one key
    each: actions, log-probs, values and the carried state."""
    jm, pm, params = _pair()
    rng = np.random.default_rng(2)
    jstate = jm.initial_state(params, 6)
    pstate = pm.initial_state(6)
    explore = jax.jit(jm.forward_exploration)
    for step in range(3):
        obs = rng.normal(size=(6, 4)).astype(np.float32)
        ja, jlp, jv, jstate = explore(
            params, obs, jax.random.PRNGKey(10 + step), jstate)
        with torch.no_grad():
            pa, plp, pv, pstate = pm.forward_exploration(
                _t(obs), tf.prng_key(torch.tensor(10 + step)), pstate)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        _close(plp, jlp, rtol=1e-5, atol=1e-6, what="logp")
        _close(pv, jv, rtol=1e-5, atol=1e-5, what="vf")
        for g, w in zip(pstate, jstate):
            _close(g, w, rtol=1e-5, atol=1e-5, what="state")


def test_runner_recurrent_branch_matches_jax():
    """Two fragments of the port's runner against the JAX runner on the
    same weights: the recurrent state carries across fragments and a
    finished env restarts from initial_state."""
    kw = dict(module_class=jd.DreamerV3Module, model_config=SMALL)
    jr = JRunner("CartPole-v1", num_envs=4, rollout_length=48, seed=5,
                 **kw)
    pr = SingleAgentEnvRunner("CartPole-v1", num_envs=4, rollout_length=48,
                              seed=5, module_class=pd.DreamerV3Module,
                              model_config=SMALL, device="cpu")
    params_from_flax(pr.module, _np(jr.params))
    for _ in range(2):
        jb, pb = jr.sample(), pr.sample()
        np.testing.assert_array_equal(pb["batch"]["actions"],
                                      jb["batch"]["actions"])
        np.testing.assert_array_equal(pb["batch"]["dones"],
                                      jb["batch"]["dones"])
        _close(pb["batch"]["obs"], jb["batch"]["obs"], rtol=0, atol=1e-4)
        _close(pb["batch"]["vf"], jb["batch"]["vf"], rtol=1e-4, atol=1e-4)
        assert pb["stats"]["num_episodes"] == jb["stats"]["num_episodes"]
    assert pb["batch"]["dones"].any()       # some env restarted
    for g, w in zip(pr._mstate, jr._mstate):
        _close(g, w, rtol=1e-4, atol=1e-4, what="carried state")


def _learners():
    cfgs = []
    for c in (jd.DreamerV3Config(), DreamerV3Config()):
        c.module_class = (jd.DreamerV3Module if isinstance(
            c, jd.DreamerV3Config) else pd.DreamerV3Module)
        c.model_config = dict(SMALL)
        c.seq_len, c.imagine_horizon = 8, 6
        cfgs.append(c)
    jl = jd.DreamerV3Learner(JCartPole().spec, cfgs[0])
    pl = pd.DreamerV3Learner(CartPole().spec, cfgs[1], device="cpu")
    params_from_flax(pl.module, _np(jl.params))
    return jl, pl


def _sequences(rng, B=6, L=8):
    f = np.float32
    dones = (rng.random((B, L)) < 0.15).astype(f)
    isf = np.zeros((B, L), f)
    isf[:, 0] = 1.0
    isf[:, 1:] = dones[:, :-1]
    return dict(obs=(rng.normal(size=(B, L, 4)) * 2).astype(f),
                actions=rng.integers(0, 2, (B, L)).astype(np.int32),
                rewards=np.ones((B, L), f), dones=dones, is_first=isf)


def test_one_update_matches_jax():
    jl, pl = _learners()
    batch = _sequences(np.random.default_rng(3))
    jm, pm = jl.update(batch), pl.update(batch)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        _close(pm[k], jm[k], rtol=1e-4, atol=1e-5, what=k)
    _close(pl.ret_scale, jl.ret_scale, rtol=1e-5)
    lrs = {"wm": 4e-4, "actor": 1e-4, "critic": 1e-4}
    names = {id(p): k for k, p in pl.module.named_parameters()}
    got = _named(pl.module, _np(jl.params))
    tree = {}
    for g, st in jl.opt_state.inner_states.items():
        tree[g] = _np(st.inner_state[1][0].mu[g])
    mus = _named(pl.module, tree)
    for g, ps in pl.groups.items():
        top = max(np.abs(mus[names[id(p)]]).max() for p in ps)
        for p, m in zip(ps, pl.opt_states[g]["mu"]):
            name = names[id(p)]
            _close(m.numpy(), mus[name], rtol=1e-4, atol=1e-4 * top,
                   what=f"mu {name}")
            g_abs = np.abs(mus[name]) / 0.1
            tol = 1e-6 + lrs[g] * 2e-4 * (g_abs + 10 * top) / (g_abs + 1e-8)
            err = np.abs(p.detach().numpy() - got[name])
            assert (err <= np.minimum(tol, 2 * lrs[g] + 1e-6)).all(), name
    assert pl.opt_states["wm"]["count"] == 1


def test_replay_matches_jax():
    rng = np.random.default_rng(4)
    jr, pr = jd._FragmentReplay(3, 8, seed=2), pd._FragmentReplay(3, 8, seed=2)
    for T in (16, 4, 12, 10, 9):
        frag = dict(obs=rng.normal(size=(T, 3, 4)).astype(np.float32),
                    actions=rng.integers(0, 2, (T, 3)),
                    rewards=np.ones((T, 3), np.float32),
                    dones=rng.random((T, 3)) < 0.2)
        jr.add(frag)
        pr.add(frag)
        assert len(pr) == len(jr)
    js, ps = jr.sample(5), pr.sample(5)
    for k in js:
        np.testing.assert_array_equal(ps[k], js[k])


# ----------------------------------------------------------------- gates

def _build(seed=0):
    return (DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .resources(device="cpu").debugging(seed=seed).build())


def test_dreamer_world_model_losses_fall():
    algo = _build()
    algo.train()
    first = algo.train()
    for _ in range(10):
        last = algo.train()
    assert np.isfinite(last["learner/total_loss"])
    assert last["learner/reward_loss"] < first["learner/reward_loss"]
    # free-bits floor: kl_dyn*max(.,1) + kl_rep*max(.,1) >= 1.0 + 0.1
    assert last["learner/kl_loss"] >= 1.1 - 1e-3
    assert np.isfinite(last["learner/imag_return_mean"])
    # the checkpoint round trip, the return-scale EMA included
    ckpt = algo.save()
    fresh = _build()
    fresh.restore(ckpt)
    a, b = algo.learner_group._local, fresh.learner_group._local
    assert b.ret_scale == a.ret_scale != 1.0
    for g in a.opt_states:
        assert b.opt_states[g]["count"] == a.opt_states[g]["count"] > 0
        for x, y in zip(a.opt_states[g]["nu"], b.opt_states[g]["nu"]):
            assert torch.equal(x, y)
    for (k, x), (_, y) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        assert torch.equal(x, y), k
    fresh.train()                 # the replay starts empty again
    assert np.isfinite(fresh.train()["learner/total_loss"])
    algo.stop()
    fresh.stop()


def test_dreamer_rejects_continuous_and_multi_learner():
    with pytest.raises(Exception):
        (DreamerV3Config().environment("Pendulum-v1")
         .env_runners(num_env_runners=0).resources(device="cpu").build())
    with pytest.raises(ValueError, match="num_learners"):
        (DreamerV3Config().environment("CartPole-v1")
         .learners(num_learners=2).resources(device="cpu").build())
    with pytest.raises(ValueError, match="seq_len"):
        (DreamerV3Config().environment("CartPole-v1")
         .env_runners(rollout_fragment_length=8)
         .resources(device="cpu").build())
