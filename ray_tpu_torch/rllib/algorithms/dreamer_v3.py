"""DreamerV3: model-based RL — learn a world model, act in imagination.

Counterpart of ``ray_tpu/rllib/algorithms/dreamer_v3.py`` (reference
parity: rllib/algorithms/dreamerv3, Hafner et al. 2023), compact as the
JAX build is:

- **World model**: encoder -> RSSM (GRU deterministic state + discrete
  categorical latents with unimix + straight-through sampling) with
  prior/posterior heads, plus decoder / reward / continue heads, all
  predictions in symlog space; the v3 dyn/rep KL split with free bits.
- **Behavior**: actor-critic trained in imagination — H-step prior
  rollouts from every posterior state, lambda-returns with predicted
  continues, percentile-EMA return normalization, REINFORCE actor +
  entropy. Imagination's features carry no gradient (the JAX build
  stops them), so the rollout runs under ``torch.no_grad``; the three
  parameter groups (world model, actor, critic) take one backward and
  one Adam each, each clipped by its own global norm (optax's
  ``multi_transform`` of ``clip_by_global_norm`` + adam chains).
- **Acting**: the world model filters observations online: the runner
  threads the recurrent state (h, z, a_prev) through its step loop and
  re-seeds finished envs from ``initial_state``.
- **Replay**: fragment ring buffer; training samples [B, L] windows with
  is_first flags.

The JAX build's ``lax.scan`` loops over the sequence (observe), the
horizon (imagine) and the lambda-return recursion are Python loops over
L and H; every key of a loop is split, and its Gumbel noise drawn,
before the loop, so the loops hold no host sync. Randomness is JAX's
stream (``threefry``), so one key gives the JAX build's samples.

No critic-EMA regularizer (as in the JAX build). Reward and value use
twohot regression over symexp-spaced bins (MSE fallback via
twohot_bins=0).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import threefry
from ..core.distributions import _batched
from ..core.learner import Adam, Learner
from ..core.rl_module import GRUCell, RLModule
from .algorithm import Algorithm, AlgorithmConfig


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot_encode(y_symlog, bins):
    """Distribute each symlog-space target over its two neighboring
    bins (Hafner et al. 2023 eq. for discretized regression)."""
    nb = bins.shape[0]
    y = torch.clamp(y_symlog, bins[0], bins[-1])
    idx = torch.clamp(torch.searchsorted(bins, y.contiguous()) - 1,
                      0, nb - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (y - lo) / torch.clamp(hi - lo, min=1e-8)
    onehot_lo = F.one_hot(idx, nb).to(y.dtype)
    onehot_hi = F.one_hot(idx + 1, nb).to(y.dtype)
    return onehot_lo * (1 - w_hi)[..., None] + onehot_hi * w_hi[..., None]


def twohot_ce(logits, y_symlog, bins):
    target = twohot_encode(y_symlog, bins)
    return -torch.sum(target * F.log_softmax(logits, -1), -1)


def twohot_mean(logits, bins):
    """Expected value in symlog space -> real space."""
    return symexp(torch.sum(F.softmax(logits, -1) * bins, -1))


class _MLP(nn.Module):
    """flax's ``_MLP``: Dense + silu per hidden, then a Dense out."""

    def __init__(self, n_in: int, hiddens: Sequence[int], out: int):
        super().__init__()
        dims = (n_in,) + tuple(hiddens) + (out,)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))

    def flax_layers(self, prefix: str):
        return [(f"{prefix}/Dense_{i}", m, "lecun")
                for i, m in enumerate(self.layers)]

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.silu(layer(x))
        return self.layers[-1](x)


class _SeqCell(nn.Module):
    """h' = GRU(h, f(z, a)) — the RSSM deterministic path."""

    def __init__(self, zdim: int, num_actions: int, units: int, deter: int):
        super().__init__()
        self.inp = nn.Linear(zdim + num_actions, units)
        self.gru = GRUCell(units, deter)

    def flax_layers(self, prefix: str):
        return [(f"{prefix}/Dense_0", self.inp, "lecun"),
                (f"{prefix}/GRUCell_0", self.gru, "gru")]

    def forward(self, h, z_flat, a_onehot):
        x = F.silu(self.inp(torch.cat([z_flat, a_onehot], -1)))
        return self.gru(h, x)


def _unimix_logits(logits, classes, unimix):
    probs = F.softmax(logits, -1)
    probs = (1.0 - unimix) * probs + unimix / classes
    return torch.log(probs)


def _sample_latent(logits, noise, stoch, classes, unimix):
    """Straight-through categorical sample -> flat one-hot [.., S*C];
    `noise` is the Gumbel draw ``jax.random.categorical`` adds, shaped
    [.., S, C]."""
    lg = _unimix_logits(logits.reshape(logits.shape[:-1] + (stoch, classes)),
                        classes, unimix)
    idx = torch.argmax(noise + lg, dim=-1)
    onehot = F.one_hot(idx, classes).to(lg.dtype)
    probs = F.softmax(lg, -1)
    st = onehot + probs - probs.detach()
    return st.reshape(st.shape[:-2] + (stoch * classes,))


def _kl_categorical(lp, lq, stoch, classes):
    """KL(p || q) for flat [.., S*C] logits, summed over latent dims."""
    shape = lp.shape[:-1] + (stoch, classes)
    p = F.softmax(lp.reshape(shape), -1)
    logp = F.log_softmax(lp.reshape(shape), -1)
    logq = F.log_softmax(lq.reshape(shape), -1)
    return torch.sum(p * (logp - logq), dim=(-2, -1))


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _gumbel(keys, shape):
    """``jax.random.gumbel`` of `shape` for each key of a batch."""
    return _batched(keys, math.prod(shape), shape, threefry.gumbel)


def _halves(keys):
    """``k1, k2 = jax.random.split(key)`` over batched keys."""
    a, b = threefry.split(keys)
    return (a[..., 0], b[..., 0]), (a[..., 1], b[..., 1])


class DreamerV3Module(RLModule):
    """World model + actor + critic; recurrent acting via
    initial_state / explore_with(obs, noise, state)."""

    def __init__(self, spec, deter: int = 256, stoch: int = 8,
                 classes: int = 8, units: int = 128, embed: int = 128,
                 unimix: float = 0.01, twohot_bins: int = 63):
        if not spec.discrete:
            raise ValueError("this DreamerV3 build supports discrete "
                             "action spaces")
        super().__init__(spec)
        self.deter, self.stoch, self.classes = deter, stoch, classes
        self.units, self.unimix = units, unimix
        self.zdim = stoch * classes
        A = spec.num_actions
        D = spec.obs_dim
        feat = deter + self.zdim
        self.nbins = int(twohot_bins)
        if self.nbins == 1:
            raise ValueError(
                "twohot_bins must be 0 (scalar symlog-MSE heads) or "
                ">= 2 — a single bin makes the CE loss identically "
                "zero and the heads untrainable")
        head_out = self.nbins if self.nbins else 1
        self.enc = _MLP(D, (units, units), embed)
        self.cell = _SeqCell(self.zdim, A, units, deter)
        self.prior = _MLP(deter, (units,), self.zdim)
        self.post = _MLP(deter + embed, (units,), self.zdim)
        self.dec = _MLP(feat, (units, units), D)
        self.rew = _MLP(feat + A, (units,), head_out)
        self.cont = _MLP(feat + A, (units,), 1)
        self.actor = _MLP(feat, (units, units), A)
        self.critic = _MLP(feat, (units, units), head_out)
        # symlog-spaced twohot bins (float32, as jnp.linspace makes them)
        self.register_buffer(
            "bins", torch.from_numpy(np.asarray(
                np.linspace(-20.0, 20.0, self.nbins), np.float32))
            if self.nbins else torch.zeros(0), persistent=False)
        self._feat = feat

    def flax_layers(self):
        out = []
        for name in ("enc", "cell", "prior", "post", "dec", "rew", "cont"):
            out += getattr(self, name).flax_layers(f"wm/{name}")
        return (out + self.actor.flax_layers("actor")
                + self.critic.flax_layers("critic"))

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        """The JAX build's {wm, actor, critic} parameter trees."""
        wm = [p for name in ("enc", "cell", "prior", "post", "dec", "rew",
                             "cont") for p in getattr(self, name).parameters()]
        return {"wm": wm, "actor": list(self.actor.parameters()),
                "critic": list(self.critic.parameters())}

    # ------------------------------------------------------- wm functions
    def _step_h(self, h, z, a_onehot):
        return self.cell(h, z, a_onehot)

    def _posterior(self, h, obs):
        embed = self.enc(obs)
        return self.post(torch.cat([h, embed], -1))

    def _head_mean(self, pred):
        """Raw head output -> real-space scalar (twohot expectation or
        symexp of the scalar head)."""
        if self.nbins:
            return twohot_mean(pred, self.bins)
        return symexp(pred[..., 0])

    def _head_loss(self, pred, y_symlog):
        """Regression loss of a raw head output toward a symlog-space
        target — one definition for reward and critic."""
        if self.nbins:
            return twohot_ce(pred, y_symlog, self.bins)
        return (pred[..., 0] - y_symlog) ** 2

    def _reward(self, feat, a_onehot, raw=False):
        pred = self.rew(torch.cat([feat, a_onehot], -1))
        return pred if raw else self._head_mean(pred)

    def _cont_logit(self, feat, a_onehot):
        return self.cont(torch.cat([feat, a_onehot], -1))[..., 0]

    def _value(self, feat, raw=False):
        pred = self.critic(feat)
        return pred if raw else self._head_mean(pred)

    # ----------------------------------------------------- runner protocol
    def initial_state(self, batch_size: int):
        dev = self.bins.device
        return (torch.zeros(batch_size, self.deter, device=dev),
                torch.zeros(batch_size, self.zdim, device=dev),
                torch.zeros(batch_size, self.spec.num_actions, device=dev))

    def exploration_noise(self, key, batch: int):
        """``k1, k2 = split(key)``: the latent's Gumbel noise from k1,
        the action's from k2."""
        k1, k2 = _halves(key)
        return (_gumbel(k1, (batch, self.stoch, self.classes)),
                _gumbel(k2, (batch, self.spec.num_actions)))

    def explore_with(self, obs, noise, state):
        h, z, a_prev = state
        h = self._step_h(h, z, a_prev)
        z = _sample_latent(self._posterior(h, symlog(obs)), noise[0],
                           self.stoch, self.classes, self.unimix)
        feat = torch.cat([h, z], -1)
        logits = self.actor(feat)
        action = torch.argmax(noise[1] + logits, dim=-1)
        logp = F.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
        vf = self._value(feat)
        a_onehot = F.one_hot(action, self.spec.num_actions).to(feat.dtype)
        return action, logp, vf, (h, z, a_onehot)

    def forward_exploration(self, obs, key, state):
        return self.explore_with(
            obs, self.exploration_noise(key, obs.shape[0]), state)

    # the stateless hooks exist for runner bookkeeping only (final_vf
    # bootstrap is unused by Dreamer's replay training)
    def forward(self, obs):
        b = obs.shape[0]
        return {"action_dist_inputs": torch.zeros(
                    b, self.spec.num_actions, device=obs.device),
                "vf": torch.zeros(b, device=obs.device)}


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(DreamerV3)
        self.lr_world = 4e-4
        self.lr_actor = 1e-4
        self.lr_critic = 1e-4
        self.grad_clip = 100.0
        self.seq_len = 16
        self.batch_seqs = 16
        self.imagine_horizon = 15
        self.buffer_fragments = 200
        self.num_updates_per_iter = 4
        self.free_bits = 1.0
        self.kl_dyn = 1.0
        self.kl_rep = 0.1
        self.lam = 0.95
        self.entropy = 3e-3
        self.unimix = 0.01
        self.twohot_bins = 63        # 0 = scalar symlog-MSE heads
        self.model_size: Dict[str, int] = {}   # deter/stoch/classes/units


class _FragmentReplay:
    """Ring of rollout fragments; samples [B, L] windows (per-env
    columns) with is_first at the window head + in-window boundaries."""

    def __init__(self, capacity: int, seq_len: int, seed: int = 0):
        self.capacity = capacity
        self.L = seq_len
        self.frags: list = []
        self.rng = np.random.default_rng(seed)

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        frag = {k: np.asarray(batch[k]) for k in
                ("obs", "actions", "rewards", "dones")}
        if frag["obs"].shape[0] < self.L:
            return                      # fragment shorter than a window
        self.frags.append(frag)
        if len(self.frags) > self.capacity:
            self.frags.pop(0)

    def __len__(self):
        return len(self.frags)

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        out = {k: [] for k in ("obs", "actions", "rewards", "dones",
                               "is_first")}
        for _ in range(n):
            f = self.frags[self.rng.integers(len(self.frags))]
            T, B = f["actions"].shape[:2]
            b = int(self.rng.integers(B))
            s = int(self.rng.integers(T - self.L + 1))
            sl = slice(s, s + self.L)
            out["obs"].append(f["obs"][sl, b])
            out["actions"].append(f["actions"][sl, b])
            out["rewards"].append(f["rewards"][sl, b])
            dones = f["dones"][sl, b].astype(np.float32)
            out["dones"].append(dones)
            isf = np.zeros(self.L, np.float32)
            isf[0] = 1.0
            isf[1:] = dones[:-1]
            out["is_first"].append(isf)
        return {k: np.stack(v) for k, v in out.items()}


class DreamerV3Learner(Learner):
    def __init__(self, spec, config: DreamerV3Config, device=None):
        self._cfg = config
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)
        # per-group learning rates over {wm, actor, critic}, each clipped
        # by its own global norm (optax.multi_transform)
        self.groups = self.module.param_groups()
        lrs = {"wm": config.lr_world, "actor": config.lr_actor,
               "critic": config.lr_critic}
        self.optimizers = {g: Adam(lrs[g], config.grad_clip, eps=1e-8)
                           for g in self.groups}
        self.opt_states = {g: self.optimizers[g].init(ps)
                           for g, ps in self.groups.items()}
        self.optimizer = self.opt_state = None
        # return-normalization EMA of the 5th..95th percentile spread
        self.ret_scale = 1.0
        self._key = threefry.prng_key(
            torch.tensor(config.seed + 1, device=self.device))

    def _observe(self, obs, actions, is_first, noise):
        """Posterior filtering over one [B, L] sequence batch; `noise`
        the latents' Gumbel draws [L, B, S, C]. Returns [B, L, ...]."""
        m = self.module
        B, L = actions.shape
        A = m.spec.num_actions
        a_onehot = F.one_hot(actions.long(), A).to(obs.dtype)
        h = obs.new_zeros(B, m.deter)
        z = obs.new_zeros(B, m.zdim)
        aprev = obs.new_zeros(B, A)
        hs, zs, priors, posts = [], [], [], []
        for t in range(L):
            keep = 1.0 - is_first[:, t][:, None]
            h, z, aprev = h * keep, z * keep, aprev * keep
            h = m._step_h(h, z, aprev)
            prior_lg = m.prior(h)
            post_lg = m._posterior(h, obs[:, t])
            z = _sample_latent(post_lg, noise[t], m.stoch, m.classes,
                               m.unimix)
            aprev = a_onehot[:, t]
            hs.append(h)
            zs.append(z)
            priors.append(prior_lg)
            posts.append(post_lg)
        st = lambda xs: torch.stack(xs, 1)
        return st(hs), st(zs), st(priors), st(posts)

    @torch.no_grad()
    def _imagine(self, h, z, noise):
        """H-step prior rollout from flattened start states; `noise` the
        (actions', latents') Gumbel draws [H, N, A] and [H, N, S, C].
        Returns [H, N, ...]."""
        m = self.module
        A = m.spec.num_actions
        feats, acts, rews, conts = [], [], [], []
        for t in range(noise[0].shape[0]):
            feat = torch.cat([h, z], -1)
            logits = m.actor(feat)
            a = torch.argmax(noise[0][t] + logits, dim=-1)
            a1 = F.one_hot(a, A).to(feat.dtype)
            rews.append(m._reward(feat, a1))
            conts.append(torch.sigmoid(m._cont_logit(feat, a1)))
            h = m._step_h(h, z, a1)
            z = _sample_latent(m.prior(h), noise[1][t], m.stoch, m.classes,
                               m.unimix)
            feats.append(feat)
            acts.append(a)
        st = torch.stack
        return st(feats), st(acts), st(rews), st(conts)

    def _draw(self, key, B, L):
        """The update's Gumbel noise, split from `key` as the JAX build
        splits it: (k_obs, k_img); L observe keys; H imagine keys, each
        split into the action's and the latent's."""
        m, cfg = self.module, self._cfg
        H, N = cfg.imagine_horizon, B * L
        k_obs, k_img = _halves(key)
        obs_noise = _gumbel(threefry.split(k_obs, L),
                            (B, m.stoch, m.classes))
        k1, k2 = _halves(threefry.split(k_img, H))
        return obs_noise, (_gumbel(k1, (N, m.spec.num_actions)),
                           _gumbel(k2, (N, m.stoch, m.classes)))

    def _loss(self, batch, noise, ret_scale):
        m, cfg = self.module, self._cfg
        A = m.spec.num_actions
        H = cfg.imagine_horizon
        gamma, lam = cfg.gamma, cfg.lam
        obs_noise, img_noise = noise
        obs = symlog(batch["obs"])
        actions = batch["actions"].long()
        hs, zs, priors, posts = self._observe(obs, actions,
                                              batch["is_first"], obs_noise)
        feat = torch.cat([hs, zs], -1)
        a1 = F.one_hot(actions, A).to(feat.dtype)
        # --- world-model losses ---
        recon = m.dec(feat)
        l_rec = torch.mean(torch.sum((recon - obs) ** 2, -1))
        r_pred = m._reward(feat, a1, raw=True)
        l_rew = torch.mean(m._head_loss(r_pred, symlog(batch["rewards"])))
        c_logit = m._cont_logit(feat, a1)
        l_cont = torch.mean(_sigmoid_bce(c_logit, 1.0 - batch["dones"]))

        # KL over the same unimix-mixed distributions the latents are
        # sampled from
        def mix(lg):
            shaped = lg.reshape(lg.shape[:-1] + (m.stoch, m.classes))
            return _unimix_logits(shaped, m.classes, m.unimix).reshape(
                lg.shape)
        priors_u, posts_u = mix(priors), mix(posts)
        kl_dyn = _kl_categorical(posts_u.detach(), priors_u, m.stoch,
                                 m.classes)
        kl_rep = _kl_categorical(posts_u, priors_u.detach(), m.stoch,
                                 m.classes)
        l_kl = (cfg.kl_dyn * torch.mean(torch.clamp(kl_dyn,
                                                    min=cfg.free_bits))
                + cfg.kl_rep * torch.mean(torch.clamp(kl_rep,
                                                      min=cfg.free_bits)))
        wm_loss = l_rec + l_rew + l_cont + l_kl

        # --- imagination (no gradient reaches the loss through it) ---
        B, L = actions.shape
        feats, acts, rews, conts = self._imagine(
            hs.detach().reshape(B * L, -1), zs.detach().reshape(B * L, -1),
            img_noise)
        v_logits = m._value(feats, raw=True)
        values = m._head_mean(v_logits)                   # [H, N]
        # lambda-returns: R_t = r_t + gamma c_t ((1-lam) V_{t+1} +
        # lam R_{t+1}); the last state's value self-bootstraps
        with torch.no_grad():
            disc = gamma * conts
            vnext = torch.cat([values[1:], values[-1:]], 0)
            nxt = vnext[-1]
            rets: List[torch.Tensor] = [None] * H
            for t in range(H - 1, -1, -1):
                nxt = rews[t] + disc[t] * ((1 - lam) * vnext[t] + lam * nxt)
                rets[t] = nxt
            rets_sg = torch.stack(rets)                   # [H, N]
        l_critic = torch.mean(m._head_loss(v_logits, symlog(rets_sg)))
        # actor: REINFORCE with percentile-normalized advantage
        logp_all = F.log_softmax(m.actor(feats), -1)
        logp = logp_all.gather(-1, acts[..., None])[..., 0]
        adv = (rets_sg - values.detach()) / torch.clamp(ret_scale, min=1.0)
        ent = -torch.sum(torch.exp(logp_all) * logp_all, -1)
        l_actor = -torch.mean(logp * adv) - cfg.entropy * torch.mean(ent)

        total = wm_loss + l_actor + l_critic
        flat = rets_sg.reshape(-1)
        new_scale = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
        aux = {"total_loss": total, "wm_loss": wm_loss,
               "recon_loss": l_rec, "reward_loss": l_rew,
               "cont_loss": l_cont, "kl_loss": l_kl,
               "actor_loss": l_actor, "critic_loss": l_critic,
               "entropy": torch.mean(ent),
               "imag_return_mean": torch.mean(rets_sg),
               "ret_spread": new_scale}
        return total, aux

    def _dreamer_step(self, batch, key, ret_scale):
        """One update on device tensors, no host sync: the loss, one
        backward over every group, one clipped Adam step a group."""
        B, L = batch["actions"].shape
        total, aux = self._loss(batch, self._draw(key, B, L), ret_scale)
        grads = torch.autograd.grad(total, self.params, allow_unused=True,
                                    materialize_grads=True)
        by_param = dict(zip(map(id, self.params), grads))
        for g, ps in self.groups.items():
            self.optimizers[g].step_(ps, [by_param[id(p)] for p in ps],
                                     self.opt_states[g])
        return {k: v.detach() for k, v in aux.items()}

    def _next_key(self):
        self._key, sub = _halves(self._key)
        return sub

    def update(self, train_batch: Dict[str, Any]) -> Dict[str, float]:
        batch = self._to_device(train_batch)
        scale = torch.tensor(self.ret_scale, dtype=torch.float32,
                             device=self.device)
        aux = self._dreamer_step(batch, self._next_key(), scale)
        keys = list(aux)
        vals = torch.stack([aux[k] for k in keys]).cpu().tolist()
        out = dict(zip(keys, vals))
        spread = out.pop("ret_spread")
        self.ret_scale = 0.99 * self.ret_scale + 0.01 * max(spread, 1e-8)
        return out

    def get_state(self):
        names = {id(p): k for k, p in self.module.named_parameters()}
        host = lambda ps, ts: {names[id(p)]: t.detach().cpu().numpy()
                               for p, t in zip(ps, ts)}
        return {"params": {k: v.detach().cpu().numpy()
                           for k, v in self.module.named_parameters()},
                "opt_state": {
                    g: {"count": st["count"],
                        "mu": host(self.groups[g], st["mu"]),
                        "nu": host(self.groups[g], st["nu"])}
                    for g, st in self.opt_states.items()},
                "ret_scale": self.ret_scale}

    @torch.no_grad()
    def set_state(self, state) -> None:
        params = dict(self.module.named_parameters())
        for k, p in params.items():
            p.copy_(torch.as_tensor(np.asarray(state["params"][k])))
        names = {id(p): k for k, p in params.items()}
        for g, st in self.opt_states.items():
            src = state["opt_state"][g]
            for side in ("mu", "nu"):
                for p, t in zip(self.groups[g], st[side]):
                    t.copy_(torch.as_tensor(np.asarray(
                        src[side][names[id(p)]])))
            st["count"] = int(src["count"])
        self.ret_scale = state.get("ret_scale", 1.0)


class DreamerV3(Algorithm):
    @classmethod
    def default_config(cls) -> DreamerV3Config:
        return DreamerV3Config()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> DreamerV3Learner:
        return DreamerV3Learner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is None:
            algo_cfg = type(self).default_config().update_from_dict(config)
        if algo_cfg.num_learners > 1:
            raise ValueError("DreamerV3 supports num_learners <= 1")
        if algo_cfg.module_class is None:
            algo_cfg.module_class = DreamerV3Module
            algo_cfg.model_config = dict(algo_cfg.model_config,
                                         unimix=algo_cfg.unimix,
                                         twohot_bins=algo_cfg.twohot_bins,
                                         **algo_cfg.model_size)
        if algo_cfg.rollout_fragment_length < algo_cfg.seq_len:
            raise ValueError(
                f"rollout_fragment_length "
                f"({algo_cfg.rollout_fragment_length}) must be >= "
                f"seq_len ({algo_cfg.seq_len}) — shorter fragments "
                f"can never yield a training window, and the replay "
                f"would silently stay empty forever")
        super().setup({"_algo_config": algo_cfg})
        self.replay = _FragmentReplay(algo_cfg.buffer_fragments,
                                      algo_cfg.seq_len,
                                      seed=algo_cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._config
        result = self.env_runner_group.sample()
        self.replay.add(result["batch"])
        learner_metrics: Dict[str, float] = {}
        if len(self.replay) >= 2:
            for _ in range(cfg.num_updates_per_iter):
                learner_metrics = self.learner_group.update(
                    self.replay.sample(cfg.batch_seqs))
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        return self._roll_metrics(result["stats"], learner_metrics)
