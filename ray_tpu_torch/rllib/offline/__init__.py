"""Offline RL: train from recorded experience, no live environment.

Counterpart of ``ray_tpu/rllib/offline/__init__.py`` (reference parity:
rllib/offline/offline_data.py + rllib/algorithms/bc and marwil).
Experiences are .npz shards of flat transition arrays, the JAX
package's format both ways: `record_samples` writes them from any
rollout batch, `OfflineData` samples minibatches from a directory of
shards.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..algorithms.algorithm import Algorithm, AlgorithmConfig
from ..core.learner import Learner

__all__ = ["record_samples", "OfflineData", "BC", "BCConfig", "BCLearner",
           "MARWIL", "MARWILConfig", "MARWILLearner"]


def record_samples(batch: Dict[str, np.ndarray], out_dir: str,
                   shard_index: int = 0,
                   gamma: Optional[float] = None) -> str:
    """Write one rollout batch ([T, B, ...]) as a flat .npz shard.
    Per-rollout extras (final_obs/final_vf, shape [B]) are dropped —
    shards hold per-TRANSITION arrays with one shared leading dim.

    With gamma set, per-transition discounted reward-to-go is computed
    while the [T, B] episode structure is still known (bootstrapped
    from final_vf when present) and stored as 'returns' — the input
    MARWIL's advantage weighting needs; flattened shards can't recover
    it."""
    os.makedirs(out_dir, exist_ok=True)
    t, b = np.asarray(batch["obs"]).shape[:2]
    flat = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim < 2 or v.shape[:2] != (t, b):
            continue
        flat[k] = v.reshape((t * b,) + v.shape[2:])
    if gamma is not None and "returns" not in flat:
        rew = np.asarray(batch["rewards"], np.float32)
        done = np.asarray(batch["dones"], np.float32)
        acc = np.asarray(batch.get("final_vf", np.zeros(b)), np.float32)
        rtg = np.zeros((t, b), np.float32)
        for i in range(t - 1, -1, -1):
            acc = rew[i] + gamma * (1.0 - done[i]) * acc
            rtg[i] = acc
        flat["returns"] = rtg.reshape(t * b)
    path = os.path.join(out_dir, f"shard-{shard_index:05d}.npz")
    np.savez(path, **flat)
    return path


class OfflineData:
    """Minibatch source over .npz shards (reference: OfflineData)."""

    def __init__(self, input_path: str, seed: int = 0):
        paths = sorted(glob.glob(os.path.join(input_path, "*.npz"))) \
            if os.path.isdir(input_path) else [input_path]
        if not paths:
            raise ValueError(f"no .npz shards under {input_path!r}")
        arrays: Dict[str, List[np.ndarray]] = {}
        for p in paths:
            with np.load(p) as z:
                for k in z.files:
                    arrays.setdefault(k, []).append(z[k])
        self.data = {k: np.concatenate(v) for k, v in arrays.items()}
        self.size = len(next(iter(self.data.values())))
        ragged = {k: len(v) for k, v in self.data.items()
                  if len(v) != self.size}
        if ragged:
            # e.g. a directory mixing shards recorded with and without
            # gamma= (only some carry 'returns') — fail loudly here, not
            # with a sporadic IndexError mid-training
            raise ValueError(
                f"shard keys have inconsistent row counts: {ragged} vs "
                f"{self.size}; were some shards recorded with different "
                "keys (e.g. only some with gamma=)?")
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.size, size=n)
        return {k: v[idx] for k, v in self.data.items()}


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BC)
        self.input_path: Optional[str] = None
        self.train_batch_size = 256
        self.num_updates_per_iter = 16

    def offline_data(self, *, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self


class BCLearner(Learner):
    """Maximize log-likelihood of the dataset's actions."""

    def compute_loss(self, mb):
        out = self.module.forward_train(mb["obs"])
        logp = self.module.dist.log_prob(
            out["action_dist_inputs"], mb["actions"])
        loss = -torch.mean(logp)
        return loss, {"total_loss": loss, "bc_logp": torch.mean(logp)}


class BC(Algorithm):
    @classmethod
    def default_config(cls) -> BCConfig:
        return BCConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> BCLearner:
        return BCLearner(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)

    def setup(self, config: Dict[str, Any]) -> None:
        pre = config.get("_algo_config")
        if pre is not None and getattr(pre, "framestack", 1) > 1 or \
                config.get("framestack", 1) > 1:
            raise ValueError(
                "framestack is not supported by offline algorithms: "
                "recorded datasets carry single-frame observations, "
                "which would mismatch a stacked learner module")
        super().setup(config)      # env used for spec + evaluation rollouts
        cfg = self._config
        if not getattr(cfg, "input_path", None):
            raise ValueError("BC requires .offline_data(input_path=...)")
        self.offline = OfflineData(cfg.input_path, seed=cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._config
        learner_metrics: Dict[str, float] = {}
        for _ in range(cfg.num_updates_per_iter):
            learner_metrics = self.learner_group.update(
                self.offline.sample(cfg.train_batch_size))
        # evaluation rollout with the learned policy (also refreshes the
        # sampler weights so metrics reflect the current params)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.env_runner_group.sample()
        return self._roll_metrics(result["stats"], learner_metrics)


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0               # 0.0 degenerates to plain BC
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-7  # ref default-ish


class MARWILLearner(Learner):
    """Advantage-weighted behavior cloning (Wang et al. 2018; reference:
    rllib/algorithms/marwil) — maximize exp(beta * A / c) * logp, where
    A = returns - V(s) and c is a running norm of A^2, plus a value
    loss fitting V to the recorded returns. beta=0 is exactly BC."""

    def __init__(self, spec, config: "MARWILConfig", device=None):
        self._beta = config.beta
        self._vf_coeff = config.vf_coeff
        self._ma_rate = config.moving_average_sqd_adv_norm_update_rate
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)
        # running estimate of E[A^2] (float32, as the JAX learner keeps
        # it); lives in learner state like SAC's target params
        self.ma_sqd_adv = 1.0

    def compute_loss(self, mb):
        out = self.module.forward_train(mb["obs"])
        logp = self.module.dist.log_prob(
            out["action_dist_inputs"], mb["actions"])
        returns = mb["returns"]
        vf_loss = torch.mean((out["vf"] - returns) ** 2)
        adv = (returns - out["vf"]).detach()
        if self._beta > 0.0:
            # the running norm as a float32 operand, as the JAX learner
            # reads it (filled on the device: no upload)
            c = torch.sqrt(torch.full((), self.ma_sqd_adv,
                                      device=adv.device)) + 1e-8
            weights = torch.clamp(torch.exp(self._beta * adv / c),
                                  max=20.0)
        else:
            weights = torch.ones_like(adv)
        policy_loss = -torch.mean(weights * logp)
        loss = policy_loss + self._vf_coeff * vf_loss
        return loss, {"total_loss": loss, "policy_loss": policy_loss,
                      "vf_loss": vf_loss,
                      "mean_weight": torch.mean(weights),
                      "sqd_adv": torch.mean(adv ** 2)}

    def update(self, train_batch):
        metrics = super().update(train_batch)
        if self._beta > 0.0 and "sqd_adv" in metrics:
            # fold the batch's observed E[A^2] into the running norm
            # (reference: marwil update_averaged_weights)
            n = len(next(iter(train_batch.values())))
            rate = min(self._ma_rate * n, 1.0)
            self.ma_sqd_adv = float(np.float32(
                (1.0 - rate) * self.ma_sqd_adv
                + rate * float(metrics["sqd_adv"])))
        return metrics

    def get_state(self):
        state = super().get_state()
        state["ma_sqd_adv"] = self.ma_sqd_adv
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        if "ma_sqd_adv" in state:
            self.ma_sqd_adv = float(np.float32(state["ma_sqd_adv"]))


class MARWIL(BC):
    @classmethod
    def default_config(cls) -> MARWILConfig:
        return MARWILConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> MARWILLearner:
        return MARWILLearner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is not None and algo_cfg.num_learners > 1:
            raise ValueError(
                "MARWIL supports num_learners <= 1 (the advantage-norm "
                "moving average lives in learner state, outside the "
                "generic allreduce path)")
        super().setup(config)
        if "returns" not in self.offline.data:
            raise ValueError(
                "MARWIL shards need 'returns' — record with "
                "record_samples(..., gamma=...) so reward-to-go is "
                "computed while episode structure is known")
