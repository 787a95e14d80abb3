"""Learner / LearnerGroup: the gradient path.

Counterpart of ``ray_tpu/rllib/core/learner.py``'s single-learner path,
whose update (epochs x shuffled minibatches x grad/apply) is one jitted
``lax.scan``. Here it is a Python loop of autograd steps on the
learner's device with no host sync inside: minibatches gather rows by
index tensors, the clip needs no host value, the metrics accumulate on
the device and are read once after the last step.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adam(lr, eps=1e-5))`` in its order of operations (``Adam``).
Minibatches are drawn with ``torch.randperm`` on a device generator
seeded from the learner's seed; the JAX learner's
``jax.random.permutation`` order is not reproduced (ROADMAP.md §C).

Several learners (reference: learner_group.py:72,146-161, torch DDP over
NCCL there) are N learner actors of the port's runtime: each takes a
strided shard of the batch, and per minibatch its gradients cross the
host collective (``util.collective.allreduce``, through the object
store, rank order) and are averaged before the optimizer step, as the
JAX package's split-phase update does.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch as rt

from ...models.training import global_norm, resolve_device
from .rl_module import RLModule, build_module


@dataclasses.dataclass
class LearnerHyperparams:
    lr: float = 3e-4
    grad_clip: float = 0.5
    num_epochs: int = 4
    minibatch_size: int = 256


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2,
    eps))``: clip by the global norm where it reaches grad_clip (``g /
    norm * grad_clip``, no epsilon), moments ``(1 - b) g + b m``,
    bias corrections at the step count, eps outside the sqrt, then
    ``p + (-lr) u``. In place, with no host sync."""
    lr: float
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-5

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any]) -> None:
        f = np.float32
        t = state["count"] + 1
        bc1 = float(f(1) - f(self.b1) ** f(t))
        bc2 = float(f(1) - f(self.b2) ** f(t))
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        den = torch.where(keep, torch.ones_like(norm), norm)
        num = torch.where(keep, torch.ones_like(norm),
                          torch.full_like(norm, self.grad_clip))
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g / den * num
            mu.copy_(g * (1 - self.b1) + mu * self.b1)
            nu.copy_(g * g * (1 - self.b2) + nu * self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            p.add_(u * -self.lr)
        state["count"] = t


class Learner:
    """Subclasses implement compute_loss(minibatch) -> (loss,
    metrics-dict of 0-d tensors); everything else is built here.
    `device` None means the card (raises without one)."""

    def __init__(self, spec, hps: LearnerHyperparams,
                 module_class: Optional[type] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device, "Learner")
        self.hps = hps
        self.module: RLModule = build_module(
            spec, module_class, model_config).init_parameters(seed).to(
                self.device)
        self.params = list(self.module.parameters())
        self.optimizer = Adam(hps.lr, hps.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)

    # -- subclass hook ------------------------------------------------------
    def compute_loss(self, minibatch):
        raise NotImplementedError

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _grads(self, minibatch) -> Tuple[List[torch.Tensor],
                                          Dict[str, torch.Tensor]]:
        """The minibatch's gradients and its metrics, detached on the
        device (the JAX learner's ``_build_grads``)."""
        loss, aux = self.compute_loss(minibatch)
        # a parameter the loss does not reach (BC's value torso) gets a
        # zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in aux.items()}

    def _apply(self, minibatch) -> Dict[str, torch.Tensor]:
        """One gradient step; its metrics, detached on the device."""
        grads, aux = self._grads(minibatch)
        self.optimizer.step_(self.params, grads, self.opt_state)
        return aux

    # -- public API ---------------------------------------------------------
    def update(self, train_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Epochs x shuffled minibatches of `train_batch` (host arrays
        with one leading axis); the metrics' means over every step."""
        hps = self.hps
        batch = self._to_device(train_batch)
        n = next(iter(batch.values())).shape[0]
        mb = min(hps.minibatch_size, n)
        nmb = max(n // mb, 1)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(hps.num_epochs):
            perm = torch.randperm(n, generator=self._gen,
                                  device=self.device)
            for i in range(nmb):
                idx = perm[i * mb:(i + 1) * mb]
                aux = self._apply({k: v[idx] for k, v in batch.items()})
                sums = ({k: sums[k] + v for k, v in aux.items()}
                        if sums else aux)
        keys = list(sums)
        means = (torch.stack([sums[k] for k in keys])
                 / (hps.num_epochs * nmb)).cpu().tolist()
        return dict(zip(keys, means))

    def update_with_allreduce(self, train_batch: Dict[str, np.ndarray],
                              group_name: str, world_size: int
                              ) -> Dict[str, float]:
        """Epochs x shuffled minibatches of this learner's shard; each
        minibatch's gradients are summed across the learner group
        (host collective, on the CPU) and divided by `world_size`
        before the optimizer step. The metrics' means over every step."""
        from ...util import collective
        hps = self.hps
        batch = self._to_device(train_batch)
        n = next(iter(batch.values())).shape[0]
        if n == 0:
            raise ValueError("empty train-batch shard")
        mb = max(min(hps.minibatch_size, n), 1)
        nmb = max(n // mb, 1)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(hps.num_epochs):
            perm = torch.randperm(n, generator=self._gen,
                                  device=self.device)
            for i in range(nmb):
                idx = perm[i * mb:(i + 1) * mb]
                grads, aux = self._grads({k: v[idx]
                                          for k, v in batch.items()})
                total = collective.allreduce(
                    [g.cpu() for g in grads], group_name=group_name)
                self.optimizer.step_(
                    self.params,
                    [g.to(self.device) / world_size for g in total],
                    self.opt_state)
                sums = ({k: sums[k] + v for k, v in aux.items()}
                        if sums else aux)
        keys = list(sums)
        means = (torch.stack([sums[k] for k in keys])
                 / (hps.num_epochs * nmb)).cpu().tolist()
        return dict(zip(keys, means))

    def get_state(self):
        """Host copies: the parameters by name and Adam's state."""
        names = [k for k, _ in self.module.named_parameters()]
        host = lambda ts: {k: t.detach().cpu().numpy()
                           for k, t in zip(names, ts)}
        return {"params": host(self.params),
                "opt_state": {"count": self.opt_state["count"],
                              "mu": host(self.opt_state["mu"]),
                              "nu": host(self.opt_state["nu"])}}

    @torch.no_grad()
    def set_state(self, state) -> None:
        names = [k for k, _ in self.module.named_parameters()]
        for dst, src in ((self.params, state["params"]),
                         (self.opt_state["mu"], state["opt_state"]["mu"]),
                         (self.opt_state["nu"], state["opt_state"]["nu"])):
            for t, k in zip(dst, names):
                t.copy_(torch.as_tensor(np.asarray(src[k])))
        self.opt_state["count"] = int(state["opt_state"]["count"])

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """A detached copy of the parameters, by name, on the learner's
        device (a runner copies them tensor to tensor)."""
        return {k: v.detach().clone()
                for k, v in self.module.named_parameters()}

    def ping(self) -> bool:
        return True

    def device_info(self) -> Dict[str, Optional[str]]:
        """Where this learner steps: its device and the process's
        CUDA_VISIBLE_DEVICES (a learner actor reports its own)."""
        from ..env.env_runner import device_info
        return device_info(self.device)


class LearnerGroup:
    """One local learner, or N learner actors averaging gradients
    through a host collective group. `learner_factory(device)` builds a
    learner on `device` (None: the card), in this process or in each
    actor (`learner_resources`: the actors' options, one CPU each by
    default, as the reference's)."""

    def __init__(self, learner_factory: Callable[[torch.device], Learner],
                 num_learners: int = 0, device=None,
                 learner_resources: Optional[Dict[str, float]] = None):
        self.num_learners = num_learners
        self._actors: List = []
        self._group = None
        if num_learners <= 1:
            self.device = resolve_device(device, "LearnerGroup")
            self._local = learner_factory(self.device)
            return
        from ...util import collective
        self.device = device
        self._local = None
        remote_cls = rt.remote(
            **(learner_resources or {"num_cpus": 1}))(_LearnerActor)
        self._actors = [remote_cls.remote(learner_factory, device)
                        for _ in range(num_learners)]
        rt.get([a.ping.remote() for a in self._actors])
        # uuid, not a counter: group names rendezvous through GLOBAL
        # named actors, so per-process counters collide across trials
        self._group = f"learner_group_{uuid.uuid4().hex[:8]}"
        collective.create_collective_group(
            self._actors, num_learners, list(range(num_learners)),
            group_name=self._group)
        # all learners must start from identical params
        state = rt.get(self._actors[0].get_state.remote())
        rt.get([a.set_state.remote(state) for a in self._actors[1:]])

    def update(self, train_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(train_batch)
        n = next(iter(train_batch.values())).shape[0]
        futs = [a.update_with_allreduce.remote(
                    {k: v[idx] for k, v in train_batch.items()},
                    self._group, len(self._actors))
                for idx, a in zip(shard_indices(n, len(self._actors)),
                                  self._actors)]
        all_metrics = rt.get(futs)
        return {k: float(np.mean([m[k] for m in all_metrics]))
                for k in all_metrics[0]}

    def _call(self, method: str, *args):
        """`method` on the local learner, or on learner 0."""
        if self._local is not None:
            return getattr(self._local, method)(*args)
        return rt.get(getattr(self._actors[0], method).remote(*args))

    def get_weights(self):
        return self._call("get_weights")

    def get_state(self):
        return self._call("get_state")

    def set_state(self, state) -> None:
        if self._local is not None:
            self._local.set_state(state)
            return
        rt.get([a.set_state.remote(state) for a in self._actors])

    def device_info(self) -> List[Dict[str, Optional[str]]]:
        """Each learner's device and CUDA_VISIBLE_DEVICES."""
        if self._local is not None:
            return [self._local.device_info()]
        return rt.get([a.device_info.remote() for a in self._actors])

    def stop(self) -> None:
        if not self._actors:
            return
        from ...util.collective.collective import _group_actor_name
        for a in self._actors:
            try:
                rt.kill(a)
            except Exception:
                pass
        self._actors = []
        # learner actors are gone (no member will deregister), so the
        # driver reclaims the detached rendezvous actor directly
        try:
            rt.kill(rt.get_actor(_group_actor_name(self._group)))
        except Exception:
            pass
        self._group = None


def shard_indices(n: int, num: int) -> List[np.ndarray]:
    """Strided shards of n rows over `num` learners: every row is kept
    and no learner is left empty-handed (each MUST contribute to the
    allreduce); when n < num, a learner past the end wraps to row
    i % n."""
    return [np.arange(i, n, num) if i < n else np.array([i % n])
            for i in range(num)]


class _LearnerActor:
    """Actor shell delegating to a Learner built in its own process, on
    `device` (None: the card)."""

    def __init__(self, learner_factory, device=None):
        self._learner = learner_factory(resolve_device(device, "Learner"))

    def __getattr__(self, name):
        return getattr(self._learner, name)
