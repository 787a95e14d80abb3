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

Several learners need an actor runtime and a collective, which the port
does not have yet (ROADMAP.md §A5): ``LearnerGroup`` refuses
``num_learners > 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

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

    def _apply(self, minibatch) -> Dict[str, torch.Tensor]:
        """One gradient step; its metrics, detached on the device."""
        loss, aux = self.compute_loss(minibatch)
        # a parameter the loss does not reach (BC's value torso) gets a
        # zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        self.optimizer.step_(self.params, list(grads), self.opt_state)
        return {k: v.detach() for k, v in aux.items()}

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


class LearnerGroup:
    """The local learner. `learner_factory(device)` builds it on the
    group's device (None: the card)."""

    def __init__(self, learner_factory: Callable[[torch.device], Learner],
                 num_learners: int = 0, device=None):
        if num_learners > 1:
            raise ValueError(
                f"num_learners={num_learners}: several learners wait for "
                f"an actor runtime and a gradient collective in "
                f"ray_tpu_torch (ROADMAP.md §A5); use num_learners<=1")
        self.num_learners = num_learners
        self.device = resolve_device(device, "LearnerGroup")
        self._local = learner_factory(self.device)

    def update(self, train_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._local.update(train_batch)

    def get_weights(self):
        return self._local.get_weights()

    def get_state(self):
        return self._local.get_state()

    def set_state(self, state) -> None:
        self._local.set_state(state)

    def stop(self) -> None:
        pass
