"""RLModule: the policy container, as ``torch.nn.Module``s.

Counterpart of ``ray_tpu/rllib/core/rl_module.py``. Where a JAX module
is a pure apply function over a separate params pytree, a port module
owns its parameters: ``module(obs)`` returns ``{"action_dist_inputs",
"vf"}``. Parameters are drawn from a seeded CPU ``torch.Generator``
(``init_parameters``; the same seed gives the same weights on any
device) with flax's initializer families: lecun-normal (a truncated
normal) kernels, zero biases, orthogonal logits (gain 0.01) and value
heads (gain 1.0). ``params_from_flax`` carries a flax param tree, as
numpy, into a module; a module of nested flax trees (DreamerV3's) names
its layers by path ("wm/enc/Dense_0"), and a GRU cell takes flax's six
gate layers (``GRUCell``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import distributions

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal")
# divides the std by the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class RLModule(nn.Module):
    """Spec + forward; subclasses define ``forward(obs) -> {
    "action_dist_inputs", "vf"}`` and ``flax_layers()``."""

    def __init__(self, spec):
        super().__init__()
        self.spec = spec
        self.dist = distributions.for_spec(spec)

    def flax_layers(self) -> List[Tuple[str, nn.Module, Any]]:
        """``(flax name, layer, kernel init)`` in ``@nn.compact``
        creation order; init is "lecun", an orthogonal gain, or "gru"
        (a ``GRUCell``: lecun input kernels, orthogonal recurrent ones).
        Names of nested trees are "/"-joined paths."""
        raise NotImplementedError

    @torch.no_grad()
    def init_parameters(self, seed: int) -> "RLModule":
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``
        (drawn on the CPU, copied to where the module lives)."""
        gen = torch.Generator().manual_seed(seed)
        for _, layer, init in self.flax_layers():
            if init == "gru":
                layer.init_parameters(gen)
                continue
            layer.weight.copy_(_init_kernel(layer.weight.shape, init, gen))
            layer.bias.zero_()
        return self

    # reference forward_* surface ------------------------------------------
    def forward_inference(self, obs):
        return self.dist.deterministic(self(obs)["action_dist_inputs"])

    def exploration_noise(self, key, batch: int):
        """What ``forward_exploration`` draws from `key` for `batch`
        rows, as a tuple of tensors (keys batch over their own leading
        axes, as ``threefry`` does)."""
        return (self.dist.noise(key, (batch, self._out_dim)),)

    def explore_with(self, obs, noise):
        """``forward_exploration`` on noise drawn beforehand."""
        out = self(obs)
        inputs = out["action_dist_inputs"]
        action = self.dist.sample_with(inputs, noise[0])
        logp = self.dist.log_prob(inputs, action)
        return action, logp, out["vf"]

    def forward_exploration(self, obs, key):
        return self.explore_with(
            obs, self.exploration_noise(key, obs.shape[0]))

    def forward_train(self, obs):
        return self(obs)


def _init_kernel(shape, init, gen) -> torch.Tensor:
    """A (out, in) kernel of flax's family `init`: lecun-normal or an
    orthogonal gain."""
    w = torch.empty(shape)
    if init == "lecun":
        fan_in = math.prod(w.shape[1:])
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    else:
        nn.init.orthogonal_(w, gain=init, generator=gen)
    return w


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` on ``torch.gru_cell`` (``torch.nn.GRUCell``'s
    op): gates stacked r, z, n; flax's input biases are the input bias
    (``b_ih``), its one recurrent bias (``hn``) the n part of the hidden
    bias, whose r and z parts are zero and not parameters. Both
    formulas are then the same: r = sigmoid(W_ir x + b_ir + W_hr h),
    z likewise, n = tanh(W_in x + b_in + r (W_hn h + b_hn)),
    h' = (1 - z) n + z h."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size,
                                                  hidden_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hn = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, h, x):
        zero = torch.zeros(2 * self.hidden_size, dtype=h.dtype,
                           device=h.device)
        return torch.gru_cell(x, h, self.weight_ih, self.weight_hh,
                              self.bias_ih, torch.cat([zero, self.bias_hn]))

    @torch.no_grad()
    def init_parameters(self, gen) -> None:
        """flax's GRUCell families: lecun input kernels, orthogonal
        recurrent kernels (each gate's own), zero biases."""
        h, i = self.hidden_size, self.weight_ih.shape[1]
        self.weight_ih.copy_(torch.cat([_init_kernel((h, i), "lecun", gen)
                                        for _ in range(3)]))
        self.weight_hh.copy_(torch.cat([_init_kernel((h, h), 1.0, gen)
                                        for _ in range(3)]))
        self.bias_ih.zero_()
        self.bias_hn.zero_()

    @torch.no_grad()
    def load_flax(self, tree: Dict[str, Any]) -> None:
        """Copy flax's ``ir, iz, in, hr, hz, hn`` dense layers in."""
        k = {g: torch.from_numpy(np.array(tree[g]["kernel"], np.float32)).T
             for g in ("ir", "iz", "in", "hr", "hz", "hn")}
        b = {g: torch.from_numpy(np.array(tree[g]["bias"], np.float32))
             for g in ("ir", "iz", "in", "hn")}
        self.weight_ih.copy_(torch.cat([k["ir"], k["iz"], k["in"]]))
        self.weight_hh.copy_(torch.cat([k["hr"], k["hz"], k["hn"]]))
        self.bias_ih.copy_(torch.cat([b["ir"], b["iz"], b["in"]]))
        self.bias_hn.copy_(b["hn"])


def _dense(i: int, o: int) -> nn.Linear:
    return nn.Linear(i, o)


class DefaultRLModule(RLModule):
    """MLP actor-critic with separate policy/value torsos."""

    def __init__(self, spec, hiddens: Sequence[int] = (64, 64)):
        super().__init__(spec)
        self._out_dim = (spec.num_actions if spec.discrete
                         else 2 * spec.action_dim)
        dims = (spec.obs_dim,) + tuple(hiddens)
        self.pi = nn.ModuleList(_dense(a, b) for a, b in zip(dims, dims[1:]))
        self.logits = _dense(dims[-1], self._out_dim)
        self.v = nn.ModuleList(_dense(a, b) for a, b in zip(dims, dims[1:]))
        self.vf = _dense(dims[-1], 1)

    def flax_layers(self):
        layers = ([(m, "lecun") for m in self.pi] + [(self.logits, 0.01)]
                  + [(m, "lecun") for m in self.v] + [(self.vf, 1.0)])
        return [(f"Dense_{i}", m, init)
                for i, (m, init) in enumerate(layers)]

    def forward(self, obs):
        pi = obs
        for layer in self.pi:
            pi = torch.tanh(layer(pi))
        v = obs
        for layer in self.v:
            v = torch.tanh(layer(v))
        return {"action_dist_inputs": self.logits(pi),
                "vf": self.vf(v)[..., 0]}


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's padding="SAME" along one axis: the total
    max((ceil(n/s) - 1) s + k - n, 0), its smaller half first."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class CNNRLModule(RLModule):
    """Pixel-observation actor-critic: the env's flat obs vector is
    reshaped to spec.obs_shape (H, W, C) — under feature-wise frame
    stacking the stacked copies become extra channels. Use via
    ``.rl_module(module_class=CNNRLModule)``.

    Layouts follow flax: frames fold into channels frame-major, convs
    pad "SAME" (asymmetric at stride 2, hence the explicit ``F.pad``),
    and the dense layer reads the torso's output flattened H, W, C."""

    def __init__(self, spec, channels: Sequence[int] = (16, 32),
                 dense: int = 128):
        super().__init__(spec)
        base = tuple(getattr(spec, "obs_shape", ()) or ())
        if len(base) != 3:
            raise ValueError(
                f"CNNRLModule needs spec.obs_shape == (H, W, C); "
                f"got {base!r}")
        pixels = base[0] * base[1] * base[2]
        if spec.obs_dim % pixels:
            raise ValueError(
                f"obs_dim {spec.obs_dim} is not a multiple of "
                f"prod(obs_shape) {pixels} — mixed pixel+vector "
                f"observations need a custom module")
        self.obs_shape = base
        self.n_frames = spec.obs_dim // pixels     # framestack factor
        self._out_dim = (spec.num_actions if spec.discrete
                         else 2 * spec.action_dim)
        h, w, c = base
        chans = (c * self.n_frames,) + tuple(channels)
        self.strides = tuple(2 if i else 1 for i in range(len(channels)))
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=s)
                                   for a, b, s in zip(chans, chans[1:],
                                                      self.strides))
        self.pads = []
        for s in self.strides:
            self.pads.append(_same_pad(w, 3, s) + _same_pad(h, 3, s))
            h, w = -(-h // s), -(-w // s)
        self.dense = _dense(h * w * chans[-1], dense)
        self.logits = _dense(dense, self._out_dim)
        self.vf = _dense(dense, 1)

    def flax_layers(self):
        layers = [(f"Conv_{i}", m, "lecun") for i, m in enumerate(self.convs)]
        return layers + [("Dense_0", self.dense, "lecun"),
                         ("Dense_1", self.logits, 0.01),
                         ("Dense_2", self.vf, 1.0)]

    def forward(self, obs):
        lead = obs.shape[:-1]
        x = obs.reshape(-1, obs.shape[-1])
        b = x.shape[0]
        h, w, c = self.obs_shape
        n = self.n_frames
        # frame-major flat input: frames fold into CHANNELS, frame i's
        # channels at [i c, (i + 1) c), as the JAX module concatenates
        img = x.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3).reshape(
            b, n * c, h, w)
        for conv, pad in zip(self.convs, self.pads):
            img = F.relu(conv(F.pad(img, pad)))
        flat = img.permute(0, 2, 3, 1).reshape(b, -1)
        hid = F.relu(self.dense(flat))
        return {"action_dist_inputs": self.logits(hid).reshape(
                    lead + (self._out_dim,)),
                "vf": self.vf(hid)[..., 0].reshape(lead)}


def _flax_layer_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """A flax tree's layers by "/"-joined path, its "params" levels
    skipped: a node with a "kernel" is a layer, one with "ir" a GRU
    cell."""
    out = {}
    for k, v in tree.items():
        if k == "params":
            out.update(_flax_layer_paths(v, prefix))
        elif "kernel" in v or "ir" in v:
            out[prefix + k] = v
        else:
            out.update(_flax_layer_paths(v, f"{prefix}{k}/"))
    return out


@torch.no_grad()
def params_from_flax(module: RLModule, tree: Dict[str, Any]) -> RLModule:
    """Copy a flax param tree (``{"params": {"Dense_0": {"kernel",
    "bias"}, ...}}`` or its inner dict, or a tree of such trees; numpy
    or array-likes) into `module`'s parameters, in place: dense kernels
    (in, out) into ``nn.Linear`` weights (out, in), conv kernels (kh,
    kw, in, out) into ``nn.Conv2d`` weights (out, in, kh, kw), GRU cells
    by ``GRUCell.load_flax``."""
    tree = _flax_layer_paths(tree)
    layers = module.flax_layers()
    if sorted(tree) != sorted(name for name, _, _ in layers):
        raise ValueError(f"flax tree has {sorted(tree)}, the module "
                         f"{[name for name, _, _ in layers]}")
    for name, layer, init in layers:
        if init == "gru":
            layer.load_flax(tree[name])
            continue
        kernel = torch.from_numpy(np.array(tree[name]["kernel"],
                                           np.float32))
        kernel = (kernel.permute(3, 2, 0, 1) if kernel.dim() == 4
                  else kernel.T)
        layer.weight.copy_(kernel)
        layer.bias.copy_(torch.from_numpy(np.array(tree[name]["bias"],
                                                   np.float32)))
    return module


def build_module(spec,
                 module_class: Optional[type] = None,
                 model_config: Optional[Dict[str, Any]] = None) -> RLModule:
    model_config = model_config or {}
    if module_class is not None:
        return module_class(spec, **model_config)
    return DefaultRLModule(spec, **model_config)
