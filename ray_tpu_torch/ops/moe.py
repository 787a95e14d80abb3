"""Mixture-of-Experts: top-k routing, capacity dispatch and dropless
grouped products.

PyTorch counterpart of ``ray_tpu/ops/moe.py`` on one device:

- capacity (``dropless=False``): a [tokens, experts, capacity] one-hot
  dispatch and a gate-weighted combine (``make_dispatch``, the same
  slot-by-slot position rule); tokens over an expert's capacity are
  dropped (their residual passes through). The dispatch and combine
  products stay float32, as the reference keeps them; the expert
  products run in the activation dtype, one batched product over the
  experts each.
- dropless (``dropless=True``): the T*k assignments stable-sorted by
  expert, grouped products over the sorted rows, and a float32
  gate-weighted scatter-add combine. The reference's ``lax.ragged_dot``
  (XLA code, not a Pallas kernel) is one ``torch.mm`` an expert here,
  over the rows the expert received; the group sizes are read to the
  host once a call (one device sync). With top-2 every output row takes
  exactly two adds from zero, so the combine is exact in any order.

Expert parallelism (an ``ep`` mesh axis and ``ops/ragged_exchange.py``)
needs several devices and is not ported: ``moe_ffn`` raises for
``ep > 1``.

The grouped products run inside ``grouped_products()``: the selective
remat policy of ``models/llama.py`` reads it, since the reference's
policy saves the outputs of dot_generals with no batch dimension and a
``ragged_dot`` is no dot_general.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_GROUPED = threading.local()


@contextlib.contextmanager
def grouped_products():
    """Marks the products run inside as grouped (ragged) products."""
    depth = getattr(_GROUPED, "depth", 0)
    _GROUPED.depth = depth + 1
    try:
        yield
    finally:
        _GROUPED.depth = depth


def in_grouped_products() -> bool:
    return getattr(_GROUPED, "depth", 0) > 0


def router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """x: [T, H]; router_w: [H, E] -> probs [T, E] (float32 softmax)."""
    return torch.softmax(x.float() @ router_w.float(), dim=-1)


def top_k_routing(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs: [T, E] -> (gates [T, k] renormalized, indices [T, k])."""
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def load_balancing_loss(probs: torch.Tensor, idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch aux loss: E * sum_e fraction_e * mean_prob_e (fractions of
    the top-1 assignments)."""
    sel = F.one_hot(idx[:, 0], num_experts).to(probs.dtype)
    fraction = sel.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    return num_experts * (fraction * mean_prob).sum()


def make_dispatch(probs: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C] one-hot, combine [T, E, C] gate-weighted,
    aux_loss) for capacity C per expert."""
    t, num_experts = probs.shape
    gates, idx = top_k_routing(probs, k)
    aux = load_balancing_loss(probs, idx, num_experts)
    dt = probs.dtype
    dispatch = torch.zeros((t, num_experts, capacity), dtype=dt,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for slot in range(k):
        onehot = F.one_hot(idx[:, slot], num_experts).to(dt)      # [T, E]
        # position of each token in its expert's queue, counting the
        # earlier slots' assignments too
        prior = dispatch.sum(dim=2)                               # [T, E]
        pos_in_e = (torch.cumsum(onehot, dim=0) - onehot
                    + prior.sum(dim=0, keepdim=True))
        pos = (pos_in_e * onehot).sum(dim=1)                      # [T]
        keep = pos < capacity
        # a dropped token's position is past the capacity: its one-hot
        # row is zero, as jax.nn.one_hot gives for an index out of range
        pos_oh = F.one_hot(torch.clamp(pos.long(), max=capacity),
                           capacity + 1)[:, :capacity].to(dt)
        contrib = ((onehot * keep[:, None])[:, :, None]
                   * pos_oh[:, None, :])
        dispatch = dispatch + contrib
        combine = combine + contrib * gates[:, slot, None, None]
    return dispatch, combine, aux


def _swiglu_grouped(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                    wd: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over expert-sorted rows: expert e's weights on the
    counts[e] rows it received (the reference's three ragged_dots)."""
    dt = xs.dtype
    sizes = counts.tolist()                     # the call's one host sync
    outs = []
    with grouped_products():
        for e, rows in enumerate(xs.split(sizes)):
            gate = F.silu(rows @ wg[e].to(dt))
            up = rows @ wi[e].to(dt)
            outs.append((gate * up) @ wd[e].to(dt))
    return torch.cat(outs)


def _dropless_local(xt: torch.Tensor, gates: torch.Tensor,
                    idx: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """Single-shard dropless dispatch: stable-sort the T*k assignments by
    expert, grouped products, gate-weighted scatter-add combine."""
    t, h = xt.shape
    k = idx.shape[1]
    num_experts = wi.shape[0]
    eid = idx.reshape(-1)                                   # [T*k]
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    order = torch.sort(eid, stable=True).indices
    rows = tok[order]
    counts = torch.bincount(eid, minlength=num_experts)
    ys = _swiglu_grouped(xt[rows], wg, wi, wd, counts)
    gat = gates.reshape(-1)[order].float()
    out = torch.zeros((t, h), dtype=torch.float32, device=xt.device)
    out = out.index_add(0, rows, ys.float() * gat[:, None])
    return out.to(xt.dtype)


def _refuse_ep(ep: int) -> None:
    if ep > 1:
        raise NotImplementedError(
            "expert parallelism (an ep mesh axis, ops/ragged_exchange.py) "
            "needs several devices and is not ported (ROADMAP.md, A5: "
            "waits for a machine with several cards)")


def moe_ffn_dropless(x: torch.Tensor, router_w: torch.Tensor,
                     wi: torch.Tensor, wg: torch.Tensor, wd: torch.Tensor,
                     *, top_k: int = 2, ep: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE SwiGLU feed-forward (same contract as moe_ffn)."""
    _refuse_ep(ep)
    b, s, h = x.shape
    xt = x.reshape(b * s, h)
    probs = router_probs(xt, router_w)
    gates, idx = top_k_routing(probs, top_k)
    aux = load_balancing_loss(probs, idx, router_w.shape[1])
    out = _dropless_local(xt, gates, idx, wi, wg, wd)
    return out.reshape(b, s, h), aux


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
            wg: torch.Tensor, wd: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, dropless: bool = False,
            ep: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU feed-forward.

    x: [B, S, H]; router_w: [H, E]; wi/wg: [E, H, F]; wd: [E, F, H].
    Returns (out [B, S, H], aux_loss scalar). ``ep`` is the size of the
    expert-parallel mesh axis (the reference's ``mesh``): only 1 here."""
    if dropless:
        return moe_ffn_dropless(x, router_w, wi, wg, wd, top_k=top_k, ep=ep)
    _refuse_ep(ep)
    b, s, h = x.shape
    num_experts = router_w.shape[1]
    dt = x.dtype
    xt = x.reshape(b * s, h)
    t = xt.shape[0]
    capacity = max(int(t * top_k / num_experts * capacity_factor), 1)
    probs = router_probs(xt, router_w)
    dispatch, combine, aux = make_dispatch(probs, top_k, capacity)
    ec = num_experts * capacity
    # "tec,th->ech" and "tec,ech->th" in float32, as the reference keeps
    # them: products with no batch dimension (torch.mm)
    expert_in = (dispatch.reshape(t, ec).t() @ xt.float()).to(dt)
    expert_in = expert_in.reshape(num_experts, capacity, h)
    # "ech,ehf->ecf" and "ecf,efh->ech": batched over the experts
    gate = F.silu(torch.bmm(expert_in, wg.to(dt)))
    up = torch.bmm(expert_in, wi.to(dt))
    expert_out = torch.bmm(gate * up, wd.to(dt))
    out = combine.reshape(t, ec) @ expert_out.reshape(ec, h).float()
    return out.reshape(b, s, h).to(dt), aux
