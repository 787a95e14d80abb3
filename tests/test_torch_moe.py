"""ray_tpu_torch.ops.moe against ray_tpu.ops.moe on the same numpy
inputs, float32, CPU.

Tolerances, each with its reason:
  - router probabilities rtol 1e-5: the router product and the softmax
    sum in another order (measured: ~1e-6);
  - from the same probabilities, the routing indices and the dispatch
    one-hots are equal; the gates, the combine weights and the aux loss
    agree to 1 float32 ulp (rtol 1.2e-7; the aux loss's mean 1e-6);
  - outputs rtol 1e-5 (atol 1e-6), gradients atol 1e-6: both sides run
    the same float32 operations, summed in other orders (the tolerances
    of test_torch_training.py);
  - the naive per-token reference of tests/test_moe_dropless.py: rtol
    and atol 2e-4, as that file holds the JAX path to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import moe as jm
from ray_tpu_torch.ops import moe as tm

torch.set_num_threads(2)


def _toy(seed=0, b=2, s=8, h=16, e=4, f=32):
    """The inputs of tests/test_moe_dropless.py's _toy, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    router = (rng.standard_normal((h, e)) * 0.5).astype(np.float32)
    wi = (rng.standard_normal((e, h, f)) * 0.1).astype(np.float32)
    wg = (rng.standard_normal((e, h, f)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((e, f, h)) * 0.1).astype(np.float32)
    return x, router, wi, wg, wd


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _probs(seed, t=24, e=4, h=16):
    x, router, *_ = _toy(seed, b=1, s=t, h=h, e=e)
    return x[0], router


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_probs_and_top_k_routing_equal(seed):
    x, router = _probs(seed)
    pj = np.array(jm.router_probs(*_j(x, router)))
    pt = tm.router_probs(*_t(x, router))
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-5, atol=0)
    for k in (1, 2, 3):
        gj, ij = jm.top_k_routing(jnp.asarray(pj), k)
        gt, it = tm.top_k_routing(torch.from_numpy(pj), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1.2e-7,
                                   atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_load_balancing_loss_equal(seed):
    x, router = _probs(seed)
    pj = np.array(jm.router_probs(*_j(x, router)))
    _, ij = jm.top_k_routing(jnp.asarray(pj), 2)
    want = float(jm.load_balancing_loss(jnp.asarray(pj), ij, 4))
    got = tm.load_balancing_loss(torch.from_numpy(pj),
                                 torch.from_numpy(np.array(ij)).long(), 4)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 5), (2, 12), (2, 1),
                                        (3, 7)])
def test_make_dispatch_equal(k, capacity):
    """Small capacities drop tokens (the slot-by-slot positions decide
    which); a large one keeps every assignment."""
    x, router = _probs(3)
    pj = np.array(jm.router_probs(*_j(x, router)))
    dj, cj, aj = jm.make_dispatch(jnp.asarray(pj), k, capacity)
    dt, ct, at = tm.make_dispatch(torch.from_numpy(pj), k, capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1.2e-7,
                               atol=0)
    np.testing.assert_allclose(at.item(), float(aj), rtol=1e-6)
    kept = dt.sum().item()
    assert kept <= min(24 * k, 4 * capacity)


# dropless, top_k, capacity_factor, shapes
FFN_CASES = [
    (False, 2, 1.25, {}),
    (False, 1, 1.0, {}),           # tight: drops
    (False, 2, 2.0, {"e": 8, "f": 24, "s": 16}),
    (True, 2, 1.25, {}),
    (True, 1, 1.25, {}),
    (True, 2, 1.25, {"e": 8, "f": 24, "s": 16}),
]


@pytest.mark.parametrize("dropless,top_k,cf,shape", FFN_CASES,
                         ids=[f"{'dropless' if c[0] else 'capacity'}_k{c[1]}"
                              f"_cf{c[2]}_e{c[3].get('e', 4)}"
                              for c in FFN_CASES])
def test_moe_ffn_and_grads_match_jax(dropless, top_k, cf, shape):
    x, router, wi, wg, wd = _toy(seed=5, **shape)

    def jf(x, router, wi, wg, wd):
        out, aux = jm.moe_ffn(x, router, wi, wg, wd, top_k=top_k,
                              capacity_factor=cf, dropless=dropless)
        return jnp.sum(out * out) + 0.01 * aux, (out, aux)
    (_, (out_j, aux_j)), g_j = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3, 4), has_aux=True)(*_j(x, router, wi, wg,
                                                      wd))
    ts = [a.requires_grad_(True) for a in _t(x, router, wi, wg, wd)]
    out_t, aux_t = tm.moe_ffn(*ts, top_k=top_k, capacity_factor=cf,
                              dropless=dropless)
    ((out_t * out_t).sum() + 0.01 * aux_t).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)
    for name, a, gj in zip(("x", "router", "wi", "wg", "wd"), ts, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj),
                                   atol=1e-6, rtol=0, err_msg=name)


def _naive_reference(x, router_w, wi, wg, wd, top_k):
    """tests/test_moe_dropless.py's per-token dense mixture, in numpy:
    every routed token computes (the definition of dropless)."""
    b, s, h = x.shape
    xt = x.reshape(-1, h).astype(np.float64)
    logits = xt @ router_w
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        order = np.argsort(-probs[t])[:top_k]
        gates = probs[t][order] / max(probs[t][order].sum(), 1e-9)
        for g, e in zip(gates, order):
            a = xt[t] @ wg[e]
            gate = a / (1 + np.exp(-a))
            out[t] += g * ((gate * (xt[t] @ wi[e])) @ wd[e])
    return out.reshape(b, s, h)


def test_dropless_matches_naive_reference():
    x, router, wi, wg, wd = _toy()
    out, aux = tm.moe_ffn(*_t(x, router, wi, wg, wd), top_k=2,
                          dropless=True)
    ref = _naive_reference(x, router, wi, wg, wd, top_k=2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert np.isfinite(aux.item())


def test_capacity_path_drops_where_dropless_does_not():
    """Skewed routing: capacity_factor=1 drops tokens, dropless never
    does (tests/test_moe_dropless.py's case)."""
    x, router, wi, wg, wd = _toy(seed=3)
    router = router.copy()
    router[:, 0] += 8.0
    args = _t(x, router, wi, wg, wd)
    cap_out, _ = tm.moe_ffn(*args, top_k=1, capacity_factor=1.0)
    free_out, _ = tm.moe_ffn(*args, top_k=1, dropless=True)
    ref = _naive_reference(x, router, wi, wg, wd, top_k=1)
    np.testing.assert_allclose(free_out.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert np.abs(cap_out.numpy() - ref).max() > 1e-3
    # and the JAX capacity path drops the same tokens
    cap_j, _ = jm.moe_ffn(*_j(x, router, wi, wg, wd), top_k=1,
                          capacity_factor=1.0)
    np.testing.assert_allclose(cap_out.numpy(), np.asarray(cap_j),
                               rtol=1e-5, atol=1e-6)


def test_dropless_grad_flows():
    x, router, wi, wg, wd = _toy()
    ws = [a.requires_grad_(True) for a in _t(router, wi, wg, wd)]
    out, aux = tm.moe_ffn(torch.from_numpy(x), *ws, top_k=2, dropless=True)
    ((out ** 2).sum() + 0.01 * aux).backward()
    for w in ws:
        assert torch.isfinite(w.grad).all()
    assert ws[1].grad.abs().max() > 0     # the experts get gradient


def test_dropless_groups_run_as_grouped_products(monkeypatch):
    """The grouped products run inside grouped_products() (the remat
    policy reads it), one host read of the group sizes a call."""
    x, router, wi, wg, wd = _toy(e=8)
    seen = []
    real = tm._swiglu_grouped

    def spy(xs, wg_, wi_, wd_, counts):
        seen.append(counts.clone())
        out = real(xs, wg_, wi_, wd_, counts)
        assert not tm.in_grouped_products()
        return out
    monkeypatch.setattr(tm, "_swiglu_grouped", spy)
    tm.moe_ffn(*_t(x, router, wi, wg, wd), top_k=2, dropless=True)
    assert len(seen) == 1 and seen[0].sum().item() == 16 * 2
    with tm.grouped_products():
        assert tm.in_grouped_products()
    assert not tm.in_grouped_products()


@pytest.mark.parametrize("dropless", [False, True])
def test_expert_parallel_refused(dropless):
    x, router, wi, wg, wd = _toy()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.moe_ffn(*_t(x, router, wi, wg, wd), dropless=dropless, ep=2)
