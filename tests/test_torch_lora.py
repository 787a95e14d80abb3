"""Multi-LoRA serving in ray_tpu_torch against ray_tpu.

- `lora_delta` (the concatenated-stack form with a per-row slot mask)
  and `lora_delta_plain` (the reference's gather form) against
  `ray_tpu.models.llama_infer.lora_delta`, on 2-D and 3-D activations:
  float32, within 1e-6 of the largest value; slot 0 gives exact zeros.
- `ragged_forward` and `decode_step` with adapter stacks against the JAX
  ones on the `debug` and `tiny` presets (float32, 1e-4 as in
  tests/test_torch_llama_infer.py), stacks carried across through numpy.
- The engine against the JAX gather engine (`decode_impl="gather",
  async_readback=False`): base, strong and zero adapters, solo and in a
  mixed batch, greedy and sampled, on both of the port's impls: tokens
  equal (float32 debug model).
- Registration: the reference's error messages, a bad registration
  leaving the prior state as it was, re-registration mid-decode keeping
  each request's adapter, stacks written in place unless a rank changes.
- The prefix-cache bypass: a base request after an adapter request with
  the same 40-token prompt gives the JAX engine's tokens with caching
  off (the JAX engine with caching on reuses the adapter's KV).
- An adapter session moved through the RTKV wire continues token-exact;
  an unknown adapter is refused on both import paths.
- The server: `lora_adapters` at construction, `model=<adapter>`
  routing, the listing and a live `register_lora`.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu.models import llama_infer as jli
from ray_tpu_torch import LLMServerImpl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_infer as tli
from ray_tpu_torch.models.weights import params_from_numpy, pools_from_numpy
from ray_tpu_torch.serve.llm import kv_transport as kvt

torch.set_num_threads(1)


# ------------------------------------------------------------ the delta

@pytest.mark.parametrize("lead", [(7,), (5, 3)], ids=["2d", "3d"])
def test_lora_delta_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    S, H, r, O = 5, 32, 4, 24
    a = rng.normal(size=(S, H, r)).astype(np.float32)
    b = rng.normal(size=(S, r, O)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    idx = rng.integers(0, S, lead[0]).astype(np.int32)
    idx[0] = 0
    y = rng.normal(size=lead + (H,)).astype(np.float32)
    ref = np.asarray(jli.lora_delta(
        jnp.asarray(y), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        jnp.asarray(idx)))
    a_cat, b_cat = tli.lora_cat(a[None], b[None])
    stack = {"a": torch.from_numpy(np.ascontiguousarray(a_cat[0])),
             "b": torch.from_numpy(np.ascontiguousarray(b_cat[0])), "r": r}
    t_idx = torch.from_numpy(idx)
    out = tli.lora_delta(torch.from_numpy(y), stack, t_idx).numpy()
    plain = tli.lora_delta_plain(torch.from_numpy(y), torch.from_numpy(a),
                                 torch.from_numpy(b), t_idx).numpy()
    scale = np.abs(ref).max()
    for got in (out, plain):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * scale)
    # slot 0, the zero adapter: exact zeros
    assert (out[idx == 0] == 0.0).all() and (plain[idx == 0] == 0.0).all()


def test_lora_mask_keeps_each_rows_own_columns():
    m = tli.lora_mask(torch.tensor([0, 2, 1], dtype=torch.int32), 2, 6)
    assert m.tolist() == [[True, True, False, False, False, False],
                          [False, False, False, False, True, True],
                          [False, False, True, True, False, False]]


# --------------------------------------------------------- the forwards

PAGE, NUM_PAGES, MAX_PAGES, SLOTS = 4, 40, 8, 3


def _stacks(jcfg, rng, r=3):
    """Layer-major gather-layout stacks for all four projections (slot
    0 zero), as the JAX engine stores them, and the port's layout."""
    dims = {"wq": (jcfg.hidden, jcfg.q_dim), "wk": (jcfg.hidden,
                                                    jcfg.kv_dim),
            "wv": (jcfg.hidden, jcfg.kv_dim), "wo": (jcfg.q_dim,
                                                     jcfg.hidden)}
    jst, tst = {}, {}
    for p, (i, o) in dims.items():
        a = rng.normal(0, 0.1, (jcfg.n_layers, SLOTS, i, r))
        b = rng.normal(0, 0.1, (jcfg.n_layers, SLOTS, r, o))
        a[:, 0] = 0.0
        b[:, 0] = 0.0
        a, b = a.astype(np.float32), b.astype(np.float32)
        jst[p] = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
        ac, bc = tli.lora_cat(a, b)
        tst[p] = {"a": torch.from_numpy(np.ascontiguousarray(ac)),
                  "b": torch.from_numpy(np.ascontiguousarray(bc)), "r": r}
    return jst, tst


def _setup(preset):
    jcfg = jl.config(preset, dtype=jnp.float32)
    tcfg = tl.config(preset, dtype=torch.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    shape = (jcfg.n_layers, NUM_PAGES, PAGE, jcfg.n_kv_heads,
             jcfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    tables = rng.permutation(NUM_PAGES - 1)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    return jcfg, tcfg, params, k, v, tables, rng


def _close(lt, kt, vt, lj, kj, vj, rows=slice(None)):
    np.testing.assert_allclose(lt.numpy()[rows], np.asarray(lj)[rows],
                               atol=1e-4, rtol=1e-4)
    for t, j in ((kt, kj), (vt, vj)):
        # the scratch page (last) takes padding rows in any order
        np.testing.assert_allclose(t.numpy()[:, :-1],
                                   np.asarray(j)[:, :-1],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("preset", ["debug", "tiny"])
def test_ragged_forward_with_stacks_matches_jax(preset, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup(preset)
    jst, tst = _stacks(jcfg, rng)
    segs = [(9, 1), (0, 6), (13, 5), (2, 1)]
    slot_lora = [1, 0, 2, 1]
    t = sum(n for _, n in segs) + 3
    meta = np.zeros((5, t), np.int32)   # tokens/slots/positions/valid/lora
    last_idx = np.zeros(len(segs), np.int32)
    cur = 0
    for s, (st, n) in enumerate(segs):
        meta[0, cur:cur + n] = rng.integers(0, jcfg.vocab_size, n)
        meta[1, cur:cur + n] = s
        meta[2, cur:cur + n] = np.arange(st, st + n)
        meta[3, cur:cur + n] = 1
        meta[4, cur:cur + n] = slot_lora[s]
        last_idx[s] = cur + n - 1
        cur += n
    valid = meta[3] != 0
    start = np.asarray([s for s, _ in segs], np.int32)
    lj, kj, vj = jli.ragged_forward(
        jcfg, params, *map(jnp.asarray, (meta[0], meta[1], meta[2], valid,
                                         start, last_idx, k, v, tables)),
        ctx_pages=4, lora=jst, lora_idx=jnp.asarray(meta[4]),
        impl="gather")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    lt, _, _ = tli.ragged_forward(
        tcfg, tp, *map(torch.from_numpy, (meta[0], meta[1], meta[2], valid,
                                          start, last_idx)),
        kt, vt, torch.from_numpy(tables), ctx_pages=4, impl=impl,
        max_seg_len=8, lora=tst, lora_idx=torch.from_numpy(meta[4]))
    _close(lt, kt, vt, lj, kj, vj)
    # the adapters moved the logits: the test holds a real delta
    base = tli.ragged_forward(
        tcfg, tp, *map(torch.from_numpy, (meta[0], meta[1], meta[2], valid,
                                          start, last_idx)),
        *pools_from_numpy(k, v, device="cpu"), torch.from_numpy(tables),
        ctx_pages=4, impl=impl, max_seg_len=8)[0]
    assert not torch.allclose(base[0], lt[0], atol=1e-3)
    assert torch.allclose(base[1], lt[1], atol=1e-4)   # slot 0 row


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("preset", ["debug", "tiny"])
def test_decode_step_with_stacks_matches_jax(preset, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup(preset)
    jst, tst = _stacks(jcfg, rng)
    tokens = rng.integers(0, jcfg.vocab_size, 4).astype(np.int32)
    positions = np.asarray([7, 3, 19, 31], np.int32)
    active = np.ones(4, bool)
    idx = np.asarray([2, 0, 1, 2], np.int32)
    lj, kj, vj = jli.decode_step(
        jcfg, params, *map(jnp.asarray, (tokens, positions, k, v, tables,
                                         active)),
        lora=jst, lora_idx=jnp.asarray(idx), impl="gather")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    lt, _, _ = tli.decode_step(
        tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        kt, vt, torch.from_numpy(tables), torch.from_numpy(active),
        impl=impl, lora=tst, lora_idx=torch.from_numpy(idx))
    _close(lt, kt, vt, lj, kj, vj)


def test_stacks_need_an_index():
    jcfg, tcfg, params, k, v, tables, rng = _setup("debug")
    _, tst = _stacks(jcfg, rng)
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="lora_idx"):
        tli.decode_step(tcfg, tp, z, z, kt, vt, torch.from_numpy(tables),
                        z.bool(), lora=tst)


# ------------------------------------------------------------ the engine

KW = dict(max_batch_size=3, page_size=8, num_pages=64, max_prefill_tokens=16,
          seed=9, enable_prefix_caching=False)


def _adapters(cfg, r=4, seed=0):
    L, h, q, kv = cfg.n_layers, cfg.hidden, cfg.q_dim, cfg.kv_dim
    rng = np.random.default_rng(seed)
    strong = {"wq": (rng.normal(0, 0.5, (L, h, r)),
                     rng.normal(0, 0.5, (L, r, q))),
              "wv": (rng.normal(0, 0.5, (L, h, r)),
                     rng.normal(0, 0.5, (L, r, kv)))}
    zero = {"wq": (np.zeros((L, h, r)), np.zeros((L, r, q)))}
    return {"strong": strong, "zero": zero}


def _jax_engine(**over):
    kw = dict(KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


def _port_engine(jeng, impl="gather", **over):
    kw = dict(KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", decode_impl=impl)
    kw.update(over)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return te.InferenceEngine(te.EngineConfig(**kw), params=params)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(2, 250, n).tolist() for n in (40, 23, 7, 19)]


def _drive(eng, mod, loras, sp, prompts=None):
    """Staggered: more requests than slots, added while others decode."""
    prompts = prompts or _prompts()
    reqs = [mod.Request(f"r{i}", list(p), mod.SamplingParams(**sp),
                        lora=lo)
            for i, (p, lo) in enumerate(zip(prompts, loras))]
    for r in reqs[:2]:
        eng.add_request(r)
    for r in reqs[2:]:
        eng.step()
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


SAMPLED = dict(max_tokens=9, temperature=0.9, top_p=0.9, top_k=20, seed=5)
MIXES = {"mixed": ["strong", None, "zero", "strong"],
         "solo_strong": ["strong"], "solo_zero": ["zero"],
         "solo_base": [None]}


@pytest.fixture(scope="module")
def jax_lora_runs():
    jeng = _jax_engine()
    jeng.register_loras(_adapters(jeng.model_cfg))
    out = {}
    for mode, sp in (("greedy", dict(max_tokens=9)), ("sampled", SAMPLED)):
        for mix, loras in MIXES.items():
            out[mode, mix] = _drive(jeng, je, loras, sp)
    return jeng, out


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_engine_adapters_token_exact_vs_jax_gather(jax_lora_runs, mode,
                                                   impl):
    jeng, ref = jax_lora_runs
    sp = dict(max_tokens=9) if mode == "greedy" else SAMPLED
    eng = _port_engine(jeng, impl)
    eng.register_loras(_adapters(eng.model_cfg))
    for mix, loras in MIXES.items():
        assert _drive(eng, te, loras, sp) == ref[mode, mix], mix
    # the zero adapter is an exact no-op, the strong one is not
    assert ref[mode, "solo_zero"] == ref[mode, "solo_base"]
    assert ref[mode, "solo_strong"] != ref[mode, "solo_base"]
    # mixed batch rows equal their solo runs
    assert ref[mode, "mixed"][0] == ref[mode, "solo_strong"][0]
    assert eng.stats()["kv"]["used_pages"] == 0


def test_registration_errors_and_state():
    jeng = _jax_engine()
    eng = _port_engine(jeng)
    cfg = eng.model_cfg
    ads = _adapters(cfg)
    L, h, q = cfg.n_layers, cfg.hidden, cfg.q_dim
    bad_cases = [
        ({"x": {}}, "adapters must map a subset"),
        ({"x": {"w_up": ads["zero"]["wq"]}}, "adapters must map a subset"),
        (dict(ads, x={"wq": (np.zeros((L, h, 2)), np.zeros((L, 2, q)))}),
         "adapters disagree on wq shapes"),
        ({f"a{i}": ads["zero"] for i in range(9)}, "at most max_loras=8"),
        ({"x": {"wq": (np.zeros((L + 1, h, 4)), np.zeros((L + 1, 4, q)))}},
         "do not fit the model"),
    ]
    for mapping, match in bad_cases:
        with pytest.raises(ValueError, match=match):
            eng.register_loras(mapping)
        if "do not fit" in match:
            continue                   # the port's own check
        with pytest.raises(ValueError, match=match):
            jeng.register_loras(mapping)
    assert eng.lora_adapters() == [] and eng._lora_stacks is None
    with pytest.raises(ValueError, match=r"unknown LoRA adapter 'strong' "
                                         r"\(registered: \[\]\)"):
        eng.add_request(te.Request("a", [3, 4], te.SamplingParams(),
                                   lora="strong"))
    c0, g0 = eng.compiles, eng.graph_captures
    eng.register_loras(ads)
    assert eng.compiles == c0 + 1 and eng.graph_captures == g0
    stacks = {p: st["a"] for p, st in eng._lora_stacks.items()}
    assert eng.lora_adapters() == ["strong", "zero"]
    # a bad registration leaves the registered state as it was
    with pytest.raises(ValueError, match="adapters disagree"):
        eng.register_lora("x", {"wq": (np.zeros((L, h, 2)),
                                      np.zeros((L, 2, q)))})
    assert eng.lora_adapters() == ["strong", "zero"]
    assert eng._lora_names == {None: 0, "strong": 1, "zero": 2}
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        eng.generate([[3, 4]], loras=["nope"])
    assert not eng.waiting
    # same ranks: written in place, nothing compiled
    c1 = eng.compiles
    eng.register_lora("another", ads["zero"], scale=2.0)
    assert eng.compiles == c1
    assert all(eng._lora_stacks[p]["a"] is t for p, t in stacks.items())
    assert eng._lora_names["zero"] == 3
    # a rank change: new stacks, one compile
    eng.register_lora("wide", {"wk": (np.zeros((L, h, 8)),
                                      np.zeros((L, 8, cfg.kv_dim)))})
    assert eng.compiles == c1 + 1 and eng._lora_stacks["wk"]["r"] == 8
    events = [e for e in eng.telemetry.recorder.events()
              if e["event"] == "lora_registration"]
    assert events[-1]["adapters"] == ["another", "strong", "wide", "zero"]


def test_reregistration_mid_decode_keeps_each_adapter(jax_lora_runs):
    jeng, _ = jax_lora_runs
    ads = _adapters(jeng.model_cfg)
    prompts = _prompts()[:2]
    sp = te.SamplingParams(max_tokens=12)

    def run(mid_register):
        eng = _port_engine(jeng, async_readback=True)
        eng.register_loras(ads)
        reqs = [te.Request("s", list(prompts[0]), sp, lora="strong"),
                te.Request("z", list(prompts[1]), sp, lora="zero")]
        for r in reqs:
            eng.add_request(r)
        for _ in range(6):
            eng.step()
        if mid_register:
            # "aaa" sorts first: every slot index moves
            eng.register_lora("aaa", ads["zero"])
            assert eng._lora_names["strong"] == 2
        while eng.has_work():
            eng.step()
        return [r.output_tokens for r in reqs]

    assert run(True) == run(False)


def test_prefix_bypass_matches_jax_cache_off():
    """debug preset in float32, pages of 16, a 40-token prompt, a rank-4
    adapter on wq: the base request after the adapter request gives the
    base tokens (the JAX engine with caching on does not)."""
    cfg = jl.config("debug", dtype=jnp.float32)
    L, h, q = cfg.n_layers, cfg.hidden, cfg.q_dim
    rng = np.random.default_rng(11)
    ad = {"wq": (rng.normal(0, 0.5, (L, h, 4)),
                 rng.normal(0, 0.5, (L, 4, q)))}
    prompt = rng.integers(2, 250, 40).tolist()
    kw = dict(max_batch_size=2, page_size=16, num_pages=32, seed=4,
              max_prefill_tokens=64)

    def run(eng, mod, cache):
        eng.register_lora("a", ad)
        outs = []
        for i, lo in enumerate(("a", None)):
            outs.append(eng.generate([list(prompt)], mod.SamplingParams(
                max_tokens=6), loras=[lo])[0].output_tokens)
        return outs, eng.allocator.cache_hit_rate

    j_off = _jax_engine(enable_prefix_caching=False, **kw)
    ref, _ = run(j_off, je, False)
    j_on = _jax_engine(enable_prefix_caching=True, **kw)
    j_on_out, j_hit = run(j_on, je, True)
    assert j_on_out[0] == ref[0]
    # the reference fault: the base request reused the adapter's KV
    assert j_hit == pytest.approx(0.4) and j_on_out[1] != ref[1]
    for impl in ("gather", "kernel"):
        eng = _port_engine(j_off, impl, enable_prefix_caching=True, **kw)
        out, hit = run(eng, te, True)
        assert out == ref, impl
        assert eng.allocator.cached_pages == 2   # the base request's
        assert hit == 0.0
        # a second base request shares the base pages
        again = eng.generate([list(prompt)], te.SamplingParams(
            max_tokens=6))[0].output_tokens
        assert again == ref[1] and eng.allocator.cache_hit_tokens == 32


def test_adapter_session_over_the_wire_token_exact(jax_lora_runs):
    jeng, _ = jax_lora_runs
    ads = _adapters(jeng.model_cfg)
    prompt = _prompts()[0]
    sp = dict(max_tokens=14, temperature=0.8, top_p=0.9, seed=21)
    kw = dict(enable_kv_offload=True)

    def engine():
        eng = _port_engine(jeng, **kw)
        eng.register_loras(ads)
        return eng

    ref = engine().generate([list(prompt)], te.SamplingParams(**sp),
                            loras=["strong"])[0].output_tokens
    a = engine()
    req = te.Request("sess", list(prompt), te.SamplingParams(**sp),
                     lora="strong")
    a.add_request(req)
    while len(req.output_tokens) < 5:
        a.step()
    state = a.export_session("sess")
    assert state["lora"] == "strong" and state["n_pages"] > 0
    frame = kvt.encode_session(state)
    back = kvt.decode_session(frame)
    assert back["lora"] == "strong"
    b = engine()
    moved = b.import_session(back)
    while b.has_work():
        b.step()
    assert moved.lora == "strong" and moved.output_tokens == ref
    # an unknown adapter: refused on the warm path and the cold path
    bare = _port_engine(jeng, **kw)
    with pytest.raises(ValueError, match="unknown LoRA adapter 'strong'"):
        bare.import_session(kvt.decode_session(frame))
    cold = te.Request("cold", list(prompt), te.SamplingParams(**sp),
                      lora="strong")
    c = engine()
    c.add_request(cold)
    cstate = c.export_session("cold")
    assert cstate["n_pages"] == 0
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        bare.import_session(cstate)
    assert bare.session_ids() == []


# ------------------------------------------------------------ the server

def test_server_routes_lists_and_registers_adapters(jax_lora_runs):
    jeng, _ = jax_lora_runs
    ads = _adapters(jeng.model_cfg)
    skw = dict(KW, async_readback=False, max_seq_len=256)
    srv = LLMServerImpl({"model_id": "base-m",
                         "model_source": tl.config("debug",
                                                   dtype=torch.float32),
                         "lora_adapters": {"strong": ads["strong"]},
                         "engine_kwargs": dict(skw, device="cpu")})
    assert srv.engine.lora_adapters() == ["strong"]
    # the same weights for the oracle: the JAX engine's
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    srv.engine = te.InferenceEngine(te.EngineConfig(
        model=srv.engine.config.model, device="cpu", **skw), params=params)
    srv.engine.register_loras({"strong": ads["strong"]})
    direct = _port_engine(jeng, async_readback=False, max_seq_len=256)
    direct.register_loras(ads)
    body = dict(prompt="adapters route by model", max_tokens=6)

    async def serve():
        names = await srv.register_lora("zero", ads["zero"])
        outs = await asyncio.gather(
            srv.completions(dict(body, model="strong")),
            srv.completions(dict(body, model="zero")),
            srv.completions(dict(body)),
            srv.completions(dict(body, model="base-m")))
        info = await srv.model_info()
        return names, outs, info

    names, outs, info = asyncio.run(serve())
    assert names == ["strong", "zero"] and info["adapters"] == names
    toks = srv.tokenizer.encode(body["prompt"])
    for out, lo in zip(outs, ("strong", "zero", None, None)):
        want = direct.generate([list(toks)], te.SamplingParams(
            max_tokens=6, stop_token_ids=(srv.tokenizer.eos_id,)),
            loras=[lo])[0]
        assert out["choices"][0]["text"] == srv.tokenizer.decode(
            want.output_tokens), lo
    assert outs[1]["choices"][0]["text"] == outs[2]["choices"][0]["text"]
    with pytest.raises(ValueError, match=r"unknown model 'nope' \(base: "
                                         r"'base-m', adapters: \['strong', "
                                         r"'zero'\]\)"):
        asyncio.run(srv.completions(dict(body, model="nope")))
