"""ray_tpu_torch's RTKV wire and session/prefix transport against
ray_tpu's.

- frames: the port encodes the reference's bytes for the same state
  (f32, f16, bf16, int8 and fp8 pages, scales, cold sessions, prefixes),
  each side decodes the other's frames byte-exact, and corruption,
  truncation and crc-valid lying headers raise TransportError;
- sessions cross the packages: one exported mid-decode by the JAX engine
  continues token-exact in the port, and one exported by the port
  continues token-exact in the JAX engine, greedy and sampled, on f32,
  int8 and fp8 pages, both port impls (through the wire both ways);
  the JAX engine is the gather engine with async_readback=False, as in
  tests/test_torch_engine_pipeline.py;
- the port's own moves: cold export from the waiting queue, a renamed
  session keeps its exporter's seed, every refusal of import_session,
  a prefix exported by either engine and imported into the port hits on
  the next admission and leaves the stream exact.

float32 debug model, CPU.
"""

import json
import struct
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu.serve.llm import kv_transport as jkvt
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import kv_transport as tkvt

torch.set_num_threads(1)

ENGINE_KW = dict(max_batch_size=4, page_size=8, num_pages=128, seed=7,
                 max_seq_len=1024, max_prefill_tokens=32,
                 enable_kv_offload=True)
KINDS = ["f32", "int8", "fp8"]
SP = {
    "greedy": dict(max_tokens=24),
    "sampled": dict(max_tokens=24, temperature=0.8, top_p=0.9, top_k=20,
                    seed=4242),
}
# torch dtype -> the numpy dtype the reference holds the same bits in
_ML = {torch.bfloat16: ml_dtypes.bfloat16,
       torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn}


def _jax_engine(**over):
    kw = dict(ENGINE_KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS.update(jax.tree_util.tree_map(
            np.asarray, _jax_engine(enable_kv_offload=False).params))
    return _PARAMS


def _engine(**over):
    kw = dict(ENGINE_KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu")
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _run(eng, cap=5000):
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < cap, "engine failed to converge"


def _prompts():
    rng = np.random.default_rng(11)
    return {"greedy": rng.integers(2, 250, 20).tolist(),
            "sampled": rng.integers(2, 250, 27).tolist()}


def _to_ref(arr):
    """A port array as the reference holds it (numpy, ml_dtypes)."""
    if isinstance(arr, torch.Tensor):
        bits = arr.view(torch.uint8 if arr.element_size() == 1
                        else torch.int16).numpy()
        return bits.view(_ML[arr.dtype])
    return arr


def _bytes(arr):
    return tkvt._array_bytes(arr)[2]


# ------------------------------------------------------------------ wire

def _random_state(rng, dtype, kind="f32"):
    L, n_pages = int(rng.integers(1, 3)), int(rng.integers(1, 6))
    page, H, D = int(rng.choice([4, 8])), int(rng.integers(1, 3)), \
        int(rng.choice([4, 8]))
    shape = (L, n_pages, page, H, D)
    vals = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    if dtype in (torch.bfloat16, torch.float8_e4m3fn):
        k, v = (torch.from_numpy(x).to(dtype) for x in vals)
    elif dtype == np.int8:
        k, v = (np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                for x in vals)
    else:
        k, v = (x.astype(dtype) for x in vals)
    state = {
        "request_id": f"req-{rng.integers(1 << 30)}",
        "prompt_tokens": rng.integers(2, 250, 9).tolist(),
        "output_tokens": rng.integers(2, 250, 3).tolist(),
        "params": {"max_tokens": 40, "temperature": float(rng.random()),
                   "top_p": 0.9, "top_k": 3, "repetition_penalty": 1.1,
                   "stop_token_ids": [0], "seed": 123},
        "lora": None, "priority": int(rng.integers(-2, 3)), "tenant": "t",
        "restarts": 1, "trace": None, "deadline_epoch": None,
        "seed": int(rng.integers(1 << 31)),
        "position": (n_pages - 1) * page + int(rng.integers(1, page + 1)),
        "last_token": int(rng.integers(2, 250)), "n_pages": n_pages,
        "k": k, "v": v, "kv_dtype": kind,
    }
    if kind != "f32":
        state["k_scales"] = rng.random(shape[:-1]).astype(np.float32)
        state["v_scales"] = rng.random(shape[:-1]).astype(np.float32)
    return state


WIRE_DTYPES = {"f32": (np.float32, "f32"), "f16": (np.float16, "f32"),
               "bf16": (torch.bfloat16, "f32"), "int8": (np.int8, "int8"),
               "fp8": (torch.float8_e4m3fn, "fp8")}


@pytest.mark.parametrize("name", list(WIRE_DTYPES))
def test_session_frames_are_the_references_bytes(name):
    dtype, kind = WIRE_DTYPES[name]
    rng = np.random.default_rng(42)
    for _ in range(6):
        state = _random_state(rng, dtype, kind)
        ref_state = {k: _to_ref(v) for k, v in state.items()}
        blob = tkvt.encode_session(state)
        assert blob == jkvt.encode_session(ref_state)
        assert blob == tkvt.encode_session(ref_state)     # numpy in
        ours = tkvt.decode_session(blob)
        theirs = jkvt.decode_session(blob)
        for key in ("request_id", "prompt_tokens", "output_tokens",
                    "params", "priority", "seed", "position", "last_token",
                    "n_pages", "kv_dtype"):
            assert ours[key] == theirs[key] == state[key], key
        for arr in ("k", "v", "k_scales", "v_scales"):
            if state.get(arr) is None:
                assert ours[arr] is None and theirs[arr] is None
                continue
            assert _bytes(ours[arr]) == _bytes(state[arr]) \
                == theirs[arr].tobytes()
            assert tuple(ours[arr].shape) == tuple(state[arr].shape)
        if isinstance(state["k"], torch.Tensor):
            assert ours["k"].dtype == state["k"].dtype
        # the reference's frame decodes here to the same state
        back = tkvt.decode_session(jkvt.encode_session(ref_state))
        assert _bytes(back["k"]) == _bytes(state["k"])
        assert tkvt.from_b64(tkvt.to_b64(blob)) == blob


def test_cold_session_and_prefix_frames():
    rng = np.random.default_rng(7)
    state = _random_state(rng, np.float32)
    state.update(n_pages=0, position=0, last_token=0, k=None, v=None,
                 output_tokens=[])
    blob = tkvt.encode_session(state)
    assert blob == jkvt.encode_session(state)
    out = tkvt.decode_session(blob)
    assert out["k"] is None and out["n_pages"] == 0
    k = torch.from_numpy(rng.standard_normal((2, 3, 8, 2, 4)).astype(
        np.float32)).to(torch.float8_e4m3fn)
    sc = rng.random((2, 3, 8, 2)).astype(np.float32)
    toks = list(range(2, 26))
    blob = tkvt.encode_prefix(toks, k, k, sc, sc, kv_dtype="fp8")
    assert blob == jkvt.encode_prefix(toks, _to_ref(k), _to_ref(k), sc, sc,
                                      kv_dtype="fp8")
    pfx = tkvt.decode_prefix(blob)
    assert pfx["tokens"] == toks and pfx["kv_dtype"] == "fp8"
    assert _bytes(pfx["v"]) == _bytes(k)
    assert pfx["k_scales"].tobytes() == sc.tobytes()
    ref = jkvt.decode_prefix(blob)
    assert ref["k"].tobytes() == _bytes(k)
    f32 = tkvt.decode_prefix(tkvt.encode_prefix(toks, sc[..., None],
                                                sc[..., None]))
    assert f32["kv_dtype"] == "f32" and f32["k_scales"] is None


def test_corruption_and_lying_headers_raise():
    rng = np.random.default_rng(3)
    blob = tkvt.encode_session(_random_state(rng, np.float32))
    for frac in (0.1, 0.3, 0.5, 0.7, 0.95):
        bad = bytearray(blob)
        bad[int(len(bad) * frac)] ^= 0xFF
        with pytest.raises(tkvt.TransportError):
            tkvt.decode_session(bytes(bad))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(tkvt.TransportChecksumError):
        tkvt.decode_session(bytes(bad))
    for cut in (0, 3, 8, len(blob) // 2, len(blob) - 1):
        with pytest.raises(tkvt.TransportError):
            tkvt.decode_session(blob[:cut])
    for junk in (b"NOPE" + blob[4:], b"not even a frame", "text"):
        with pytest.raises(tkvt.TransportError):
            tkvt.decode_session(junk)
    with pytest.raises(tkvt.TransportError):
        tkvt.from_b64("!!! not base64 !!!")
    with pytest.raises(tkvt.TransportError, match="kind"):
        tkvt.decode_session(tkvt.encode_prefix(
            [1, 2], np.zeros((1, 1, 2, 1, 2), np.float32),
            np.zeros((1, 1, 2, 1, 2), np.float32)))

    def relabel(blob, edit):
        _, hlen = struct.unpack("<HI", blob[4:10])
        header = json.loads(blob[10:10 + hlen])
        edit(header)
        new = json.dumps(header, sort_keys=True).encode()
        body = (blob[:4] + struct.pack("<HI", tkvt.WIRE_VERSION, len(new))
                + new + blob[10 + hlen:-4])
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    def grow_shape(h):
        h["arrays"][0]["shape"][0] += 1

    def bad_dtype(h):
        h["arrays"][0]["dtype"] = "complex_bits"

    def drop_scales(h):
        h["meta"]["kv_dtype"] = "int8"

    with pytest.raises(tkvt.TransportError, match="array"):
        tkvt.decode_session(relabel(blob, grow_shape))
    with pytest.raises(tkvt.TransportError, match="dtype"):
        tkvt.decode_session(relabel(blob, bad_dtype))
    with pytest.raises(tkvt.TransportError, match="scale"):
        tkvt.decode_session(relabel(blob, drop_scales))
    with pytest.raises(tkvt.TransportError, match="mismatch"):
        tkvt.ship_kind_compatible("int8", "fp8")
    assert tkvt.ship_kind_compatible(None, "f32") == "f32"


# ------------------------------------------- sessions across packages

def _oracle(kind):
    """Never-moved port streams of both workloads, run together."""
    eng = _engine(kv_dtype=kind)
    reqs = {m: te.Request(m, list(p), te.SamplingParams(**SP[m]))
            for m, p in _prompts().items()}
    for r in reqs.values():
        eng.add_request(r)
    _run(eng)
    return {m: r.output_tokens for m, r in reqs.items()}


def _export_both(eng, mod, after=5):
    """Run both workloads to `after` tokens, export them."""
    reqs = {m: mod.Request(m, list(p), mod.SamplingParams(**SP[m]))
            for m, p in _prompts().items()}
    for r in reqs.values():
        eng.add_request(r)
    while min(len(r.output_tokens) for r in reqs.values()) < after:
        eng.step()
    out = {}
    for m, r in reqs.items():
        out[m] = eng.export_session(m, reason="test")
        assert out[m] is not None and out[m]["n_pages"] > 0
        assert r.finish_reason == "migrated"
    return out


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", KINDS)
def test_sessions_cross_both_ways_token_exact(kind, impl):
    want = _oracle(kind)
    jeng = _jax_engine(kv_dtype=kind)
    from_jax = _export_both(jeng, je)
    port = _engine(kv_dtype=kind, decode_impl=impl)
    got = {m: port.import_session(tkvt.decode_session(
        jkvt.encode_session(st))) for m, st in from_jax.items()}
    _run(port)
    for m in SP:
        assert got[m].output_tokens == want[m], ("jax -> port", m)
        assert got[m].finish_reason == "length"
    assert port.host_tier.restores_total == 2
    assert port.host_tier.spills_total == 0

    src = _engine(kv_dtype=kind, decode_impl=impl)
    from_port = _export_both(src, te)
    assert src.host_tier.exports_total == 2 and len(src.host_tier) == 0
    assert src.host_tier.used_bytes == 0
    back = {m: jeng.import_session(jkvt.decode_session(
        tkvt.encode_session(st))) for m, st in from_port.items()}
    _run(jeng)
    for m in SP:
        assert back[m].output_tokens == want[m], ("port -> jax", m)
    # a prefix the JAX engine prefilled seeds the port's cache
    prompt = _prompts()["greedy"]
    exp = jeng.export_prefix(prompt)
    pfx = tkvt.decode_prefix(jkvt.encode_prefix(
        exp["tokens"], exp["k"], exp["v"], exp.get("k_scales"),
        exp.get("v_scales"), kv_dtype=exp["kv_dtype"]))
    fresh = _engine(kv_dtype=kind, decode_impl=impl)
    assert fresh.import_prefix(pfx["tokens"], pfx["k"], pfx["v"],
                               pfx["k_scales"], pfx["v_scales"],
                               kv_dtype=pfx["kv_dtype"]) == 2
    req = te.Request("greedy", list(prompt), te.SamplingParams(**SP["greedy"]))
    fresh.add_request(req)
    _run(fresh)
    assert fresh.allocator.cache_hit_tokens == 16
    assert req.output_tokens == want["greedy"]


def test_renamed_session_keeps_its_seed():
    """The importer pins the exporter's resolved seed, so a session
    derived from its request id continues exact under another id."""
    sp = dict(max_tokens=20, temperature=0.9, top_k=30)
    prompt = _prompts()["sampled"]
    want = _engine().generate([prompt], te.SamplingParams(**sp))
    src = _engine()
    req = te.Request(want[0].request_id, list(prompt),
                     te.SamplingParams(**sp))
    src.add_request(req)
    while len(req.output_tokens) < 6:
        src.step()
    state = tkvt.decode_session(tkvt.encode_session(
        src.export_session(req.request_id)))
    state["request_id"] = "renamed"
    dst = _engine()
    got = dst.import_session(state)
    _run(dst)
    assert got.params.seed == te.derive_seed(want[0].request_id)
    assert got.output_tokens == want[0].output_tokens


def test_cold_export_from_the_waiting_queue():
    rng = np.random.default_rng(13)
    prompts = [rng.integers(2, 250, 12).tolist() for _ in range(2)]
    want = _engine().generate([prompts[1]], te.SamplingParams(max_tokens=8))
    a = _engine(max_batch_size=1)
    a.add_request(te.Request("w0", prompts[0],
                             te.SamplingParams(max_tokens=8)))
    a.add_request(te.Request("w1", prompts[1],
                             te.SamplingParams(max_tokens=8)))
    state = a.export_session("w1")
    assert state is not None and state["n_pages"] == 0 and state["k"] is None
    assert a.session_ids() == ["w0"]
    b = _engine()
    req = b.import_session(tkvt.decode_session(tkvt.encode_session(state)))
    _run(b)
    _run(a)
    assert req.output_tokens == want[0].output_tokens
    assert a.export_session("absent") is None


def test_import_session_refusals():
    prompt = _prompts()["greedy"]
    a = _engine()
    r = te.Request("dup", list(prompt), te.SamplingParams(max_tokens=24))
    a.add_request(r)
    while len(r.output_tokens) < 3:
        a.step()
    state = a.export_session("dup")
    b = _engine()
    b.import_session(dict(state))
    with pytest.raises(ValueError, match="already live"):
        b.import_session(dict(state))
    c = _engine()
    k, v = state["k"], state["v"]
    cases = [
        (dict(state, n_pages=0, k=None, v=None), "replay"),
        (dict(state, position=1), "inconsistent"),
        (dict(state, prompt_tokens=list(range(2, 1010))), "max_seq_len"),
        (dict(state, kv_dtype="int8"), "dtype kind"),
        (dict(state, k=k[:, :, :4], v=v[:, :, :4]), "geometry"),
        (dict(state, k=k.astype(np.float16), v=v.astype(np.float16)),
         "dtype"),
        (dict(state, lora="adapter"), "LoRA"),
    ]
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            c.import_session(bad)
    with pytest.raises(ValueError, match="enable_kv_offload"):
        _engine(enable_kv_offload=False).import_session(dict(state))
    with pytest.raises(MemoryError):
        _engine(host_kv_pages=1).import_session(dict(state))
    # quantized pages: scales required, and never across kinds
    q = _engine(kv_dtype="int8")
    rq = te.Request("q", list(prompt), te.SamplingParams(max_tokens=24))
    q.add_request(rq)
    while len(rq.output_tokens) < 3:
        q.step()
    qstate = q.export_session("q")
    assert qstate["k"].dtype == np.int8 and qstate["k_scales"] is not None
    with pytest.raises(ValueError, match="missing"):
        _engine(kv_dtype="int8").import_session(dict(qstate, k_scales=None))
    with pytest.raises(ValueError, match="dtype kind"):
        _engine(kv_dtype="fp8").import_session(dict(qstate))
    assert c.session_ids() == [] and len(c.host_tier) == 0
    _run(b)
    assert b.host_tier.restores_total == 1


def test_prefix_export_import_hits_and_is_exact():
    sys_prefix = list(range(2, 34))        # 4 full pages
    a = _engine()
    a.add_request(te.Request("p0", sys_prefix + [100, 101, 102],
                             te.SamplingParams(max_tokens=6)))
    _run(a)
    exp = a.export_prefix(sys_prefix)
    assert exp is not None and exp["k"].shape[1] == 4
    assert a.export_prefix([9, 9, 9]) is None
    pfx = tkvt.decode_prefix(tkvt.encode_prefix(exp["tokens"], exp["k"],
                                                exp["v"]))
    b = _engine()
    assert b.import_prefix(pfx["tokens"], pfx["k"], pfx["v"]) == 4
    assert b.import_prefix(pfx["tokens"], pfx["k"], pfx["v"]) == 0
    with pytest.raises(ValueError, match="kind"):
        b.import_prefix(pfx["tokens"], pfx["k"], pfx["v"], kv_dtype="fp8")
    prompt = sys_prefix + [110, 111, 112, 113]
    want = _engine().generate([prompt], te.SamplingParams(max_tokens=8))
    req = te.Request("p1", prompt, te.SamplingParams(max_tokens=8))
    b.add_request(req)
    _run(b)
    assert b.allocator.cache_hit_tokens == 32
    assert req.output_tokens == want[0].output_tokens
