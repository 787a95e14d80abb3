"""ray_tpu_torch.models.checkpoint_io against ray_tpu.models.checkpoint_io.

Mirrors tests/test_checkpoint_io.py without the mesh (this package has
none), and crosses the packages: files the JAX writer made load in the
port and the reverse, and the port's writer gives the JAX writer's
files byte for byte. Loads are exact (a copy, a transpose and, where
asked, an exact upcast); the trainer from a checkpoint holds
test_torch_training.py's tolerances against the JAX bundle; engines
from a checkpoint are token-exact (float32 debug model).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import checkpoint_io as jck
from ray_tpu.models import llama as jl
from ray_tpu.models import training as jtr
from ray_tpu.parallel import MeshSpec
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import checkpoint_io as tck
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as ttr
from ray_tpu_torch.models.weights import serving_dtypes

torch.set_num_threads(2)


def _np_params(preset, seed=0, **kw):
    jc = jl.config(preset, **kw)
    return jc, jax.tree_util.tree_map(
        np.asarray, jl.init_params(jc, jax.random.PRNGKey(seed)))


def _tcfg(preset, **kw):
    return tl.config(preset, **kw)


def _torch_tree(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.tensor(tree) if dtype is None else \
        torch.tensor(np.asarray(tree, np.float32)).to(dtype)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_tree_equal(ref, got):
    ref, got = dict(_leaves(ref)), dict(_leaves(got))
    assert ref.keys() == got.keys()
    for path, a in ref.items():
        b = got[path]
        b = b.detach().float().numpy() if isinstance(b, torch.Tensor) \
            else np.asarray(b, np.float32)
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=path)


# --------------------------------------------------------------- safetensors

def test_safetensors_roundtrip_and_slicing(tmp_path):
    path = str(tmp_path / "t.safetensors")
    tensors = {
        "a": torch.arange(24, dtype=torch.float32).reshape(4, 6),
        "b": torch.arange(10, dtype=torch.int32),
        "c": torch.full((3, 2), 0.5, dtype=torch.bfloat16),
        "d": np.arange(6, dtype=np.int64).reshape(2, 3),
    }
    tck.write_safetensors(path, tensors, metadata={"format": "pt"})
    f = tck.SafeTensorsFile(path)
    assert sorted(f.keys()) == ["a", "b", "c", "d"]
    assert f.metadata == {"format": "pt"}
    for name, t in tensors.items():
        t = torch.as_tensor(t)
        shape, dtype = f.info(name)
        assert shape == tuple(t.shape) and dtype == t.dtype
        assert torch.equal(f.tensor(name), t)
    # bf16 reads as its raw bits
    assert f.read("c").dtype == np.uint16
    np.testing.assert_array_equal(
        f.read("c"), tensors["c"].view(torch.uint16).numpy())
    # a windowed read touches only the slice
    np.testing.assert_array_equal(
        f.read("a", (slice(1, 3), slice(2, 5))),
        tensors["a"].numpy()[1:3, 2:5])
    assert torch.equal(f.tensor("a", (slice(1, 3), slice(2, 5))),
                       tensors["a"][1:3, 2:5])


def test_safetensors_files_byte_identical_and_cross_readable(tmp_path):
    """The same arrays (bf16 as ml_dtypes on the JAX side, torch bf16
    here) give the same file bytes; each reader reads the other's."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    c = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    n = np.arange(9, dtype=np.int32)
    jpath, tpath = str(tmp_path / "j.st"), str(tmp_path / "t.st")
    jck.write_safetensors(jpath, {"a": a, "c": c, "n": n},
                          metadata={"format": "pt", "x": 3})
    tck.write_safetensors(
        tpath, {"a": torch.from_numpy(a),
                "c": torch.from_numpy(c.view(np.uint16)).view(
                    torch.bfloat16), "n": n},
        metadata={"format": "pt", "x": 3})
    assert filecmp.cmp(jpath, tpath, shallow=False)
    jf, tf = jck.SafeTensorsFile(tpath), tck.SafeTensorsFile(jpath)
    np.testing.assert_array_equal(np.asarray(jf.read("c")), c)
    np.testing.assert_array_equal(
        tf.tensor("c").float().numpy(), c.astype(np.float32))
    assert tf.metadata == jf.metadata == {"format": "pt", "x": "3"}


# ------------------------------------------------------------------ HF layout

def _write_port_ckpt(tmp_path, preset, seed=0, max_shard_bytes=4 << 30,
                     **kw):
    jc, p = _np_params(preset, seed, **kw)
    tc = _tcfg(preset, **kw)
    ckpt = str(tmp_path / "ckpt")
    tck.save_llama_checkpoint(tc, _torch_tree(p), ckpt,
                              max_shard_bytes=max_shard_bytes)
    tck.save_config(tc, ckpt)
    return tc, p, ckpt


def test_hf_layout_roundtrip(tmp_path):
    tc, p, ckpt = _write_port_ckpt(tmp_path, "debug")
    loaded = tck.load_llama_params(tc, ckpt, device="cpu")
    assert all(t.dtype == torch.float32 for _, t in _leaves(loaded))
    _assert_tree_equal(p, loaded)
    cfg2 = tck.load_config(ckpt)
    assert (cfg2.hidden, cfg2.n_layers, cfg2.n_heads, cfg2.n_kv_heads,
            cfg2.ffn, cfg2.vocab_size) == (
        tc.hidden, tc.n_layers, tc.n_heads, tc.n_kv_heads, tc.ffn,
        tc.vocab_size)


def test_hf_layout_roundtrip_sharded_files(tmp_path):
    """A tiny max_shard_bytes forces the multi-file + index.json path."""
    tc, p, ckpt = _write_port_ckpt(tmp_path, "debug",
                                   max_shard_bytes=64 * 1024)
    assert os.path.exists(os.path.join(ckpt,
                                       "model.safetensors.index.json"))
    assert len([f for f in os.listdir(ckpt)
                if f.endswith(".safetensors")]) > 1
    _assert_tree_equal(p, tck.load_llama_params(tc, ckpt, device="cpu"))


def test_hf_layout_roundtrip_moe(tmp_path):
    tc, p, ckpt = _write_port_ckpt(tmp_path, "debug_moe")
    loaded = tck.load_llama_params(tc, ckpt, device="cpu")
    assert tuple(loaded["layers"]["router"].shape) == (2, 128, 4)
    assert tuple(loaded["layers"]["wd"].shape) == (2, 4, 256, 128)
    _assert_tree_equal(p, loaded)
    assert tck.load_config(ckpt).n_experts == 4


def test_tied_embeddings_fallback(tmp_path):
    """No lm_head tensor (Llama-3.2-style tying) -> embed.T is used."""
    tc, p, ckpt = _write_port_ckpt(tmp_path, "debug")
    path = os.path.join(ckpt, "model.safetensors")
    f = tck.SafeTensorsFile(path)
    # copies: read() gives views into the very file rewritten next
    tensors = {k: np.array(f.read(k)) for k in f.keys()
               if k != "lm_head.weight"}
    del f
    tck.write_safetensors(path, tensors)
    loaded = tck.load_llama_params(tc, ckpt, device="cpu")
    np.testing.assert_array_equal(loaded["lm_head"].numpy(), p["embed"].T)


def test_load_dtypes_and_serving_layout(tmp_path):
    """One dtype for every leaf, or a tree of them: the serving layout
    (matmuls in the compute dtype, norms in the storage dtype, the head
    float32) straight from the files."""
    tc, p, ckpt = _write_port_ckpt(tmp_path, "debug")
    bf = tck.load_llama_params(tc, ckpt, device="cpu",
                               dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(bf))
    srv = tck.load_llama_params(tc, ckpt, device="cpu",
                                dtype=serving_dtypes(tc))
    assert srv["layers"]["wq"].dtype == tc.dtype == torch.bfloat16
    assert srv["layers"]["ln1"].dtype == torch.float32
    assert srv["lm_head"].dtype == torch.float32
    assert torch.equal(srv["layers"]["wq"], bf["layers"]["wq"])


def test_llama38b_layout_shape_exact(tmp_path):
    """The Llama-3-8B architecture, depth cut to 2 layers, in true HF
    layout and bf16, loads shape- and dtype-exact; contents are zeros
    but for the layer-0 q_proj orientation probe (random zeros cost no
    draws), as in tests/test_checkpoint_io.py."""
    cfg = tl.config("8b", n_layers=2, max_seq=256)
    rng = np.random.default_rng(0)

    def t(shape, random=False):
        if random:
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16)
        return torch.zeros(shape, dtype=torch.bfloat16)

    tensors = {"model.embed_tokens.weight": t((cfg.vocab_size, cfg.hidden)),
               "model.norm.weight": t((cfg.hidden,)),
               "lm_head.weight": t((cfg.vocab_size, cfg.hidden))}
    for l in range(cfg.n_layers):
        p = f"model.layers.{l}."
        tensors[p + "self_attn.q_proj.weight"] = t(
            (cfg.q_dim, cfg.hidden), random=(l == 0))
        tensors[p + "self_attn.k_proj.weight"] = t((cfg.kv_dim, cfg.hidden))
        tensors[p + "self_attn.v_proj.weight"] = t((cfg.kv_dim, cfg.hidden))
        tensors[p + "self_attn.o_proj.weight"] = t((cfg.hidden, cfg.q_dim))
        tensors[p + "mlp.gate_proj.weight"] = t((cfg.ffn, cfg.hidden))
        tensors[p + "mlp.up_proj.weight"] = t((cfg.ffn, cfg.hidden))
        tensors[p + "mlp.down_proj.weight"] = t((cfg.hidden, cfg.ffn))
        tensors[p + "input_layernorm.weight"] = t((cfg.hidden,))
        tensors[p + "post_attention_layernorm.weight"] = t((cfg.hidden,))
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    tck.write_safetensors(os.path.join(ckpt, "model.safetensors"), tensors)
    tck.save_config(cfg, ckpt)
    loaded = tck.load_llama_params(cfg, ckpt, device="cpu",
                                   dtype=torch.bfloat16)
    assert tuple(loaded["layers"]["wq"].shape) == (cfg.n_layers, cfg.hidden,
                                                   cfg.q_dim)
    assert tuple(loaded["layers"]["wd"].shape) == (cfg.n_layers, cfg.ffn,
                                                   cfg.hidden)
    assert tuple(loaded["lm_head"].shape) == (cfg.hidden, cfg.vocab_size)
    assert all(a.dtype == torch.bfloat16 for _, a in _leaves(loaded))
    # orientation: wq row 0 of layer 0 == HF q_proj column 0
    assert torch.equal(loaded["layers"]["wq"][0, 0],
                       tensors["model.layers.0.self_attn.q_proj.weight"][:,
                                                                         0])
    assert torch.equal(loaded["layers"]["wq"][0].t(),
                       tensors["model.layers.0.self_attn.q_proj.weight"])


# --------------------------------------------------------- across packages

@pytest.mark.parametrize("preset,shard", [("debug", None),
                                          ("debug", 64 * 1024),
                                          ("debug_moe", None),
                                          ("debug_moe", 200 * 1024)],
                         ids=["dense", "dense_sharded", "moe",
                              "moe_sharded"])
def test_port_files_byte_identical_to_jax_writer(tmp_path, preset, shard):
    """The same numpy tree through both writers (float32; and bf16, the
    JAX tree as ml_dtypes, the port's as torch bf16): the same files,
    index included, byte for byte."""
    jc, p = _np_params(preset)
    tc = _tcfg(preset)
    kw = {} if shard is None else {"max_shard_bytes": shard}
    for tag, jtree, ttree in (
            ("f32", p, _torch_tree(p)),
            ("bf16", jax.tree_util.tree_map(
                lambda a: a.astype(ml_dtypes.bfloat16), p),
             _torch_tree(p, torch.bfloat16))):
        jdir, tdir = str(tmp_path / f"j_{tag}"), str(tmp_path / f"t_{tag}")
        jck.save_llama_checkpoint(jc, jtree, jdir, **kw)
        jck.save_config(jc, jdir)
        tck.save_llama_checkpoint(tc, ttree, tdir, **kw)
        tck.save_config(tc, tdir)
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(tdir))
        assert (len(names) > 2) == (shard is not None)
        match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names,
                                                   shallow=False)
        assert not mismatch and not errors, (tag, mismatch, errors)


@pytest.mark.parametrize("preset", ["debug", "debug_moe"])
def test_checkpoints_cross_load(tmp_path, preset):
    """A checkpoint the JAX writer made loads in the port equal (and at
    bf16 equal to the JAX loader's bf16), and the port's in JAX."""
    jc, p = _np_params(preset)
    tc = _tcfg(preset)
    jdir = str(tmp_path / "j")
    jck.save_llama_checkpoint(jc, p, jdir, max_shard_bytes=128 * 1024)
    jck.save_config(jc, jdir)
    _assert_tree_equal(p, tck.load_llama_params(tck.load_config(jdir),
                                                jdir, device="cpu"))
    jbf = jck.load_llama_params(jc, jdir, dtype=jnp.bfloat16)
    tbf = tck.load_llama_params(tc, jdir, device="cpu",
                                dtype=torch.bfloat16)
    _assert_tree_equal(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jbf), tbf)
    tdir = str(tmp_path / "t")
    tck.save_llama_checkpoint(tc, _torch_tree(p), tdir)
    tck.save_config(tc, tdir)
    _assert_tree_equal(p, jck.load_llama_params(jck.load_config(tdir),
                                                tdir))


# ------------------------------------------------------------ consumers

def test_trainer_from_checkpoint_matches_jax_bundle(tmp_path):
    """init_state_from_checkpoint on both sides from one checkpoint, then
    three steps: loss and grad_norm each step (rtol 1e-5), parameters as
    test_torch_training.py holds them."""
    jc = jl.config("debug", dtype=jnp.float32,
                   attention_impl="pallas_interpret", loss_chunk=16)
    tc = tl.config("debug", dtype=torch.float32, attention_impl="pallas",
                   loss_chunk=16)
    _, p = _np_params("debug", seed=3)
    ckpt = str(tmp_path / "ckpt")
    jck.save_llama_checkpoint(jc, p, ckpt)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = MeshSpec(dp=1, fsdp=1, sp=1, tp=1).build([jax.devices()[0]])
    jb = jtr.TrainStepBundle(jc, mesh, optimizer=jtr.default_optimizer(**kw))
    tb = ttr.TrainStepBundle(tc, "cpu", optimizer=ttr.default_optimizer(**kw))
    js = jb.init_state_from_checkpoint(ckpt)
    ts = tb.init_state_from_checkpoint(ckpt)
    for _, t in _leaves(ts[0]):
        assert t.is_leaf and t.requires_grad and t.dtype == torch.float32
    _assert_tree_equal(p, ts[0])
    assert ts[1]["count"] == 0
    toks = np.random.default_rng(2).integers(0, 256, (2, 64)).astype(
        np.int32)
    jt, tt = jb.shard_batch(jnp.asarray(toks)), tb.shard_batch(toks)
    for i in range(3):
        js, mj = jb.step(js, jt)
        ts, mt = tb.step(ts, tt)
        for k in mj:
            np.testing.assert_allclose(mt[k].item(), float(mj[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    lr = kw["learning_rate"]
    pj = dict(_leaves(jax.tree_util.tree_map(np.asarray, js[0])))
    for path, b in _leaves(ts[0]):
        d = np.abs(b.detach().numpy() - pj[path])
        assert np.mean(d > 1e-6) < 1e-3, (path, np.mean(d > 1e-6))
        assert d.max() < 0.25 * lr, (path, d.max())


ENGINE_KW = dict(max_batch_size=3, page_size=8, num_pages=64,
                 max_prefill_tokens=16, seed=9)


def _drive(eng, mod, prompts):
    reqs = [mod.Request(f"r{i}", list(p),
                        mod.SamplingParams(max_tokens=12, temperature=0.0))
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.add_request(r)
    for r in reqs[2:]:
        eng.step()
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [list(r.output_tokens) for r in reqs]


def test_engine_from_checkpoint_token_exact(tmp_path):
    """An engine from the checkpoint decodes token-exact against the
    port engine from the source params and against the JAX gather
    engine from the same checkpoint; model=None resolves the
    architecture from config.json."""
    jc = jl.config("debug", dtype=jnp.float32)
    tc = tl.config("debug", dtype=torch.float32)
    _, p = _np_params("debug", seed=5)
    ckpt = str(tmp_path / "ckpt")
    tck.save_llama_checkpoint(tc, _torch_tree(p), ckpt)
    tck.save_config(tc, ckpt)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (24, 9, 31, 5)]
    jeng = je.InferenceEngine(je.EngineConfig(
        model=jc, checkpoint=ckpt, prefill_buckets=(16, 32, 64),
        decode_impl="gather", async_readback=False, **ENGINE_KW))
    want = _drive(jeng, je, prompts)
    from_params = te.InferenceEngine(te.EngineConfig(
        model=tc, device="cpu", **ENGINE_KW), params=p)
    from_ckpt = te.InferenceEngine(te.EngineConfig(
        model=tc, device="cpu", checkpoint=ckpt, **ENGINE_KW))
    for name, t in _leaves(from_ckpt.params):
        assert torch.equal(t, dict(_leaves(from_params.params))[name]), name
    assert _drive(from_params, te, prompts) == want
    assert _drive(from_ckpt, te, prompts) == want
    assert all(len(o) == 12 for o in want)
    # model=None: the architecture from config.json (the compute dtype is
    # not in the file: the default, bf16)
    eng = te.InferenceEngine(te.EngineConfig(
        model=None, device="cpu", checkpoint=ckpt, **ENGINE_KW))
    assert (eng.model_cfg.hidden, eng.model_cfg.n_layers,
            eng.model_cfg.vocab_size) == (tc.hidden, tc.n_layers,
                                          tc.vocab_size)
    assert eng.params["layers"]["wq"].dtype == torch.bfloat16
    assert eng.params["lm_head"].dtype == torch.float32
    with pytest.raises(ValueError, match="checkpoint"):
        te.EngineConfig(model=None).resolve_model()


def test_loader_raises_without_cuda(tmp_path, monkeypatch):
    tc, _, ckpt = _write_port_ckpt(tmp_path, "debug")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.load_llama_params(tc, ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.TrainStepBundle(tc).init_state_from_checkpoint(ckpt)
