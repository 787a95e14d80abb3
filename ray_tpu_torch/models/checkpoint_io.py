"""HF-layout safetensors checkpoints for the Llama family.

PyTorch counterpart of ``ray_tpu/models/checkpoint_io.py``:

- a self-contained safetensors parser (8-byte little-endian header
  length, JSON header, raw tensor bytes) over ``np.memmap``, so a read
  touches only the bytes of the window it asks for;
- the HF Llama and Mixtral name and layout mapping onto this package's
  stacked-layer tree (``llama.init_params``: layers stacked on a leading
  axis, matrices stored (in, out), the transpose of HF's (out, in));
- a writer (HF layout, size-sharded files and
  ``model.safetensors.index.json``) whose files are byte-identical to
  the JAX package's for the same tree.

The JAX loader builds each leaf with ``jax.make_array_from_callback``
on a mesh. This package has no mesh: each leaf is allocated on the
device and filled one HF tensor at a time (a layer, or a layer's
expert), moved raw and transposed and cast on the device, so host
memory stays at one HF tensor. bfloat16 travels as its raw ``uint16``
bits (numpy has no bfloat16) and is viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import llama

_DTYPES: Dict[str, Tuple[Any, torch.dtype]] = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
    "U16": (np.uint16, torch.uint16), "U32": (np.uint32, torch.uint32),
    "U64": (np.uint64, torch.uint64),
}
_TORCH_NAMES = {t: k for k, (_, t) in _DTYPES.items()}
_NUMPY_NAMES = {np.dtype(n): k for k, (n, _) in _DTYPES.items()
                if k != "BF16"}


class SafeTensorsFile:
    """Zero-copy reader: ``read`` returns a memory-mapped view of the
    window asked for (BF16 as its uint16 bits); ``tensor`` the same
    window as a CPU tensor of the stored dtype."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self.tensors: Dict[str, dict] = header
        self._base = 8 + hlen
        # copy-on-write: writable views for torch.from_numpy; the file
        # itself is never written
        self._mm = np.memmap(path, np.uint8, mode="c")

    def keys(self) -> List[str]:
        return list(self.tensors)

    def info(self, name: str) -> Tuple[Tuple[int, ...], torch.dtype]:
        ent = self.tensors[name]
        return tuple(ent["shape"]), _DTYPES[ent["dtype"]][1]

    def read(self, name: str, index: Any = None) -> np.ndarray:
        ent = self.tensors[name]
        a, b = ent["data_offsets"]
        arr = self._mm[self._base + a:self._base + b].view(
            _DTYPES[ent["dtype"]][0]).reshape(tuple(ent["shape"]))
        return arr if index is None else arr[index]

    def tensor(self, name: str, index: Any = None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(self.read(name, index)))
        return t.view(self.info(name)[1])


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return _TORCH_NAMES[t.dtype]
    if t.dtype.name == "bfloat16":          # an ml_dtypes array
        return "BF16"
    return _NUMPY_NAMES[t.dtype]


def _host_bytes(t) -> np.ndarray:
    """A C-contiguous numpy array of `t`'s bytes (torch tensors leave
    the device one at a time, transposed there first)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy()
    t = np.ascontiguousarray(t)
    return t.view(np.uint16) if t.dtype.name == "bfloat16" else t


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """`tensors`: name -> numpy array or torch tensor (any device). The
    header is the JAX writer's, byte for byte."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    off = 0
    for name, t in tensors.items():
        nbytes = (t.numel() * t.element_size()
                  if isinstance(t, torch.Tensor) else t.nbytes)
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * (-len(hjson) % 8)          # HF pads headers with spaces
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for t in tensors.values():
            f.write(_host_bytes(t).data)


class _FileSet:
    """Resolves tensor names across a single- or index-sharded checkpoint
    directory; files open lazily and stay cached (mmap is cheap)."""

    def __init__(self, ckpt_dir: str):
        self.dir = ckpt_dir
        self._open: Dict[str, SafeTensorsFile] = {}
        index = os.path.join(ckpt_dir, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        else:
            single = os.path.join(ckpt_dir, "model.safetensors")
            if os.path.isfile(ckpt_dir):           # direct file path
                single, self.dir = ckpt_dir, os.path.dirname(ckpt_dir)
            st = SafeTensorsFile(single)
            self._open[os.path.basename(single)] = st
            self.weight_map = {k: os.path.basename(single)
                               for k in st.keys()}

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def file(self, name: str) -> SafeTensorsFile:
        fname = self.weight_map[name]
        if fname not in self._open:
            self._open[fname] = SafeTensorsFile(
                os.path.join(self.dir, fname))
        return self._open[fname]

    def tensor(self, name: str) -> torch.Tensor:
        return self.file(name).tensor(name)

    def info(self, name: str) -> Tuple[Tuple[int, ...], torch.dtype]:
        return self.file(name).info(name)


# ------------------------------------------------------------------ HF naming

_L = "model.layers.{l}."


class _Leaf:
    """One target leaf: its shape and a writer that fills a tensor of
    that shape one HF tensor at a time."""

    def __init__(self, shape: Tuple[int, ...],
                 fill: Callable[[torch.Tensor], None]):
        self.shape = tuple(shape)
        self.fill = fill


def _put(files: _FileSet, name: str, out: torch.Tensor,
         transpose: bool) -> None:
    """HF tensor `name` into `out`: the stored bytes go to out's device
    as they are, the transpose and the cast run there."""
    src = files.tensor(name).to(out.device)
    out.copy_(src.t() if transpose else src)


def _direct(files: _FileSet, name: str, shape) -> _Leaf:
    return _Leaf(shape, lambda out: _put(files, name, out, False))


def _transposed(files: _FileSet, name: str, shape) -> _Leaf:
    return _Leaf(shape, lambda out: _put(files, name, out, True))


def _stacked(files: _FileSet, fmt: str, shape, transpose: bool) -> _Leaf:
    """Target (L, *rest) stacking per-layer HF tensors on a new leading
    axis, one layer at a time."""
    def fill(out):
        for l in range(shape[0]):
            _put(files, fmt.format(l=l), out[l], transpose)
    return _Leaf(shape, fill)


def _stacked_experts(files: _FileSet, fmt: str, shape) -> _Leaf:
    """Target (L, E, a, b) from per-layer-per-expert HF tensors stored
    (b, a) (Mixtral block_sparse_moe layout)."""
    def fill(out):
        for l in range(shape[0]):
            for e in range(shape[1]):
                _put(files, fmt.format(l=l, e=e), out[l, e], True)
    return _Leaf(shape, fill)


def _llama_leaf_specs(cfg: llama.LlamaConfig,
                      files: _FileSet) -> Dict[str, Any]:
    """Tree of _Leaf writers mirroring init_params' structure (and its
    key order, which fixes the order of a bundle's leaves)."""
    h, L, v = cfg.hidden, cfg.n_layers, cfg.vocab_size
    if cfg.n_experts:
        E, F = cfg.n_experts, cfg.ffn
        mlp = {
            "router": _stacked(
                files, _L + "block_sparse_moe.gate.weight",
                (L, h, E), transpose=True),
            # Mixtral: w1=gate, w3=up(in), w2=down
            "wi": _stacked_experts(
                files, _L + "block_sparse_moe.experts.{e}.w3.weight",
                (L, E, h, F)),
            "wg": _stacked_experts(
                files, _L + "block_sparse_moe.experts.{e}.w1.weight",
                (L, E, h, F)),
            "wd": _stacked_experts(
                files, _L + "block_sparse_moe.experts.{e}.w2.weight",
                (L, E, F, h)),
        }
    else:
        mlp = {
            "wi": _stacked(files, _L + "mlp.up_proj.weight",
                           (L, h, cfg.ffn), transpose=True),
            "wg": _stacked(files, _L + "mlp.gate_proj.weight",
                           (L, h, cfg.ffn), transpose=True),
            "wd": _stacked(files, _L + "mlp.down_proj.weight",
                           (L, cfg.ffn, h), transpose=True),
        }
    if "lm_head.weight" in files:
        lm_head = _transposed(files, "lm_head.weight", (h, v))
    else:   # tied embeddings (Llama-3.2 1B/3B ship no lm_head tensor)
        lm_head = _transposed(files, "model.embed_tokens.weight", (h, v))
    return {
        "embed": _direct(files, "model.embed_tokens.weight", (v, h)),
        "layers": {
            "wq": _stacked(files, _L + "self_attn.q_proj.weight",
                           (L, h, cfg.q_dim), transpose=True),
            "wk": _stacked(files, _L + "self_attn.k_proj.weight",
                           (L, h, cfg.kv_dim), transpose=True),
            "wv": _stacked(files, _L + "self_attn.v_proj.weight",
                           (L, h, cfg.kv_dim), transpose=True),
            "wo": _stacked(files, _L + "self_attn.o_proj.weight",
                           (L, cfg.q_dim, h), transpose=True),
            **mlp,
            "ln1": _stacked(files, _L + "input_layernorm.weight",
                            (L, h), transpose=False),
            "ln2": _stacked(files, _L + "post_attention_layernorm.weight",
                            (L, h), transpose=False),
        },
        "final_norm": _direct(files, "model.norm.weight", (h,)),
        "lm_head": lm_head,
    }


def _resolve_device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_llama_params loads onto CUDA by default "
                           "and no CUDA device is available; pass "
                           "device='cpu' to load on the CPU")
    return dev


@torch.no_grad()
def load_llama_params(cfg: llama.LlamaConfig, ckpt_dir: str, device=None,
                      dtype: Any = None) -> Dict[str, Any]:
    """Load an HF-layout Llama (or Mixtral) safetensors checkpoint into
    this package's parameter tree on `device` (the card by default).

    `dtype` is one dtype for every leaf (default ``cfg.param_dtype``)
    or a tree of dtypes mirroring the parameter tree
    (``weights.serving_dtypes`` gives the serving layout's). Every leaf
    is allocated on the device and filled one HF tensor at a time."""
    device = _resolve_device(device)
    dtype = dtype or cfg.param_dtype
    specs = _llama_leaf_specs(cfg, _FileSet(ckpt_dir))

    def build(leaf, dt):
        if isinstance(leaf, dict):
            return {k: build(v, dt[k] if isinstance(dt, dict) else dt)
                    for k, v in leaf.items()}
        out = torch.empty(leaf.shape, dtype=dt, device=device)
        leaf.fill(out)
        return out
    return build(specs, dtype)


def save_llama_checkpoint(cfg: llama.LlamaConfig, params: Dict[str, Any],
                          out_dir: str,
                          max_shard_bytes: int = 4 << 30) -> None:
    """Write params (tensors on any device, or numpy arrays) in the HF
    Llama safetensors layout: per-layer tensors, torch (out, in)
    orientation, size-sharded files and an index. The same tree gives
    the JAX writer's files, byte for byte."""
    os.makedirs(out_dir, exist_ok=True)
    layers = params["layers"]
    tensors: Dict[str, Any] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": params["lm_head"].T,
    }
    per_layer = {
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "input_layernorm.weight": ("ln1", False),
        "post_attention_layernorm.weight": ("ln2", False),
    }
    if cfg.n_experts:
        for l in range(cfg.n_layers):
            tensors[_L.format(l=l) + "block_sparse_moe.gate.weight"] = (
                layers["router"][l].T)
            for e in range(cfg.n_experts):
                base = _L.format(l=l) + f"block_sparse_moe.experts.{e}."
                tensors[base + "w1.weight"] = layers["wg"][l, e].T
                tensors[base + "w3.weight"] = layers["wi"][l, e].T
                tensors[base + "w2.weight"] = layers["wd"][l, e].T
    else:
        per_layer.update({
            "mlp.gate_proj.weight": ("wg", True),
            "mlp.up_proj.weight": ("wi", True),
            "mlp.down_proj.weight": ("wd", True),
        })
    for l in range(cfg.n_layers):
        for hf_name, (ours, transpose) in per_layer.items():
            t = layers[ours][l]
            tensors[_L.format(l=l) + hf_name] = t.T if transpose else t

    # size-sharded emission
    shards: List[Dict[str, Any]] = [{}]
    sizes = [0]
    for name, t in tensors.items():
        nbytes = (t.numel() * t.element_size()
                  if isinstance(t, torch.Tensor) else t.nbytes)
        if sizes[-1] and sizes[-1] + nbytes > max_shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    if len(shards) == 1:
        write_safetensors(
            os.path.join(out_dir, "model.safetensors"), shards[0],
            metadata={"format": "pt"})
        return
    weight_map: Dict[str, str] = {}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(os.path.join(out_dir, fname), shard,
                          metadata={"format": "pt"})
        weight_map.update({k: fname for k in shard})
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)},
                   "weight_map": weight_map}, f)


def load_config(ckpt_dir: str) -> llama.LlamaConfig:
    """Build a LlamaConfig from an HF ``config.json`` next to the
    checkpoint (hidden/heads/ffn/rope names translated)."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hc = json.load(f)
    n_heads = hc["num_attention_heads"]
    head_dim = hc.get("head_dim") or hc["hidden_size"] // n_heads
    return llama.LlamaConfig(
        vocab_size=hc["vocab_size"], hidden=hc["hidden_size"],
        n_layers=hc["num_hidden_layers"], n_heads=n_heads,
        n_kv_heads=hc.get("num_key_value_heads", n_heads),
        head_dim=head_dim, ffn=hc["intermediate_size"],
        rope_theta=float(hc.get("rope_theta", 500000.0)),
        norm_eps=float(hc.get("rms_norm_eps", 1e-5)),
        max_seq=int(hc.get("max_position_embeddings", 8192)),
        n_experts=int(hc.get("num_local_experts", 0)),
        moe_top_k=int(hc.get("num_experts_per_tok", 2)),
    )


def save_config(cfg: llama.LlamaConfig, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"]
            if not cfg.n_experts else ["MixtralForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim,
            "intermediate_size": cfg.ffn, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps,
            "max_position_embeddings": cfg.max_seq,
            "num_local_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.moe_top_k,
        }, f)
