"""LLM inference engine: continuous batching over a paged KV cache.

PyTorch counterpart of the serving core of
``ray_tpu/llm/_internal/engine.py``:

- A tick with a prefilling slot runs the unified ragged forward: every
  decoding slot contributes 1 token, prefilling slots contribute chunks
  packed under a Sarathi-style token budget, all in one flat batch.
- A pure-decode tick runs the batched decode step.
- Both write the tick's KV into one pool ``[L, num_pages, page_size,
  KVH, D]`` (last page = scratch) and sample with repetition penalty,
  temperature, top-k and top-p.
- Prefix caching shares full prompt pages between requests.
- ``kv_dtype`` "int8"/"fp8" stores the pool in one-byte values with
  float32 scale pools ``[L, num_pages, page_size, KVH]`` beside it:
  quantized at append, dequantized by the attention kernels as they read
  pages (prefix caching shares quantized pages as they are).

Readback is synchronous: each tick's tokens are folded into host state
before the next tick (the JAX engine's ``async_readback=False``
behaviour, which it documents as token-exact with its pipelined path).

Not here yet: telemetry, perf accounting, attribution, anomaly
detection, black-box dumps, KV offload and preemption, LoRA,
speculative and multi-step decode, pp/tp, the legacy two-dispatch step.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models import llama
from ...models.llama import LlamaConfig
from ...models.llama_infer import decode_step, ragged_forward
from ...models.weights import params_from_numpy
from ...ops import _kernels, kv_quant
from .kv_cache import PageAllocator


@dataclasses.dataclass
class EngineConfig:
    model: Any = "debug"                 # preset name or LlamaConfig
    max_batch_size: int = 8
    page_size: int = 16
    num_pages: int = 512
    max_seq_len: Optional[int] = None    # default: model max_seq
    seed: int = 0
    # "auto": the CUDA kernels on a CUDA device, dense gather on the
    # CPU. Also "gather" | "kernel".
    decode_impl: str = "auto"
    # chunked prefill: a prompt advances at most this many tokens a tick
    max_prefill_tokens: int = 512
    enable_prefix_caching: bool = True
    # token budget of one unified tick; 0 -> max_prefill_tokens +
    # max_batch_size (a full chunk always rides on the decode tokens)
    max_num_batched_tokens: int = 0
    # KV page storage: "f32" (pages in the model's compute dtype) |
    # "int8" | "fp8" (e4m3), with per-(token row, kv head) float32 scales
    kv_dtype: str = "f32"
    # torch device; None means "cuda" (the engine never falls back to
    # the CPU by itself — pass device="cpu" to run there)
    device: Optional[str] = None

    def resolve_model(self) -> LlamaConfig:
        return llama.config(self.model)


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0             # 0 -> greedy
    top_p: float = 1.0
    top_k: int = 0                       # 0 -> off
    repetition_penalty: float = 1.0      # 1.0 -> off (CTRL-style)
    stop_token_ids: tuple = ()
    # per-request seed; None derives one from the request id
    # (derive_seed). The noise for the token at absolute index i depends
    # only on (seed, i), whichever tick or batch produces it.
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: List[int]
    params: SamplingParams
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None


class _Slot:
    def __init__(self, index: int):
        self.index = index
        self.request: Optional[Request] = None
        self.pages: List[int] = []
        self.position = 0        # tokens cached so far
        self.last_token = 0
        self.prefill_pos = 0     # prompt tokens cached (< len => prefilling)
        self.ready = False       # prompt fully prefilled, decoding
        self.seed = 0            # resolved per-request sampling seed


def derive_seed(request_id: str) -> int:
    """Default per-request sampling seed: a stable 31-bit hash of the
    request id."""
    return int.from_bytes(
        hashlib.sha1(str(request_id).encode()).digest()[:4],
        "big") & 0x7FFFFFFF


def gumbel_rows(seeds: List[int], indices: List[int], vocab: int,
                device) -> torch.Tensor:
    """(len(seeds), vocab) float32 Gumbel noise; row r depends only on
    (seeds[r], indices[r]) — a torch.Generator seeded from the pair.
    Deterministic per request and token index like the JAX engine's
    fold_in keys, but not bit-equal to JAX's noise."""
    tiny = torch.finfo(torch.float32).tiny
    rows = []
    for s, i in zip(seeds, indices):
        g = torch.Generator(device=device)
        g.manual_seed(((int(s) & 0x7FFFFFFF) << 32) | (int(i) & 0xFFFFFFFF))
        u = torch.rand(vocab, generator=g, device=device,
                       dtype=torch.float32)
        rows.append(-torch.log(-torch.log(u.clamp(tiny, 1.0 - 1e-7))))
    return torch.stack(rows)


def _sample(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
            top_ks: Optional[torch.Tensor] = None,
            rep_pens: Optional[torch.Tensor] = None,
            seen: Optional[torch.Tensor] = None, all_greedy: bool = False,
            gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B, V) float32; temps/top_ps/top_ks/rep_pens: (B,); seen:
    (B, V) bool (the repetition-penalty support); gumbel: (B, V) noise.
    Greedy where temp <= 0.

    Order as in the JAX engine: repetition penalty on raw logits
    (positive seen logits divided, negative multiplied), temperature,
    top-k, top-p, then a categorical draw written as
    argmax(filtered + gumbel) — exactly what jax.random.categorical
    computes, so feeding JAX's own noise gives JAX's tokens."""
    if rep_pens is not None and seen is not None:
        pen = torch.where(logits > 0, logits / rep_pens[:, None],
                          logits * rep_pens[:, None])
        logits = torch.where(seen, pen, logits)
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy.to(torch.int32)
    if gumbel is None:
        raise ValueError("sampling needs gumbel noise unless all_greedy")
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    neg = torch.full_like(sorted_logits, float("-inf"))
    if top_ks is not None:
        rank = torch.arange(logits.shape[-1], device=logits.device)[None, :]
        sorted_logits = torch.where(
            (top_ks[:, None] > 0) & (rank >= top_ks[:, None]), neg,
            sorted_logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = ((cum - probs) < top_ps[:, None]) \
        & torch.isfinite(sorted_logits)            # always keeps rank 0
    keep = torch.zeros_like(keep_sorted).scatter(1, sort_idx, keep_sorted)
    filtered = torch.where(keep, scaled, torch.full_like(scaled,
                                                         float("-inf")))
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


def _resolve_device(device: Optional[str]) -> torch.device:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on CUDA by default and no CUDA device "
                "is available; pass EngineConfig(device='cpu') to run on "
                "the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class InferenceEngine:
    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, Any]] = None):
        self.config = config
        ec = config
        self.device = _resolve_device(ec.device)
        self.model_cfg = cfg = config.resolve_model()
        if cfg.n_experts:
            raise ValueError("MoE models are not served by this engine yet")
        self.kv_kind = kv_quant.validate_kind(ec.kv_dtype)
        impl = ec.decode_impl
        if impl == "auto":
            impl = "kernel" if self.device.type == "cuda" else "gather"
        if impl not in ("gather", "kernel"):
            raise ValueError(f"decode_impl must be auto|gather|kernel, got "
                             f"{ec.decode_impl!r}")
        self.impl = impl
        self.max_seq = ec.max_seq_len or cfg.max_seq
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(ec.seed)
            # draw straight into the compute dtype: never holds a float32
            # copy of the whole model
            params = llama.init_params(
                dataclasses.replace(cfg, param_dtype=cfg.dtype), gen,
                self.device)
        # numpy trees (e.g. the JAX engine's params) or tensors; tensors
        # already in the serving layout on this device are shared as-is
        self.params = params_from_numpy(params, cfg, self.device)
        self.allocator = PageAllocator(
            ec.num_pages, ec.page_size,
            enable_prefix_caching=ec.enable_prefix_caching)
        self.max_pages_per_seq = self.allocator.pages_needed(self.max_seq)
        kv_shape = (cfg.n_layers, ec.num_pages, ec.page_size,
                    cfg.n_kv_heads, cfg.head_dim)
        pool_dt = kv_quant.storage_dtype(self.kv_kind, cfg.dtype)
        self.k_pages = torch.zeros(kv_shape, dtype=pool_dt,
                                   device=self.device)
        self.v_pages = torch.zeros(kv_shape, dtype=pool_dt,
                                   device=self.device)
        # per-(token row, kv head) float32 scale pools of quantized pools
        self.k_scales = self.v_scales = None
        if kv_quant.is_quantized(self.kv_kind):
            sc_shape = kv_quant.scale_shape(kv_shape)
            self.k_scales = torch.zeros(sc_shape, dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros(sc_shape, dtype=torch.float32,
                                        device=self.device)
        # device bytes of one page at the configured kind, all layers, k
        # and v: values plus the scale pools' share
        if self.kv_kind == "f32":
            row_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                         * self.k_pages.element_size())
        else:
            row_bytes = 2 * cfg.n_layers * kv_quant.token_row_bytes(
                self.kv_kind, cfg.n_kv_heads, cfg.head_dim)
        self.kv_page_bytes = row_bytes * ec.page_size
        B = ec.max_batch_size
        self.slots = [_Slot(i) for i in range(B)]
        self.waiting: List[Request] = []
        self._page_tables = np.zeros((B, self.max_pages_per_seq), np.int32)
        self._tables_version = 0
        self._d_tables_cache = (-1, None)
        self._prefill_rr = 0
        # repetition-penalty support (B, V) on the device; slot turnover
        # dirties its row (None = full rebuild pending)
        self._d_seen: Optional[torch.Tensor] = None
        self._seen_dirty_slots: Optional[set] = None
        self._samp_cache = None
        self.ticks = 0
        self.dispatches = 0
        self.ragged_ticks = 0
        self.decode_ticks = 0

    def _kv_args(self) -> Dict[str, Any]:
        """The pools' kind and scale pools for the forwards (updated in
        place by them)."""
        return dict(kv_kind=self.kv_kind, k_scales=self.k_scales,
                    v_scales=self.v_scales)

    # -- host <-> device state ---------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _device_tables(self) -> torch.Tensor:
        """Device copy of the page tables, re-uploaded only when the
        host mirror changed (admission / retirement)."""
        ver, arr = self._d_tables_cache
        if ver != self._tables_version:
            arr = self._dev(self._page_tables)
            self._d_tables_cache = (self._tables_version, arr)
        return arr

    def _need_penalty(self) -> bool:
        return any(s.request is not None
                   and s.request.params.repetition_penalty != 1.0
                   for s in self.slots)

    def _seen_row(self, index: int) -> np.ndarray:
        """Host (V,) seen row of one slot: prompt + output when ready,
        the cached prompt prefix while prefilling, empty when free."""
        V = self.model_cfg.vocab_size
        row = np.zeros(V, bool)
        s = self.slots[index]
        if s.request is not None:
            toks = (s.request.prompt_tokens + s.request.output_tokens
                    if s.ready
                    else s.request.prompt_tokens[:s.prefill_pos])
            if toks:
                row[np.asarray(toks, np.int64) % V] = True
        return row

    def _mark_seen_dirty(self, index: int) -> None:
        if self._seen_dirty_slots is not None:
            self._seen_dirty_slots.add(index)

    def _refresh_seen(self) -> None:
        """Bring the device seen state up to date at tick entry: a full
        rebuild the first time, then only rows dirtied by slot turnover
        (skipped while no live request uses a penalty: stale rows are
        no-ops at repetition_penalty 1.0)."""
        dirty = self._seen_dirty_slots
        if self._d_seen is None or dirty is None:
            B, V = self.config.max_batch_size, self.model_cfg.vocab_size
            seen = np.zeros((B, V), bool)
            if self._need_penalty():
                for s in self.slots:
                    seen[s.index] = self._seen_row(s.index)
            self._d_seen = self._dev(seen)
            self._seen_dirty_slots = set()
            return
        self._seen_dirty_slots = set()
        if not dirty or not self._need_penalty():
            return
        idx = sorted(dirty)
        rows = np.stack([self._seen_row(i) for i in idx])
        self._d_seen[self._dev(np.asarray(idx, np.int64))] = self._dev(rows)

    def _sampling_cache(self):
        """(temps, top_ps, top_ks, rep_pens) device rows + all_greedy,
        rebuilt only on slot admission/retirement."""
        if self._samp_cache is None:
            B = self.config.max_batch_size
            samp = np.zeros((4, B), np.float32)
            samp[1] = 1.0
            samp[3] = 1.0
            for s in self.slots:
                if s.request is None:
                    continue
                p = s.request.params
                samp[0, s.index] = p.temperature
                samp[1, s.index] = p.top_p
                samp[2, s.index] = p.top_k
                samp[3, s.index] = p.repetition_penalty
            all_greedy = bool(np.all(samp[0] <= 0.0)
                              and np.all(samp[3] == 1.0))
            d = self._dev(samp)
            self._samp_cache = ((d[0], d[1], d[2].to(torch.int32), d[3]),
                                all_greedy)
        return self._samp_cache

    def _noise(self, rows: Dict[int, int]) -> torch.Tensor:
        """(B, V) Gumbel noise: row s keyed on (slot seed, rows[s]) for
        the slots sampling this tick, zeros elsewhere."""
        B, V = self.config.max_batch_size, self.model_cfg.vocab_size
        noise = torch.zeros((B, V), dtype=torch.float32, device=self.device)
        if rows:
            idx = sorted(rows)
            noise[idx] = gumbel_rows([self.slots[i].seed for i in idx],
                                     [rows[i] for i in idx], V, self.device)
        return noise

    # -- scheduling -----------------------------------------------------------
    @staticmethod
    def _token_bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _tick_token_budget(self) -> int:
        ec = self.config
        return ec.max_num_batched_tokens or (
            ec.max_prefill_tokens + ec.max_batch_size)

    def _ctx_bucket(self, start: int) -> int:
        """Smallest power-of-two page count covering `start` tokens."""
        need = self.allocator.pages_needed(start)
        b = 1
        while b < need:
            b *= 2
        return min(b, self.max_pages_per_seq) if need else 0

    def _pack_ragged(self):
        """Token-budget packing for one unified tick: every decoding slot
        contributes 1 token, then prefilling slots claim chunks
        round-robin from what is left (at least one prefill token per
        tick). Returns [(slot, n_tokens, is_prefill)]."""
        ec = self.config
        budget = self._tick_token_budget()
        plan = []
        n_decode = 0
        for s in self.slots:
            if s.request is not None and s.ready:
                plan.append((s, 1, False))
                n_decode += 1
        left = max(budget - n_decode, 1)
        B = len(self.slots)
        first_served = None
        for off in range(B):
            if left <= 0:
                break
            s = self.slots[(self._prefill_rr + off) % B]
            if s.request is None or s.ready:
                continue
            take = min(len(s.request.prompt_tokens) - s.prefill_pos,
                       left, ec.max_prefill_tokens)
            plan.append((s, take, True))
            left -= take
            if first_served is None:
                first_served = s.index
        if first_served is not None:
            self._prefill_rr = (first_served + 1) % B
        return plan

    # -- public entry points --------------------------------------------------
    def add_request(self, request: Request) -> None:
        worst_case = len(request.prompt_tokens) + request.params.max_tokens
        if worst_case > self.max_seq:
            raise ValueError(
                f"prompt+max_tokens exceeds max_seq_len {self.max_seq}")
        if self.allocator.pages_needed(worst_case) \
                > self.allocator.num_usable:
            raise ValueError(
                f"prompt+max_tokens needs "
                f"{self.allocator.pages_needed(worst_case)} KV pages but "
                f"the pool only has {self.allocator.num_usable}")
        self.waiting.append(request)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s.request is not None
                                         for s in self.slots)

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    def step(self) -> List[Request]:
        """One engine tick: admit, then one forward — the ragged forward
        when any slot is prefilling, else the decode step. Returns the
        requests that produced a token (check .finished /
        .output_tokens)."""
        touched: List[Request] = []
        self.ticks += 1
        self._admit()
        if any(s.request is not None and not s.ready for s in self.slots):
            self._ragged_step(touched)
        elif any(s.ready for s in self.slots):
            self._decode(touched)
        return touched

    def generate(self, prompts: List[List[int]],
                 params: Optional[SamplingParams] = None) -> List[Request]:
        """Synchronous batch completion."""
        params = params or SamplingParams()
        reqs = [Request(f"gen-{i}-{id(prompts)}", list(p), params)
                for i, p in enumerate(prompts)]
        for r in reqs:
            self.add_request(r)
        while not all(r.finished for r in reqs):
            self.step()
        return reqs

    def abort(self, request_id: str) -> bool:
        """Stop a request: drop it from the queue, or free its slot and
        KV pages."""
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                req.finished = True
                req.finish_reason = "abort"
                return True
        for slot in self.slots:
            if slot.request is not None \
                    and slot.request.request_id == request_id:
                self._finish(slot, "abort")
                return True
        return False

    def stats(self) -> Dict[str, Any]:
        return {
            "device": str(self.device),
            "decode_impl": self.impl,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "dispatches_per_step": (self.dispatches / self.ticks
                                    if self.ticks else 0.0),
            "ragged_ticks": self.ragged_ticks,
            "decode_ticks": self.decode_ticks,
            "active": self.num_active(),
            "waiting": len(self.waiting),
            "kv": self.allocator.stats(),
            "kv_dtype": self.kv_kind,
            "kv_page_bytes": self.kv_page_bytes,
            "kv_device_bytes_used": (self.allocator.used_pages
                                     * self.kv_page_bytes),
            "kernel_launches": _kernels.launch_counts(),
        }

    # -- internals ------------------------------------------------------------
    @staticmethod
    def _request_seed(req: Request) -> int:
        if req.params.seed is not None:
            return int(req.params.seed) & 0x7FFFFFFF
        return derive_seed(req.request_id)

    def _admit(self) -> None:
        """Claim free slots + KV pages for waiting requests, head of line
        first; the prefix-cache match decides where each prefill
        starts."""
        for slot in self.slots:
            if not self.waiting:
                break
            if slot.request is not None:
                continue
            req = self.waiting[0]
            reserve = len(req.prompt_tokens) + req.params.max_tokens
            shared, matched = self.allocator.match_prefix(req.prompt_tokens)
            need = self.allocator.pages_needed(reserve) - len(shared)
            if need > self.allocator.free_pages:
                self.allocator.free(shared)   # undo the match refs
                break                         # head-of-line admission
            self.waiting.pop(0)
            self.allocator.record_match(matched, len(req.prompt_tokens))
            slot.request = req
            slot.pages = shared + self.allocator.allocate_pages(need)
            slot.prefill_pos = matched
            slot.ready = False
            slot.position = 0
            slot.seed = self._request_seed(req)
            table = np.zeros(self.max_pages_per_seq, np.int32)
            table[:len(slot.pages)] = slot.pages
            self._page_tables[slot.index] = table
            self._tables_version += 1
            self._mark_seen_dirty(slot.index)
            self._samp_cache = None

    def _ragged_step(self, touched: List[Request]) -> None:
        """One unified tick: pack, run the ragged forward, sample, fold
        the one readback into slot state."""
        self._refresh_seen()
        plan = self._pack_ragged()
        B = self.config.max_batch_size
        total = sum(n for _, n, _ in plan)
        T = self._token_bucket(total)
        # rows: tokens / slot_ids / positions / valid
        tok_meta = np.zeros((4, T), np.int32)
        # rows: start / last_idx / emit
        slot_meta = np.zeros((3, B), np.int32)
        sample_at: Dict[int, int] = {}
        max_start = 0
        cur = 0
        for s, n, is_pref in plan:
            req = s.request
            if is_pref:
                seg = req.prompt_tokens[s.prefill_pos:s.prefill_pos + n]
                pos0 = s.prefill_pos
            else:
                seg = [s.last_token]
                pos0 = s.position
            tok_meta[0, cur:cur + n] = seg
            tok_meta[1, cur:cur + n] = s.index
            tok_meta[2, cur:cur + n] = np.arange(pos0, pos0 + n)
            tok_meta[3, cur:cur + n] = 1
            slot_meta[0, s.index] = pos0
            slot_meta[1, s.index] = cur + n - 1
            slot_meta[2, s.index] = ((not is_pref)
                                     or s.prefill_pos + n
                                     >= len(req.prompt_tokens))
            # the sample lands one past the slot's last packed token
            sample_at[s.index] = pos0 + n
            max_start = max(max_start, pos0)
            cur += n
        tm = self._dev(tok_meta)
        sm = self._dev(slot_meta)
        tokens, slot_ids, positions = tm[0], tm[1], tm[2]
        valid = tm[3] != 0
        start, last_idx, emit = sm[0], sm[1], sm[2] != 0
        ctx = self._ctx_bucket(max_start)
        # no slot segment outgrows the chunk cap
        max_seg = min(T, max(self.config.max_prefill_tokens, 1))
        self.dispatches += 1
        self.ragged_ticks += 1
        logits = ragged_forward(
            self.model_cfg, self.params, tokens, slot_ids, positions, valid,
            start, last_idx, self.k_pages, self.v_pages,
            self._device_tables(), ctx_pages=ctx, impl=self.impl,
            max_seg_len=max_seg, **self._kv_args())[0]
        (temps, top_ps, top_ks, rep_pens), all_greedy = \
            self._sampling_cache()
        if all_greedy:
            toks = _sample(logits, temps, top_ps, all_greedy=True)
        else:
            # this tick's tokens count as seen before sampling (prompt
            # tokens penalize too); only emitting slots keep their sample
            seen = self._d_seen
            # set, not |=: a padding row may repeat a real (slot, token)
            # pair, and duplicate indices in an in-place |= race
            seen[slot_ids[valid].long(), tokens[valid].long()] = True
            toks = _sample(logits, temps, top_ps, top_ks, rep_pens, seen,
                           gumbel=self._noise(sample_at))
            seen[torch.arange(B, device=self.device), toks.long()] |= emit
        toks_host = toks.cpu().numpy()
        for s, n, is_pref in plan:
            tok = int(toks_host[s.index])
            if is_pref:
                s.prefill_pos += n
                if s.prefill_pos >= len(s.request.prompt_tokens):
                    self._finish_prefill(s, tok, touched)
            else:
                s.position += 1
                s.last_token = tok
                self._append_token(s, tok, touched)

    def _decode(self, touched: List[Request]) -> None:
        """One pure-decode tick over every decoding slot."""
        self._refresh_seen()
        B = self.config.max_batch_size
        meta = np.zeros((3, B), np.int32)     # tokens / positions / active
        sample_at: Dict[int, int] = {}
        for s in self.slots:
            if s.request is None or not s.ready:
                continue
            meta[0, s.index] = s.last_token
            meta[1, s.index] = s.position
            meta[2, s.index] = 1
            sample_at[s.index] = s.position + 1
        m = self._dev(meta)
        tokens, positions, active = m[0], m[1], m[2] != 0
        self.dispatches += 1
        self.decode_ticks += 1
        logits = decode_step(
            self.model_cfg, self.params, tokens, positions, self.k_pages,
            self.v_pages, self._device_tables(), active, impl=self.impl,
            **self._kv_args())[0]
        (temps, top_ps, top_ks, rep_pens), all_greedy = \
            self._sampling_cache()
        if all_greedy:
            toks = _sample(logits, temps, top_ps, all_greedy=True)
        else:
            seen = self._d_seen
            toks = _sample(logits, temps, top_ps, top_ks, rep_pens, seen,
                           gumbel=self._noise(sample_at))
            seen[torch.arange(B, device=self.device), toks.long()] |= active
        toks_host = toks.cpu().numpy()
        for s in self.slots:
            if s.index not in sample_at or s.request is None:
                continue
            s.position += 1          # the fed token is now cached
            tok = int(toks_host[s.index])
            s.last_token = tok
            self._append_token(s, tok, touched)

    def _finish_prefill(self, slot: _Slot, first_token: int,
                        touched: List[Request]) -> None:
        req = slot.request
        n = len(req.prompt_tokens)
        self.allocator.register_prefix(
            req.prompt_tokens, slot.pages[:n // self.allocator.page_size])
        slot.prefill_pos = n
        slot.position = n
        slot.ready = True
        slot.last_token = first_token
        self._append_token(slot, first_token, touched)

    def _append_token(self, slot: _Slot, tok: int,
                      touched: List[Request]) -> None:
        req = slot.request
        req.output_tokens.append(tok)
        touched.append(req)
        p = req.params
        if tok in p.stop_token_ids:
            self._finish(slot, "stop")
        elif len(req.output_tokens) >= p.max_tokens:
            self._finish(slot, "length")

    def _finish(self, slot: _Slot, reason: str) -> None:
        slot.request.finished = True
        slot.request.finish_reason = reason
        self.allocator.free(slot.pages)
        slot.request = None
        slot.pages = []
        slot.position = 0
        slot.prefill_pos = 0
        slot.ready = False
        self._page_tables[slot.index] = 0
        self._tables_version += 1
        self._mark_seen_dirty(slot.index)
        self._samp_cache = None
