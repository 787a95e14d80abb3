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

The decode loop is device-resident, as in the JAX engine: tokens,
positions, the active mask, the sampling rows, seeds, the seen rows and
the page tables live in static device buffers, filled in place after
admission, retirement or a ragged tick; a pure-decode tick feeds its
tokens and positions back on the device and is one CUDA graph replay
(``decode_graph.py``; on the CPU, or with ``cuda_graph=False``, the same
body runs eagerly). Sampling noise is JAX's threefry noise, made on the
device (``ops/threefry.py``), so sampled streams are the JAX engine's.
With ``async_readback`` (default) a decode tick's tokens are copied to
pinned host memory without blocking and fold into slot state one tick
later; admission, prefill, retirement and abort drain the in-flight tick
first. ``_read_tokens`` is the one device-to-host sync point.

Not here yet: telemetry, perf accounting, attribution, anomaly
detection, black-box dumps, KV offload and preemption, LoRA,
speculative and multi-step decode, pp/tp, the legacy two-dispatch step,
graphs for mixed ticks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import time
from typing import Any, ContextManager, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models import llama
from ...models.llama import LlamaConfig
from ...models.llama_infer import decode_step, ragged_forward
from ...models.weights import params_from_numpy
from ...ops import _kernels, kv_quant
from ...ops.threefry import row_gumbel
from .decode_graph import DecodeGraph
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
    # Pipelined decode ticks: tick t's tokens are copied to pinned host
    # memory without blocking, and fold into slot state only once tick
    # t+1 is dispatched, so the host's fold overlaps the device's next
    # tick. Host-visible results lag one tick: a request may over-
    # generate one token, discarded at the fold (its KV write stays in
    # the slot's reserved pages). Admission, prefill, retirement and
    # abort drain the in-flight tick first. Token-exact with False.
    async_readback: bool = True
    # On a CUDA device, capture each pure-decode tick (forward, KV
    # write, sampling, feedback) once per sampling mode and replay it as
    # one CUDA graph; False runs the same body eagerly (for A/B runs
    # and debugging). A capture or replay that fails raises.
    cuda_graph: bool = True

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


@dataclasses.dataclass
class _InflightTick:
    """One dispatched decode tick whose tokens are not folded yet: the
    pinned host buffer its device-to-host copy streams into, the event
    recorded after that copy (None on the CPU, where the copy is done
    when made), and the host active mask at dispatch — the fold uses the
    snapshot, so a slot retired while the tick was in flight has its
    over-generated token discarded."""
    tokens: torch.Tensor
    done: Optional[torch.cuda.Event]
    active: np.ndarray


def derive_seed(request_id: str) -> int:
    """Default per-request sampling seed: a stable 31-bit hash of the
    request id."""
    return int.from_bytes(
        hashlib.sha1(str(request_id).encode()).digest()[:4],
        "big") & 0x7FFFFFFF


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
        self._d_tables_version = -1
        self._prefill_rr = 0
        # Static device state, filled in place (a CUDA graph reads these
        # addresses): one (8, B) int32 buffer of rows tokens / positions /
        # active / seeds / top_ks and, viewed as float32, temps / top_ps /
        # rep_pens; the page tables; the repetition-penalty support.
        dev = self.device
        self._d_state = torch.zeros((8, B), dtype=torch.int32, device=dev)
        (self._d_tokens, self._d_positions, self._d_active, self._d_seeds,
         self._d_top_ks) = self._d_state[:5]
        self._d_temps, self._d_top_ps, self._d_rep_pens = \
            self._d_state[5:].view(torch.float32)
        self._d_tables = torch.zeros((B, self.max_pages_per_seq),
                                     dtype=torch.int32, device=dev)
        self._d_seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                                   device=dev)
        self._d_rows = torch.arange(B, device=dev)
        # rows of the seen state that slot turnover dirtied (None: all)
        self._seen_dirty_slots: Optional[set] = None
        # the static state lags host slot state (admission, retirement,
        # a ragged tick): refilled before the next tick reads it
        self._state_stale = True
        self._all_greedy = True
        self._host_active = np.zeros(B, bool)
        # two pinned host buffers for token readbacks, used in turn, so
        # tick t+1's copy never lands on tick t's before its fold
        pin = dev.type == "cuda"
        self._host_tokens = [torch.empty(B, dtype=torch.int32,
                                         pin_memory=pin) for _ in range(2)]
        self._host_events = ([torch.cuda.Event() for _ in range(2)]
                             if pin else [None, None])
        self._host_turn = 0
        self._inflight: Optional[_InflightTick] = None
        # tokens folded outside step() (abort): the next step returns them
        self._pending_touched: List[Request] = []
        # one decode program per sampling mode (the JAX engine's jit
        # cache keyed on the static all_greedy)
        self._capture_graphs = dev.type == "cuda" and ec.cuda_graph
        self._graph_pool = None
        self._decode_graphs: Dict[bool, DecodeGraph] = {}
        self._guard = None          # an armed dispatch_guard, if any
        self.ticks = 0
        self.dispatches = 0
        self.ragged_ticks = 0
        self.decode_ticks = 0
        self.graph_captures = 0
        self._lagged_ticks = 0      # ticks folded one tick late
        self._drains = 0            # in-flight ticks folded early
        # (wall, host, device) ms of recent ticks; host: the folds'
        # work, device: time blocked in _read_tokens
        self._tick_times = collections.deque(maxlen=512)
        self._tick_host_s = 0.0
        self._tick_dev_s = 0.0

    def _kv_args(self) -> Dict[str, Any]:
        """The pools' kind and scale pools for the forwards (updated in
        place by them)."""
        return dict(kv_kind=self.kv_kind, k_scales=self.k_scales,
                    v_scales=self.v_scales)

    # -- host <-> device state ---------------------------------------------
    def _count_upload(self, what: str) -> None:
        if self._guard is not None:
            self._guard.upload(what)

    def _dev(self, a: np.ndarray, what: str = "tick metadata"
             ) -> torch.Tensor:
        """Upload a host array as a new device tensor (one host-to-device
        copy, reported to an armed dispatch guard)."""
        self._count_upload(what)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _fill(self, dst: torch.Tensor, a: np.ndarray, what: str) -> None:
        """Copy a host array into a static device buffer, in place."""
        self._count_upload(what)
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def _sync_allowed(self) -> ContextManager:
        """A sanctioned host sync: lifts an armed guard's sync check."""
        if self._guard is None:
            return contextlib.nullcontext()
        return self._guard.sync_allowed()

    def _start_readback(self, toks: torch.Tensor
                        ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start copying a tick's (B,) int32 tokens into the next pinned
        host buffer without blocking; returns (buffer, event after the
        copy)."""
        t = self._host_turn
        self._host_turn ^= 1
        buf, done = self._host_tokens[t], self._host_events[t]
        buf.copy_(toks, non_blocking=done is not None)
        if done is not None:
            done.record()
        return buf, done

    def _read_tokens(self, buf: torch.Tensor,
                     done: Optional[torch.cuda.Event]) -> np.ndarray:
        """THE engine's device-to-host sync point: every tick's tokens
        reach the host here (a lagged fold, a drain, a synchronous
        readback). Time blocked here is the tick's un-hidden device time
        (``device_ms`` in stats()["tick_times"])."""
        t0 = time.perf_counter()
        if done is not None:
            with self._sync_allowed():
                done.synchronize()
        out = buf.numpy().copy()
        if self._guard is not None:
            self._guard.readback()
        self._tick_dev_s += time.perf_counter() - t0
        return out

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
        """Bring the device seen state up to date: every row the first
        time, then only rows dirtied by slot turnover (skipped while no
        live request uses a penalty: stale rows are no-ops at
        repetition_penalty 1.0). Between refreshes the ticks update it on
        the device."""
        dirty = self._seen_dirty_slots
        self._seen_dirty_slots = set()
        if dirty is None:
            dirty = range(self.config.max_batch_size)
        if not dirty or not self._need_penalty():
            return
        for i in sorted(dirty):
            self._fill(self._d_seen[i], self._seen_row(i), "seen row")

    def _refresh_device_state(self) -> None:
        """Refill the static device state from host slot state, in place:
        after admission, retirement or a ragged tick (the decode loop is
        device-resident in between). Folds an in-flight tick first:
        rebuilding under it would roll device positions back under
        tokens the host never folded (its tokens reach the next step's
        return)."""
        rec = self._inflight
        if rec is not None:
            self._inflight = None
            self._drains += 1
            self._fold_inflight(rec, self._pending_touched)
        self._refresh_seen()
        if self._d_tables_version != self._tables_version:
            self._fill(self._d_tables, self._page_tables, "page tables")
            self._d_tables_version = self._tables_version
        rows = np.zeros((8, self.config.max_batch_size), np.int32)
        temps, top_ps, rep_pens = rows[5:].view(np.float32)
        top_ps[:] = 1.0
        rep_pens[:] = 1.0
        for s in self.slots:
            if s.request is None:
                continue
            p = s.request.params
            rows[3, s.index] = s.seed
            rows[4, s.index] = p.top_k
            temps[s.index] = p.temperature
            top_ps[s.index] = p.top_p
            rep_pens[s.index] = p.repetition_penalty
            if s.ready:        # prefilling slots are inactive in decode
                rows[0, s.index] = s.last_token
                rows[1, s.index] = s.position
                rows[2, s.index] = 1
        self._fill(self._d_state, rows, "slot state")
        self._all_greedy = bool(np.all(temps <= 0.0)
                                and np.all(rep_pens == 1.0))
        self._host_active = rows[2] != 0
        self._state_stale = False

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
        # an in-flight tick, or tokens folded by an out-of-step drain
        # (abort), count as work: one more step() delivers them
        return (bool(self.waiting) or bool(self._pending_touched)
                or self._inflight is not None
                or any(s.request is not None for s in self.slots))

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    def step(self) -> List[Request]:
        """One engine tick: admit, then one forward — the ragged forward
        when any slot is prefilling, else the decode step. Returns the
        requests that produced a token (check .finished /
        .output_tokens). With async_readback a decode tick's tokens
        arrive with the next step (a step may return [] while they are
        in flight); every step still dispatches once."""
        touched: List[Request] = self._pending_touched
        self._pending_touched = []
        t0 = time.perf_counter()
        self.ticks += 1
        # admission and prefill are structural: the in-flight tick folds
        # before slot state moves (a waiting queue that cannot admit
        # does not force it, or a saturated engine would run
        # synchronously)
        prefilling = any(s.request is not None and not s.ready
                         for s in self.slots)
        if prefilling or self._admit_possible():
            self._drain(touched)
        self._admit()
        if any(s.request is not None and not s.ready for s in self.slots):
            self._ragged_step(touched)
        elif any(s.ready for s in self.slots):
            self._decode(touched)
        self._tick_times.append(((time.perf_counter() - t0) * 1e3,
                                 self._tick_host_s * 1e3,
                                 self._tick_dev_s * 1e3))
        self._tick_host_s = self._tick_dev_s = 0.0
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
        KV pages (an in-flight tick is folded first; its token for this
        request is discarded, the others reach the next step's
        return)."""
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
                self._drain(self._pending_touched)
                return True
        return False

    def release_graphs(self) -> None:
        """Drop the captured decode graphs and their memory pool (the
        next decode tick captures again)."""
        self._decode_graphs.clear()
        self._graph_pool = None

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
            "async_readback": self.config.async_readback,
            "lagged_ticks": self._lagged_ticks,
            "drains": self._drains,
            "graph_captures": self.graph_captures,
            "tick_times": self._tick_times_summary(),
        }

    def _tick_times_summary(self) -> Dict[str, Any]:
        """Recent ticks (up to 512): average and p50/p95/p99 of wall,
        host (fold) and device (blocked in _read_tokens) ms, and the
        share of wall time not spent waiting on the device."""
        ticks = tuple(self._tick_times)
        n = len(ticks)
        sums = [sum(t[i] for t in ticks) for i in range(3)]
        out: Dict[str, Any] = {"window": n}
        for i, name in enumerate(("wall_ms", "host_ms", "device_ms")):
            out[f"{name}_avg"] = sums[i] / n if n else 0.0
            vals = sorted(t[i] for t in ticks)
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                out[f"{name}_{tag}"] = (
                    vals[min(int(q * (n - 1) + 0.5), n - 1)] if n else 0.0)
        out["overlap_ratio"] = (max(0.0, 1.0 - sums[2] / sums[0])
                                if sums[0] > 0 else 0.0)
        return out

    # -- internals ------------------------------------------------------------
    @staticmethod
    def _request_seed(req: Request) -> int:
        if req.params.seed is not None:
            return int(req.params.seed) & 0x7FFFFFFF
        return derive_seed(req.request_id)

    def _admit_possible(self) -> bool:
        """Could _admit place the head-of-line request this tick?
        Conservative toward True (best-case prefix sharing): a needless
        drain costs only overlap, a missed one would let the ragged pack
        read one-tick-stale slot state."""
        if not self.waiting or all(s.request is not None
                                   for s in self.slots):
            return False
        req = self.waiting[0]
        need = self.allocator.pages_needed(len(req.prompt_tokens)
                                           + req.params.max_tokens)
        if self.allocator.enable_prefix_caching:
            # every full page of prompt[:-1] cached (the match's cap)
            need -= (len(req.prompt_tokens) - 1) // self.allocator.page_size
        return need <= self.allocator.free_pages

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
            self._state_stale = True

    def _ragged_step(self, touched: List[Request]) -> None:
        """One unified tick: pack, run the ragged forward, sample, fold
        the one readback into slot state. Uploads the tick's token and
        slot metadata; the rest is the static device state."""
        if self._state_stale:
            self._refresh_device_state()
        plan = self._pack_ragged()
        B = self.config.max_batch_size
        total = sum(n for _, n, _ in plan)
        T = self._token_bucket(total)
        # rows: tokens / slot_ids / positions / valid
        tok_meta = np.zeros((4, T), np.int32)
        # rows: start / last_idx / emit / index of the sampled token
        slot_meta = np.zeros((4, B), np.int32)
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
            slot_meta[3, s.index] = pos0 + n
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
            start, last_idx, self.k_pages, self.v_pages, self._d_tables,
            ctx_pages=ctx, impl=self.impl, max_seg_len=max_seg,
            **self._kv_args())[0]
        if self._all_greedy:
            toks = _sample(logits, self._d_temps, self._d_top_ps,
                           all_greedy=True)
        else:
            # this tick's tokens count as seen before sampling (prompt
            # tokens penalize too); only emitting slots keep their sample
            seen = self._d_seen
            # set, not |=: a padding row may repeat a real (slot, token)
            # pair, and duplicate indices in an in-place |= race
            seen[slot_ids[valid].long(), tokens[valid].long()] = True
            noise = row_gumbel(self._d_seeds, sm[3],
                               self.model_cfg.vocab_size)
            toks = _sample(logits, self._d_temps, self._d_top_ps,
                           self._d_top_ks, self._d_rep_pens, seen,
                           gumbel=noise)
            seen[self._d_rows, toks.long()] |= emit
        toks_host = self._read_tokens(*self._start_readback(toks))
        t_h = time.perf_counter()
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
        self._tick_host_s += time.perf_counter() - t_h
        # the device loop state (tokens, positions) did not move with
        # the host's; the seen rows did
        self._state_stale = True

    def _decode_body(self, all_greedy: bool) -> torch.Tensor:
        """One pure-decode tick on the static device state: the forward
        and KV write, sampling, the seen update, and the feedback of
        tokens and positions for the next tick. Returns the (B,) int32
        tokens. This is what a decode graph captures."""
        active = self._d_active != 0
        logits = decode_step(
            self.model_cfg, self.params, self._d_tokens, self._d_positions,
            self.k_pages, self.v_pages, self._d_tables, active,
            impl=self.impl, **self._kv_args())[0]
        if all_greedy:
            new = _sample(logits, self._d_temps, self._d_top_ps,
                          all_greedy=True)
        else:
            # the fed token sits at `positions`; the sampled one lands at
            # positions + 1, the absolute index its noise is keyed on
            noise = row_gumbel(self._d_seeds, self._d_positions + 1,
                               self.model_cfg.vocab_size)
            new = _sample(logits, self._d_temps, self._d_top_ps,
                          self._d_top_ks, self._d_rep_pens, self._d_seen,
                          gumbel=noise)
            self._d_seen[self._d_rows, new.long()] |= active
        self._d_tokens.copy_(new)
        self._d_positions.add_(self._d_active)
        return new

    @contextlib.contextmanager
    def _capturing(self):
        self.graph_captures += 1
        if self._guard is not None:
            self._guard.capture(f"decode graph {len(self._decode_graphs)}")
        with self._sync_allowed():
            yield

    def _decode_graph(self) -> DecodeGraph:
        key = self._all_greedy
        graph = self._decode_graphs.get(key)
        if graph is None:
            if self._capture_graphs and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = DecodeGraph(
                functools.partial(self._decode_body, key),
                self._capture_graphs, self._graph_pool, self._capturing)
            self._decode_graphs[key] = graph
        return graph

    def _decode(self, touched: List[Request]) -> None:
        """One pure-decode tick over every decoding slot: one graph
        replay, then the copy of its tokens to the host; with
        async_readback the previous tick folds now and this one on the
        next step."""
        if self._state_stale:
            self._refresh_device_state()
        self.dispatches += 1
        self.decode_ticks += 1
        toks = self._decode_graph()()
        rec = _InflightTick(*self._start_readback(toks),
                            self._host_active.copy())
        if not self.config.async_readback:
            self._fold_inflight(rec, touched, lagged=False)
            return
        prev, self._inflight = self._inflight, rec
        if prev is not None and self._fold_inflight(prev, touched):
            # retirement is structural: fold the successor dispatched
            # above too (its token for the retired slot is the one-token
            # over-generation, discarded by the fold's active check)
            rec, self._inflight = self._inflight, None
            self._drains += 1
            self._fold_inflight(rec, touched, lagged=False)

    def _drain(self, touched: List[Request]) -> None:
        """Pipeline barrier: fold the in-flight tick, if any, into host
        slot state now, before a structural event (admission, prefill,
        abort) reads or moves it."""
        rec = self._inflight
        if rec is None:
            return
        self._inflight = None
        self._drains += 1
        self._fold_inflight(rec, touched)

    def _fold_inflight(self, rec: _InflightTick, touched: List[Request],
                       lagged: bool = True) -> bool:
        """Fold one decode tick's tokens into host slot state; returns
        whether a request finished. A slot retired since dispatch
        (active in the snapshot, its request gone) made the one-token
        over-generation: its token is discarded here, and its KV write
        stayed inside the slot's pages (asserted). lagged=False for a
        fold in the tick that dispatched it."""
        toks_host = self._read_tokens(rec.tokens, rec.done)
        if lagged:
            self._lagged_ticks += 1
        t_h = time.perf_counter()
        page = self.allocator.page_size
        finished = False
        for s in self.slots:
            if not rec.active[s.index] or s.request is None or not s.ready:
                continue
            s.position += 1          # the fed token is now cached
            # admission reserves prompt + max_tokens; the newest token's
            # KV is written one tick later, which leaves one reserved row
            # for the in-flight successor's write
            assert s.position + 1 <= len(s.pages) * page, (
                "decode fold past the slot's pages", s.index, s.position,
                len(s.pages), page)
            tok = int(toks_host[s.index])
            s.last_token = tok
            self._append_token(s, tok, touched)
            if s.request is None:
                finished = True
        self._tick_host_s += time.perf_counter() - t_h
        return finished

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
        self._state_stale = True
