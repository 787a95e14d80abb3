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

The KV memory hierarchy, as in the JAX engine: with
``enable_kv_offload`` a preempted decoding slot spills its pages to a
host tier (``kv_offload.py``: a gather on the device, a copy to pinned
host memory that lands one tick later) and a prefilling one requeues at
the head of the queue; parked requests restore first, token-exact, into
pages written in place (the decode graphs keep reading the same pools).
``kv_watermark_tokens`` admits a request with only prompt + watermark
tokens of pages and grows its pages as it decodes, with preemption as
the valve. Sessions and cached prefixes leave and enter an engine as
host state (``export_session``/``import_session``,
``export_prefix``/``import_prefix``), serialized by
``serve/llm/kv_transport.py`` in frames the JAX package reads too.

Observability, as in the JAX engine and with its names: request
telemetry (``telemetry.py``: SLO histograms, counters, gauges read at
scrape time, Chrome-trace lifecycles, the flight recorder), the
analytic cost model with MFU/MBU against a hardware envelope
(``perfmodel.py``; ``h100`` on the card), per-request cost receipts
(``attribution.py``), a tick-anomaly detector (``anomaly.py``),
black-box bundles (``blackbox.py``) and on-demand device profiles
(``profile_next_ticks``). All of it is host arithmetic on the host
mirrors the engine keeps: no device sync, no upload, no extra launch.
Every mutating entry point takes ``_step_lock``, since the server
calls the engine from executor threads.

Multi-LoRA serving, as in the JAX engine: ``register_lora(s)`` stacks
adapters for ``wq``/``wk``/``wv``/``wo`` in ``max_loras + 1`` slots
(slot 0 the zero adapter, names in sorted order), and a request picks
one by ``Request.lora``; every slot of one tick may run another. The
stacks are allocated at the first registration and again only when a
projection's rank changes (each releases the decode graphs and counts
one ``compiles``); other registrations write them in place. A mixed
tick carries each token's slot in its metadata, a decode tick reads a
static slot row of the device state. A request under an adapter
bypasses the prefix cache: an adapter changes every later layer's K/V,
so its pages are not the base model's (the JAX engine shares them; a
recorded departure).

Multi-step decode (``decode_steps_per_call`` K > 1): while nothing waits
or prefills, one CUDA graph runs K decode steps, each slot masked past
its remaining ``max_tokens`` (derived on the device from a static row
of the device state), and the round's (K, B) tokens come back in one
readback and fold in order. Sampled streams stay step-exact with K=1:
the noise is keyed by (seed, absolute position).

The legacy two-dispatch step (``unified_step=False``), as in the JAX
engine: a tick with a prefilling slot runs padded prefill dispatches
(``llama_infer.prefill`` for a whole prompt that fits one chunk,
``prefill_chunk`` for the next chunk of a longer one or of a prefix-cache
suffix), one slot a tick while a batch decodes, each sampling the first
token in the same dispatch, then the decode tick.

Speculative decoding (``speculative``), as in the JAX engine: a draft
model with its own pools (page ids shared with the target's) proposes
k-1 tokens a round and the target verifies them in one chunk forward;
greedy streams are the target's own. Rounds run eagerly, one readback
after the draft and one after the verify; a decode tick outside the
rounds (a sampled request in the batch) refreshes the device state
first, and a draft catch-up absorbs the tokens it produced.

Not here yet: pp/tp, graphs for mixed ticks and speculative rounds.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import tempfile
import threading
import time
from typing import Any, ContextManager, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models import llama
from ...models.llama import LlamaConfig
from ...models.llama_infer import (LORA_PROJS, decode_step, lora_cat,
                                   prefill, prefill_chunk, ragged_forward)
from ...models.weights import params_from_numpy
from ...ops import _kernels, kv_quant
from ...ops.threefry import row_gumbel
from ...util import metrics as metrics_api
from ...util import profiling
from .anomaly import AnomalyConfig, TickAnomalyDetector
from .attribution import ReceiptLedger
from .blackbox import BlackboxSpool, default_spool_dir
from .decode_graph import DecodeGraph
from .kv_cache import PageAllocator
from .kv_offload import (HostKVTier, ParkedSequence, host_array, host_dtype,
                         host_tensor, pick_victim)
from .perfmodel import CostModel, PerfAccountant, detect_envelope
from .telemetry import EngineTelemetry


@dataclasses.dataclass
class EngineConfig:
    model: Any = "debug"                 # preset name or LlamaConfig
    max_batch_size: int = 8
    page_size: int = 16
    num_pages: int = 512
    max_seq_len: Optional[int] = None    # default: model max_seq
    # padded prompt lengths of the legacy step's prefill and chunk
    # forwards (and of a speculative draft's prompt prefill)
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    seed: int = 0
    # "auto": the CUDA kernels on a CUDA device, dense gather on the
    # CPU. Also "gather" | "kernel".
    decode_impl: str = "auto"
    # chunked prefill: a prompt advances at most this many tokens a tick
    max_prefill_tokens: int = 512
    enable_prefix_caching: bool = True
    # True: a tick with a prefilling slot is one unified ragged forward.
    # False: the legacy two-dispatch step, as in the JAX engine: one
    # prefill chunk for one slot (every prefilling slot while nothing
    # decodes) through the padded `prefill`/`prefill_chunk` forwards,
    # its first token sampled in the same dispatch, then a whole-batch
    # decode tick
    unified_step: bool = True
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
    # KV memory hierarchy: under page pressure a decoding victim's pages
    # spill to a host tier and it parks until pages free up, then
    # restores token-exact; a prefilling victim requeues. Off: "out of
    # pages" just queues.
    enable_kv_offload: bool = False
    # host tier capacity in pages (None: unbounded); a full tier makes
    # preemption fail and the exhaustion path finish the victim
    host_kv_pages: Optional[int] = None
    # optimistic admission: None reserves prompt + max_tokens at
    # admission; W reserves prompt + min(max_tokens, W) and grows a
    # decoding slot's pages as it goes, preempting under pressure.
    # Requires enable_kv_offload.
    kv_watermark_tokens: Optional[int] = None
    # -- observability: the JAX engine's fields and defaults. All of it
    # is host arithmetic on host mirrors (no sync, no upload, no extra
    # launch); the off switches exist for overhead A/B runs.
    # Request-lifecycle telemetry: SLO histograms (TTFT, inter-token
    # latency, queue wait, e2e), token and finish counters, gauges set
    # at scrape time, Chrome-trace timelines, the flight recorder.
    enable_metrics: bool = True
    # Prometheus "model" and "replica" tags of this engine's samples
    # (None: "default", and no replica label)
    metrics_model_id: Optional[str] = None
    metrics_replica_id: Optional[str] = None
    # per-request SLO targets in seconds {"ttft", "queue_wait", "e2e"}
    # (None: telemetry.DEFAULT_SLO_TARGETS)
    slo_targets: Optional[Dict[str, float]] = None
    # the analytic cost model beside each dispatch: stats()["perf"]
    # reports goodput and MFU/MBU against the hardware envelope
    enable_perf_accounting: bool = True
    # a perfmodel.ENVELOPES key ("h100", "cpu", "tpu-v5e", ...); None:
    # the card's name on a CUDA device (a card outside the table
    # raises), "cpu" on the CPU
    perf_envelope: Optional[str] = None
    # per-request cost receipts; requires enable_perf_accounting
    enable_attribution: bool = True
    # tick-anomaly detector (tick wall against the roofline prediction,
    # classified flags, evidence capture); requires
    # enable_perf_accounting
    enable_anomaly_detection: bool = True
    # AnomalyConfig field overrides, e.g. {"warmup_ticks": 16}
    anomaly: Optional[Dict[str, Any]] = None
    # postmortem bundles: on a guard violation, a KV exhaustion, a
    # mid-tick crash, a flagged tick, or on demand
    enable_blackbox: bool = True
    blackbox_dir: Optional[str] = None      # None -> per-engine tempdir
    blackbox_capacity: int = 16             # bundles retained
    # Multi-LoRA capacity: adapter stacks have this many slots (plus the
    # zero adapter's), so registering adapters allocates only at the
    # first registration or when a projection's rank changes
    max_loras: int = 8
    # Multi-step decode: this many decode steps in one CUDA graph replay
    # (tokens and positions feed back on the device, each slot masked
    # past its remaining max_tokens) while nothing waits or prefills;
    # greedy, penalty and sampled streams are step-exact with 1
    decode_steps_per_call: int = 1
    # Speculative decoding: {"draft_model": preset | LlamaConfig,
    # "num_speculative_tokens": k (default 4, >= 2), "draft_params":
    # optional parameter tree (numpy, or tensors, shared when already
    # in the serving layout on this device)}. While every decoding
    # request is greedy without a penalty, a round drafts k-1 tokens
    # with the draft model (a chunk forward over the tokens it has not
    # seen, then k-2 decode steps), verifies them in one chunk forward
    # of the target and emits the accepted prefix plus the target's
    # own next token: 1 to k tokens a round, the target's greedy tokens
    # exactly. The draft shares the target's vocab; no LoRA, no KV
    # offload, no int8/fp8 pages.
    speculative: Optional[Dict[str, Any]] = None

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
    # a registered LoRA adapter's name (None: the base model)
    lora: Optional[str] = None
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    # monotonic submission stamp: the victim order's tie-break (the
    # youngest loses first)
    submitted_at: float = dataclasses.field(
        default_factory=time.monotonic)
    # trace context, carried for the wire
    trace: Optional[Dict[str, str]] = None
    # absolute monotonic deadline: past it the request finishes with
    # "deadline" at the next tick, waiting, running or parked
    deadline: Optional[float] = None
    # preemption priority: the lowest loses its slot first
    priority: int = 0
    tenant: str = ""
    # times the request lost its slot and came back (spill and restore,
    # or a prefill requeue)
    restarts: int = 0
    # scheduling lane ("interactive" | "batch"), carried for the wire
    lane: str = "interactive"


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


# product shapes this process has run (T, hidden, dtype, LoRA ranks): a
# tick at a new one is first use for the matmul library
_GEMM_SHAPES: set = set()

# same-size integer dtypes: page copies move bytes on every pool kind
# (the CPU has no index ops on float8)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_BITS[t.element_size()])


def _merge_cost(tot: Dict[str, float], c: Dict[str, float]) -> None:
    for k, v in c.items():
        tot[k] = tot.get(k, 0.0) + v


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
        if (ec.enable_kv_offload or ec.kv_watermark_tokens is not None) \
                and ec.speculative:
            raise ValueError(
                "the KV memory hierarchy (enable_kv_offload / "
                "kv_watermark_tokens) does not compose with pp>1 or "
                "speculative engines: their KV lives in stage/draft "
                "pools the host tier does not migrate")
        if self.kv_kind != "f32":
            if ec.speculative:
                raise ValueError(
                    "kv_dtype=int8/fp8 does not compose with pp>1 or "
                    "speculative engines: their stage/draft pools "
                    "have no scale plumbing")
            if not ec.unified_step:
                raise ValueError(
                    "kv_dtype=int8/fp8 requires unified_step=True: "
                    "the legacy whole-prompt prefill programs have no "
                    "quantized write path (unified engines prefill "
                    "through the ragged program, which does)")
        draft_cfg = None
        if ec.speculative:
            draft_cfg = llama.config(ec.speculative["draft_model"])
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocab")
            if draft_cfg.n_experts:
                raise ValueError("MoE draft models are not served by this "
                                 "engine yet")
            if int(ec.speculative.get("num_speculative_tokens", 4)) < 2:
                raise ValueError("num_speculative_tokens must be >= 2")
        if ec.kv_watermark_tokens is not None \
                and ec.kv_watermark_tokens < 1:
            raise ValueError("kv_watermark_tokens must be >= 1 or None")
        if ec.kv_watermark_tokens is not None \
                and not ec.enable_kv_offload:
            raise ValueError(
                "kv_watermark_tokens (optimistic admission) requires "
                "enable_kv_offload: oversubscribing device pages without "
                "the preemption valve turns ordinary contention into "
                "finish_reason=\"error\" failures that a worst-case "
                "reservation would just queue through")
        if int(ec.decode_steps_per_call) < 1:
            raise ValueError("decode_steps_per_call must be >= 1")
        if int(ec.max_loras) < 1:
            raise ValueError("max_loras must be >= 1")
        self.max_seq = ec.max_seq_len or cfg.max_seq
        # the cost model's envelope first: an unknown card raises before
        # any weights are allocated
        envelope = (detect_envelope(self.device, name=ec.perf_envelope)
                    if ec.enable_perf_accounting else None)
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
        # the KV memory hierarchy: the host tier, preemptions by reason,
        # spills whose copy to the host is still running (picked up at
        # the next tick), uploads whose host memory must outlive them
        self.host_tier: Optional[HostKVTier] = (
            HostKVTier(ec.host_kv_pages) if ec.enable_kv_offload else None)
        self.allocator.host_tier = self.host_tier
        self.preempt_counts: Dict[str, int] = {}
        self._pending_spills: List[ParkedSequence] = []
        self._upload_holds: List[Tuple[Any, List[Any]]] = []
        # the slot last allocating pages: the victim of a MemoryError
        # that escapes to step()
        self._alloc_ctx: Optional[int] = None
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
        # speculative decoding: the draft's parameters and pools (page
        # ids mirror the target's: a slot's table addresses both), the
        # canonical tokens whose KV each slot's draft holds, counters,
        # and the keys of the forwards run so far (first runs count as
        # compiles, as the reference's jit builds do)
        self._spec: Optional[Dict[str, Any]] = None
        if draft_cfg is not None:
            self._spec = self._build_draft(draft_cfg)
        self.slots = [_Slot(i) for i in range(B)]
        self.waiting: List[Request] = []
        self._page_tables = np.zeros((B, self.max_pages_per_seq), np.int32)
        self._tables_version = 0
        self._d_tables_version = -1
        self._prefill_rr = 0
        # Static device state, filled in place (a CUDA graph reads these
        # addresses): one (10, B) int32 buffer of rows tokens / positions /
        # active / seeds / top_ks, viewed as float32 temps / top_ps /
        # rep_pens, then the LoRA slot and the budget end (position +
        # remaining max_tokens: a multi-step round's budget is end -
        # positions); the page tables; the repetition-penalty support.
        dev = self.device
        self._d_state = torch.zeros((10, B), dtype=torch.int32, device=dev)
        (self._d_tokens, self._d_positions, self._d_active, self._d_seeds,
         self._d_top_ks) = self._d_state[:5]
        self._d_temps, self._d_top_ps, self._d_rep_pens = \
            self._d_state[5:8].view(torch.float32)
        self._d_lora, self._d_end = self._d_state[8:]
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
        # the legacy step's and the speculative path's forwards run
        # so far (their first run counts one compile)
        self._prefill_fns: set = set()
        self._chunk_fns: set = set()
        # pipelined readback; a speculative engine reads host state
        # between its dispatches, so it reads back synchronously
        self._async = bool(ec.async_readback) and self._spec is None
        # a multi-step round's (K, B) tokens: read back at once
        K = int(ec.decode_steps_per_call)
        self._host_round = (torch.empty((K, B), dtype=torch.int32,
                                        pin_memory=pin) if K > 1 else None)
        self._round_event = torch.cuda.Event() if pin else None
        self._inflight: Optional[_InflightTick] = None
        # tokens folded outside step() (abort): the next step returns them
        self._pending_touched: List[Request] = []
        # one decode program per (sampling mode, stacks present, steps):
        # the JAX engine's jit caches keyed on the static all_greedy
        self._capture_graphs = dev.type == "cuda" and ec.cuda_graph
        self._graph_pool = None
        self._decode_graphs: Dict[Tuple[bool, bool, int], DecodeGraph] = {}
        # multi-LoRA: adapter name -> stack slot (None -> 0), the float32
        # adapters as registered, the device stacks ({proj: {"a", "b",
        # "r"}}, llama_infer's layout) and their allocation generation;
        # the sorted names, replaced whole, for lock-free readers
        self._lora_names: Dict[Optional[str], int] = {None: 0}
        self._lora_raw: Dict[str, Dict[str, Tuple[np.ndarray, ...]]] = {}
        self._lora_stacks: Optional[Dict[str, Dict[str, Any]]] = None
        self._lora_gen = 0
        self._lora_published: Tuple[str, ...] = ()
        self._guard = None          # an armed dispatch_guard, if any
        self.ticks = 0
        self.dispatches = 0
        self.ragged_ticks = 0
        self.decode_ticks = 0
        self.graph_captures = 0
        self.multi_rounds = 0       # multi-step rounds (K steps each)
        self._lagged_ticks = 0      # ticks folded one tick late
        self._drains = 0            # in-flight ticks folded early
        # (wall, host, device) ms of recent ticks; host: the folds'
        # work, device: time blocked in _read_tokens
        self._tick_times = collections.deque(maxlen=512)
        self._tick_host_s = 0.0
        self._tick_dev_s = 0.0
        # compile events, the counterpart of the JAX engine's jit-cache
        # builds (the anomaly detector's "recompile" evidence): CUDA
        # graph captures, the first ragged tick of each (token bucket,
        # context bucket, all_greedy, LoRA stacks), kernel library
        # builds at first use in this process, LoRA stack allocations,
        # and on the card a tick that grew the caching allocator's
        # reserve (first-use work, as a cold shape's build is there)
        self.compiles = 0
        self._ragged_buckets: set = set()
        self._kernel_builds = _kernels.build_count()
        # a tick's first-use evidence for the anomaly detector's event:
        # allocator reserve and segment deltas (eager ticks on the card),
        # and whether its products ran at shapes new to this process
        self._mem_seen: Optional[Tuple[int, int]] = None
        self._tick_eager = False
        self._tick_first_use: Dict[str, Any] = {}
        # observability (the JAX engine's, see its fields above)
        self.telemetry = EngineTelemetry(
            model=ec.metrics_model_id or "default",
            enabled=bool(ec.enable_metrics),
            replica=ec.metrics_replica_id or "",
            slo_targets=ec.slo_targets)
        self.blackbox = BlackboxSpool(
            ec.blackbox_dir or default_spool_dir(
                ec.metrics_model_id or "default",
                ec.metrics_replica_id or ""),
            capacity=ec.blackbox_capacity)
        if ec.enable_blackbox:
            self.telemetry.recorder.alert_hook = self._on_alert_event
        # monotonic stamp of the last completed tick (liveness)
        self.last_step_at: Optional[float] = None
        # an armed profile: {"remaining", "dir", "cm"}
        self._profile: Optional[Dict[str, Any]] = None
        # one card: the per-chip divisor of MFU/MBU
        self.n_chips = 1
        self.perf: Optional[PerfAccountant] = None
        if envelope is not None:
            # the JAX closed form over this engine's model, with weights
            # at the dtype they are stored in: the JAX engine stores
            # them in param_dtype, this one in the compute dtype
            # (models/weights.py); where the two agree (every float32
            # config) the receipts are the JAX engine's bit for bit
            self.perf = PerfAccountant(
                CostModel(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                          ec.page_size, kv_dtype=self.kv_kind),
                envelope, n_chips=self.n_chips)
            if self._spec is not None:
                # draft dispatches are charged against the draft's own
                # closed forms (its weights at their stored dtype too)
                dc = self._spec["cfg"]
                self._spec["cost_model"] = CostModel(
                    dataclasses.replace(dc, param_dtype=dc.dtype),
                    ec.page_size)
        self.attrib: Optional[ReceiptLedger] = (
            ReceiptLedger() if (self.perf is not None
                                and ec.enable_attribution) else None)
        self.anomaly: Optional[TickAnomalyDetector] = None
        if self.perf is not None and ec.enable_anomaly_detection:
            self.anomaly = TickAnomalyDetector(
                AnomalyConfig(**(ec.anomaly or {})))
        # serializes the mutating entry points: the server steps on an
        # executor thread while aborts, imports and stats arrive from
        # others
        self._step_lock = threading.Lock()
        with self._step_lock:
            if dev.type == "cuda":
                self._note_allocator()       # the baseline
            self._publish_counters_locked()

    def _build_draft(self, draft_cfg: LlamaConfig) -> Dict[str, Any]:
        """The speculative draft: its parameters (``draft_params`` as
        given, else drawn from a generator seeded seed + 7) in the
        serving layout on this device, and its zeroed pools."""
        ec = self.config
        dparams = ec.speculative.get("draft_params")
        if dparams is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(ec.seed + 7)
            dparams = llama.init_params(
                dataclasses.replace(draft_cfg, param_dtype=draft_cfg.dtype),
                gen, self.device)
        dkv = (draft_cfg.n_layers, ec.num_pages, ec.page_size,
               draft_cfg.n_kv_heads, draft_cfg.head_dim)
        return {
            "cfg": draft_cfg,
            "k": int(ec.speculative.get("num_speculative_tokens", 4)),
            "params": params_from_numpy(dparams, draft_cfg, self.device),
            "dk": torch.zeros(dkv, dtype=draft_cfg.dtype,
                              device=self.device),
            "dv": torch.zeros(dkv, dtype=draft_cfg.dtype,
                              device=self.device),
            "draft_pos": np.zeros(ec.max_batch_size, np.int64),
            "accepted": 0, "rounds": 0, "emitted": 0,
            "draft_fns": set(), "verify_fns": set(), "prefill_fns": set(),
            "cost_model": None,
        }

    def _lora_ranks(self) -> Tuple[int, ...]:
        if self._lora_stacks is None:
            return ()
        return tuple(self._lora_stacks[p]["r"] for p in LORA_PROJS)

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
            self.telemetry.on_drain("device_state_rebuild")
            self._fold_inflight(rec, self._pending_touched)
        self.telemetry.recorder.record(
            "device_state_rebuild", active=self.num_active())
        self._refresh_seen()
        self._device_tables()
        rows = np.zeros((10, self.config.max_batch_size), np.int32)
        temps, top_ps, rep_pens = rows[5:8].view(np.float32)
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
                rows[8, s.index] = self._lora_names.get(s.request.lora, 0)
                rows[9, s.index] = s.position + (
                    p.max_tokens - len(s.request.output_tokens))
        self._fill(self._d_state, rows, "slot state")
        self._all_greedy = bool(np.all(temps <= 0.0)
                                and np.all(rep_pens == 1.0))
        self._host_active = rows[2] != 0
        self._state_stale = False

    def _device_tables(self) -> torch.Tensor:
        """The static device page tables, refilled in place when the
        host tables moved since the last fill."""
        if self._d_tables_version != self._tables_version:
            self._fill(self._d_tables, self._page_tables, "page tables")
            self._d_tables_version = self._tables_version
        return self._d_tables

    def _readback(self, t: torch.Tensor) -> np.ndarray:
        """A synchronous readback of a small device tensor (the legacy
        prefill's first token, a speculative round's candidates and
        predictions), through ``_read_tokens``."""
        pin = self.device.type == "cuda"
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        buf.copy_(t, non_blocking=pin)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record()
        return self._read_tokens(buf, done)

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
        """Queue a request for admission (which happens inside step()).
        Takes the step lock: step() rebinds the waiting list mid-tick,
        and an unlocked append could land on the discarded one."""
        with self._step_lock:
            self._add_request_locked(request)
            self._publish_counters_locked()

    def _add_request_locked(self, request: Request) -> None:
        if request.lora is not None \
                and request.lora not in self._lora_names:
            raise ValueError(
                f"unknown LoRA adapter {request.lora!r} "
                f"(registered: {sorted(self._lora_raw)})")
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
        self.telemetry.on_queued(request)
        self.waiting.append(request)

    def has_work(self) -> bool:
        # an in-flight tick, or tokens folded by an out-of-step drain
        # (abort), count as work: one more step() delivers them
        return (bool(self.waiting) or bool(self._pending_touched)
                or self._inflight is not None
                or (self.host_tier is not None and len(self.host_tier) > 0)
                or any(s.request is not None for s in self.slots))

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    def step(self) -> List[Request]:
        """One engine tick, in the JAX engine's order: pick up last
        tick's spills, expire deadlines, drain the in-flight tick if
        slot state is about to move, restore parked requests and admit,
        grow the decoding slots' pages, then one forward: the ragged
        forward when any slot is prefilling, else the decode step.
        Returns the requests that produced a token (check .finished /
        .output_tokens). With async_readback a decode tick's tokens
        arrive with the next step (a step may return [] while they are
        in flight); every step still dispatches once. A MemoryError out
        of an allocation no check covered finishes a victim with
        finish_reason "error" and the engine goes on.

        The tick's cost sample, its receipts and its anomaly check are
        committed here with the tick's wall: host time between entry
        and return, as in the JAX engine (with async_readback the
        device is still working on the tick when it returns)."""
        with self._step_lock:
            self._profile_tick_begin()
            # tokens folded outside step() (abort) ride this tick's
            # return, also on the MemoryError path
            touched: List[Request] = self._pending_touched
            self._pending_touched = []
            self.ticks += 1
            self._tick_eager = True      # until a graph replays
            self._tick_first_use = {}
            compiles0 = self.compiles
            t0 = time.perf_counter()
            try:
                self._step_tick(touched)
                wall = time.perf_counter() - t0
                self._tick_times.append((wall * 1e3,
                                         self._tick_host_s * 1e3,
                                         self._tick_dev_s * 1e3))
                self._commit_tick(wall * 1e3, compiles0)
                # reset after the append: readback and fold time of an
                # out-of-step drain lands in the next tick's record
                self._tick_host_s = self._tick_dev_s = 0.0
                self.last_step_at = time.monotonic()
            except MemoryError as exc:
                self._abort_tick()
                self._handle_memory_error(exc, touched)
                self.last_step_at = time.monotonic()
            except BaseException as exc:
                # a mid-tick raise must not leave a profile running, nor
                # a half-built cost sample pending; black-box the
                # engine's last moments (lock-free: the lock is held)
                self._abort_tick()
                self.dump_blackbox("engine_crash", error=repr(exc))
                raise
            self._publish_counters_locked()
            self._profile_tick_end()
            return touched

    def _commit_tick(self, wall_ms: float, compiles0: int) -> None:
        """Fold the tick's pending cost sample into the perf window,
        split it across the tick's receipts, and let the anomaly
        detector judge the tick's wall against its roofline."""
        builds = _kernels.build_count()
        self.compiles += builds - self._kernel_builds
        self._kernel_builds = builds
        if self._tick_eager and self.device.type == "cuda":
            grew = self._note_allocator()
            if grew and self.compiles == compiles0:
                # the caching allocator reserved new memory: first-use
                # work, counted once a tick like the reference's build
                # of a cold shape
                self.compiles += 1
                self._tick_first_use["growth_compile"] = True
        if self.perf is None:
            return
        sample = self.perf.commit(wall_ms)
        if sample is None:
            return
        host_ms, dev_ms = self._tick_host_s * 1e3, self._tick_dev_s * 1e3
        if self.attrib is not None:
            self.attrib.commit(sample, host_ms=host_ms, device_ms=dev_ms)
        if self.anomaly is not None:
            env = self.perf.envelope
            ev = self.anomaly.observe(
                sample, wall_ms, host_ms, dev_ms, self.compiles,
                env.peak_flops * self.n_chips,
                env.peak_bytes_per_s * self.n_chips)
            if ev is not None:
                self._on_tick_anomaly(ev)

    def _note_allocator(self) -> bool:
        """Read the caching allocator's reserve and segment count (host
        bookkeeping, no sync) into the tick's first-use evidence;
        whether the reserve grew since the last reading. Graph replays
        allocate nothing and skip it."""
        st = torch.cuda.memory_stats(self.device)
        cur = (int(st.get("reserved_bytes.all.current", 0)),
               int(st.get("segment.all.current", 0)))
        prev, self._mem_seen = self._mem_seen, cur
        if prev is None:
            return False
        self._tick_first_use["reserved_delta"] = cur[0] - prev[0]
        self._tick_first_use["segment_delta"] = cur[1] - prev[1]
        return cur[0] > prev[0]

    def _abort_tick(self) -> None:
        """A tick that raised: stop an armed profile and drop the
        tick's pending cost sample and charges."""
        self._profile_abort()
        if self.perf is not None:
            self.perf.abort_tick()
        if self.attrib is not None:
            self.attrib.abort_tick()

    def _step_tick(self, touched: List[Request]) -> None:
        self._finalize_spills()
        # an expired request must not take this tick's budget, nor a
        # waiting one the slot a live request could take
        self._expire_deadlines(touched)
        # admission and prefill are structural: the in-flight tick folds
        # before slot state moves (a waiting queue that cannot admit
        # does not force it, or a saturated engine would run
        # synchronously)
        if self._admit_possible() or any(
                s.request is not None and not s.ready for s in self.slots):
            self._drain(touched)
        self._admit(touched)
        # optimistic admission: extend reservations before the dispatch
        # whose KV writes would cross them
        self._grow_slots(touched)
        prefilling = any(s.request is not None and not s.ready
                         for s in self.slots)
        if self.config.unified_step:
            if prefilling:
                self._ragged_step(touched)
            elif any(s.ready for s in self.slots):
                self._decode(touched)
            return
        # the legacy step: a prefill dispatch, then a decode dispatch
        if prefilling:
            self._advance_prefill(touched)
        if any(s.ready for s in self.slots):
            self._decode(touched)

    def generate(self, prompts: List[List[int]],
                 params: Optional[SamplingParams] = None,
                 loras: Optional[List[Optional[str]]] = None
                 ) -> List[Request]:
        """Synchronous batch completion. loras: optional per-prompt
        adapter names (a multi-LoRA batch); every name is checked before
        any request queues."""
        params = params or SamplingParams()
        loras = loras or [None] * len(prompts)
        if len(loras) != len(prompts):
            raise ValueError("loras must match prompts in length")
        with self._step_lock:
            known = frozenset(self._lora_names)
            registered = sorted(self._lora_raw)
        unknown = {n for n in loras if n is not None and n not in known}
        if unknown:
            raise ValueError(
                f"unknown LoRA adapter(s) {sorted(unknown)} "
                f"(registered: {registered})")
        reqs = [Request(f"gen-{i}-{id(prompts)}", list(p), params,
                        lora=loras[i])
                for i, p in enumerate(prompts)]
        for r in reqs:
            self.add_request(r)
        while not all(r.finished for r in reqs):
            self.step()
        return reqs

    def abort(self, request_id: str) -> bool:
        """Stop a request: drop it from the queue, free its slot and KV
        pages (an in-flight tick is folded first; its token for this
        request is discarded, the others reach the next step's return),
        or drop its parked host KV. Serialized against step(): the server
        aborts from another thread while the pump steps."""
        with self._step_lock:
            hit = self._abort_locked(request_id)
            if hit:
                self._publish_counters_locked()
            return hit

    def _abort_locked(self, request_id: str) -> bool:
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                req.finished = True
                req.finish_reason = "abort"
                self.telemetry.recorder.record(
                    "abort", request_id=request_id, where="waiting")
                self.telemetry.on_finished(
                    req, "abort", cost=self._attrib_finish(req, "abort"))
                return True
        for slot in self.slots:
            if slot.request is not None \
                    and slot.request.request_id == request_id:
                self.telemetry.recorder.record(
                    "abort", request_id=request_id, where="running")
                self._finish(slot, "abort")
                self._drain(self._pending_touched)
                return True
        if self.host_tier is not None and request_id in self.host_tier:
            # parked and the client gave up: drop the host KV, never
            # restore
            parked = self.host_tier.drop(request_id)
            self._forget_spill(parked)
            req = parked.request
            req.finished = True
            req.finish_reason = "abort"
            self.telemetry.recorder.record(
                "abort", request_id=request_id, where="parked")
            self.telemetry.on_finished(
                req, "abort", cost=self._attrib_finish(req, "abort"))
            return True
        return False

    def release_graphs(self) -> None:
        """Drop the captured decode graphs and their memory pool (the
        next decode tick captures again)."""
        with self._step_lock:
            self._release_graphs_locked()

    def _release_graphs_locked(self) -> None:
        self._decode_graphs.clear()
        self._graph_pool = None

    # -- multi-LoRA -----------------------------------------------------------
    def register_lora(self, name: str, adapters: Dict[str, tuple],
                      scale: float = 1.0) -> None:
        """Register a LoRA adapter for multi-LoRA serving.

        adapters: {proj: (A, B)} for proj in wq/wk/wv/wo, A shaped
        (L, in_dim, r) and B (L, r, out_dim) (numpy, or CPU tensors); `scale`
        multiplies A. Requests select it by Request(lora=name); slots of
        one tick may run different adapters. Validation happens on a
        copy: a bad registration leaves the prior state as it was.
        Re-registration refreshes the device slot state, so requests in
        flight keep their adapter."""
        self.register_loras({name: adapters}, scale=scale)

    def register_loras(self, mapping: Dict[str, Dict[str, tuple]],
                       scale: float = 1.0) -> None:
        """Bulk form: every adapter staged, the stacks written once.
        Under the step lock: the server registers from executor threads
        while the pump steps."""
        with self._step_lock:
            self._register_loras_locked(mapping, scale)
            self._publish_counters_locked()

    def lora_adapters(self) -> List[str]:
        """Registered adapter names, sorted (lock-free: a tuple replaced
        whole at registration)."""
        return list(self._lora_published)

    def _register_loras_locked(self, mapping: Dict[str, Dict[str, tuple]],
                               scale: float) -> None:
        if self._spec is not None:
            raise NotImplementedError(
                "multi-LoRA is not supported with speculative decoding "
                "(the draft/verify programs run base weights; a greedy "
                "adapter request would silently lose its adapter)")
        valid = set(LORA_PROJS)
        new_raw = dict(self._lora_raw)
        for name, adapters in mapping.items():
            if not adapters or set(adapters) - valid:
                raise ValueError(
                    f"adapters must map a subset of {sorted(valid)}")
            new_raw[name] = {
                k: (np.asarray(a, np.float32) * scale,
                    np.asarray(b, np.float32))
                for k, (a, b) in adapters.items()}
        if len(new_raw) > self.config.max_loras:
            raise ValueError(
                f"at most max_loras={self.config.max_loras} adapters")
        names: Dict[Optional[str], int] = {None: 0}
        for i, n in enumerate(sorted(new_raw), start=1):
            names[n] = i
        # all four projections get stacks (zero rank-1 stubs where no
        # adapter uses one); the adapters of one projection share one
        # stack, so they agree on shapes
        cfg = self.model_cfg
        in_dims = {"wq": cfg.hidden, "wk": cfg.hidden, "wv": cfg.hidden,
                   "wo": cfg.q_dim}
        out_dims = {"wq": cfg.q_dim, "wk": cfg.kv_dim, "wv": cfg.kv_dim,
                    "wo": cfg.hidden}
        n_slots = self.config.max_loras + 1
        host: Dict[str, Tuple[np.ndarray, np.ndarray, int]] = {}
        for p in LORA_PROJS:
            shapes_a = {ad[p][0].shape for ad in new_raw.values()
                        if p in ad}
            shapes_b = {ad[p][1].shape for ad in new_raw.values()
                        if p in ad}
            if len(shapes_a) > 1 or len(shapes_b) > 1:
                raise ValueError(
                    f"adapters disagree on {p} shapes: "
                    f"{sorted(shapes_a)} / {sorted(shapes_b)}")
            if shapes_a:
                sa, sb = next(iter(shapes_a)), next(iter(shapes_b))
            else:
                sa = (cfg.n_layers, in_dims[p], 1)
                sb = (cfg.n_layers, 1, out_dims[p])
            r = sa[-1]
            if (len(sa) != 3 or len(sb) != 3
                    or sa[:2] != (cfg.n_layers, in_dims[p])
                    or sb != (cfg.n_layers, r, out_dims[p])):
                raise ValueError(
                    f"{p} adapter shapes {sa} / {sb} do not fit the "
                    f"model: want (L={cfg.n_layers}, {in_dims[p]}, r) / "
                    f"(L, r, {out_dims[p]})")
            a_stack = np.zeros((cfg.n_layers, n_slots) + sa[1:], np.float32)
            b_stack = np.zeros((cfg.n_layers, n_slots) + sb[1:], np.float32)
            for nm, idx in names.items():
                if nm is None or p not in new_raw[nm]:
                    continue
                a_stack[:, idx], b_stack[:, idx] = new_raw[nm][p]
            a_cat, b_cat = lora_cat(a_stack, b_stack)
            host[p] = (a_cat, b_cat, r)
        # commit only after everything validated and built; the refresh
        # below folds any tick in flight before the slot rows change
        stacks = self._lora_stacks
        if stacks is None or any(stacks[p]["r"] != host[p][2]
                                 for p in LORA_PROJS):
            # the first registration, or a projection's rank changed: new
            # stacks (new shapes and addresses) are the counterpart of the
            # reference's retrace; the decode graphs captured the old
            # ones
            dt = self.model_cfg.dtype
            self._count_upload("lora stacks")
            self._lora_stacks = {
                p: {"a": torch.from_numpy(a).to(self.device, dt),
                    "b": torch.from_numpy(b).to(self.device, dt), "r": r}
                for p, (a, b, r) in host.items()}
            self._lora_gen += 1
            self.compiles += 1
            self._release_graphs_locked()
            if self.device.type == "cuda":
                self._note_allocator()   # counted here, not at a tick
        else:
            for p, (a, b, _) in host.items():
                self._fill(stacks[p]["a"], a, "lora stacks")
                self._fill(stacks[p]["b"], b, "lora stacks")
        self._lora_raw = new_raw
        self._lora_names = names
        self._lora_published = tuple(sorted(new_raw))
        self.telemetry.recorder.record(
            "lora_registration", adapters=sorted(new_raw))
        # slots may have moved: requests in flight keep their adapter
        self._refresh_device_state()

    def _lora_stack_bytes_locked(self) -> int:
        """Device bytes of the adapter stacks (0 before a registration)."""
        if self._lora_stacks is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for st in self._lora_stacks.values()
                   for t in (st["a"], st["b"]))

    def _lane_counts_locked(self) -> Dict[str, int]:
        """Batch-lane occupancy: queued, active and parked priority-0
        bulk requests, and the device pages batch slots hold."""
        return {
            "waiting_batch": sum(1 for r in self.waiting
                                 if r.lane == "batch"),
            "active_batch": sum(1 for s in self.slots
                                if s.request is not None
                                and s.request.lane == "batch"),
            "parked_batch": sum(1 for p in self.parked
                                if p.request.lane == "batch"),
            "batch_kv_pages": sum(len(s.pages) for s in self.slots
                                  if s.request is not None
                                  and s.request.lane == "batch"),
        }

    def _publish_counters_locked(self) -> None:
        """Rebuild the published counter snapshot (the lock held): at
        the end of every mutating entry point. Replaced whole, never
        mutated, so a lock-free reader sees one consistent snapshot."""
        self._fleet_counters = {
            "active": self.num_active(),
            "waiting": len(self.waiting),
            "parked_sessions": len(self.parked),
            "preemptions_total": sum(self.preempt_counts.values()),
            "page_pressure": round(self.page_pressure(), 4),
            "lanes": self._lane_counts_locked(),
        }

    def fleet_counters(self) -> Dict[str, Any]:
        """The last published counter snapshot, read without the lock
        (a router's health poll must never wait behind a tick). Callers
        must not mutate it."""
        return self._fleet_counters

    def stats(self) -> Dict[str, Any]:
        """The engine's counters and, beside them, the observability
        blocks: "requests" (telemetry), "perf" (goodput, MFU/MBU, the
        binding roof), "attribution", "anomaly" and "blackbox". One lock
        hold over the mutable state; the blocks with locks of their own
        are read after it."""
        with self._step_lock:
            snap = self._stats_locked()
        return {
            **snap,
            "perf": (self.perf.summary() if self.perf is not None
                     else {"enabled": False}),
            "attribution": (self.attrib.summary()
                            if self.attrib is not None
                            else {"enabled": False}),
            "anomaly": (self.anomaly.stats()
                        if self.anomaly is not None
                        else {"enabled": False}),
            "requests": self.telemetry.summary(),
            "blackbox": {"enabled": bool(self.config.enable_blackbox),
                         "dir": self.blackbox.root,
                         "bundles": len(self.blackbox.list())},
        }

    def _stats_locked(self) -> Dict[str, Any]:
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
            # the KV memory hierarchy: parked requests, demand over the
            # device pool (> 1: oversubscribed), preemptions by reason,
            # host bytes pinned by parked payloads (the host tier's own
            # counters are in "kv")
            "parked_sessions": len(self.parked),
            "page_pressure": self.page_pressure(),
            "preemptions": dict(self.preempt_counts),
            "kv_host_bytes_used": (self.host_tier.used_bytes
                                   if self.host_tier is not None else 0),
            "kernel_launches": _kernels.launch_counts(),
            "async_readback": self._async,
            "lagged_ticks": self._lagged_ticks,
            "drains": self._drains,
            "graph_captures": self.graph_captures,
            "compiles": self.compiles,
            "multi_rounds": self.multi_rounds,
            "lora_adapters": sorted(self._lora_raw),
            "lora_stack_bytes": self._lora_stack_bytes_locked(),
            "chips": self.n_chips,
            "lanes": self._lane_counts_locked(),
            "tick_times": self._tick_times_summary(),
            # the forwards run so far by kind, the counterpart of the
            # reference's jit caches ("jit_cache")
            "compile_cache": {
                "ragged_buckets": len(self._ragged_buckets),
                "prefill_buckets": len(self._prefill_fns),
                "chunk_buckets": len(self._chunk_fns),
                "spec_fns": (0 if self._spec is None else sum(
                    len(self._spec[k]) for k in
                    ("draft_fns", "verify_fns", "prefill_fns"))),
                "compiled_programs": self.compiles,
            },
            **self._spec_stats(),
        }

    def _spec_stats(self) -> Dict[str, Any]:
        """The reference's speculative keys, once a round has run."""
        sp = self._spec
        if sp is None or not sp["rounds"]:
            return {}
        return {
            "spec_rounds": sp["rounds"],
            "spec_acceptance_rate": round(
                sp["accepted"] / (sp["rounds"] * (sp["k"] - 1)), 3),
            "spec_tokens_per_round": round(sp["emitted"] / sp["rounds"], 2),
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

    # -- observability --------------------------------------------------
    def profile_next_ticks(self, ticks: int = 8,
                           log_dir: Optional[str] = None) -> str:
        """Arm a device profile of the next `ticks` ticks
        (util/profiling.trace: torch.profiler, one session a tick, merged
        into one Chrome trace JSON in the returned directory). It starts
        at the next step() and ends after `ticks` ticks; one capture at
        a time (re-arming while one is pending raises)."""
        if int(ticks) < 1:
            raise ValueError("ticks must be >= 1")
        with self._step_lock:
            if self._profile is not None:
                raise RuntimeError(
                    "a profile capture is already armed/active "
                    f"({self._profile['remaining']} tick(s) left, "
                    f"dir {self._profile['dir']})")
            if log_dir is None:
                log_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_prof_")
            self._profile = {"remaining": int(ticks), "dir": log_dir,
                             "cm": None, "parts": []}
        self.telemetry.recorder.record(
            "profile_armed", ticks=int(ticks), log_dir=log_dir)
        return log_dir

    def _profile_tick_begin(self) -> None:
        """Start this tick's profile session when a capture is armed
        (tick entry, the lock held; its synchronise is sanctioned). Each
        profiled tick is its own session, started and stopped inside one
        step() call: torch.profiler must stop on the thread that started
        it, and the server steps the engine from executor threads."""
        ps = self._profile
        if ps is None:
            return
        cm = profiling.trace(ps["dir"])
        try:
            with self._sync_allowed():
                cm.__enter__()
        except Exception as e:   # profiler unavailable
            self._profile = None
            self.telemetry.recorder.record("profile_error", error=repr(e))
            return
        ps["cm"] = cm

    def _profile_session_end(self, ps: Dict[str, Any]) -> bool:
        """Stop the tick's session and keep its trace file; False (an
        error recorded, the capture disarmed) when stopping failed."""
        cm, ps["cm"] = ps["cm"], None
        try:
            with self._sync_allowed():
                cm.__exit__(None, None, None)
        except Exception as e:
            self._profile = None
            self.telemetry.recorder.record("profile_error", error=repr(e))
            return False
        ps["parts"].append(profiling.trace_files(ps["dir"])[-1])
        return True

    def _profile_tick_end(self) -> None:
        ps = self._profile
        if ps is None or ps["cm"] is None \
                or not self._profile_session_end(ps):
            return
        ps["remaining"] -= 1
        if ps["remaining"] > 0:
            return
        self._profile = None
        profiling.merge_traces(ps["parts"])
        self.telemetry.recorder.record("profile_done", log_dir=ps["dir"])

    def _profile_abort(self) -> None:
        """Stop a running capture after a mid-tick exception (keep what
        was recorded) and disarm, so the next profile_next_ticks() is
        not wedged behind a phantom capture."""
        ps = self._profile
        self._profile = None
        if ps is None or ps["cm"] is None \
                or not self._profile_session_end(ps):
            return
        profiling.merge_traces(ps["parts"])
        self.telemetry.recorder.record("profile_aborted",
                                       log_dir=ps["dir"])

    def _arm_profile_locked(self, ticks: int,
                            trigger: str = "tick_anomaly"
                            ) -> Optional[str]:
        """profile_next_ticks without the lock (the anomaly path runs
        inside step()); None instead of raising when a capture is
        already armed."""
        if self._profile is not None:
            return None
        log_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_prof_")
        self._profile = {"remaining": int(ticks), "dir": log_dir,
                         "cm": None, "parts": []}
        self.telemetry.recorder.record(
            "profile_armed", ticks=int(ticks), log_dir=log_dir,
            trigger=trigger)
        return log_dir

    def _on_tick_anomaly(self, ev: Dict[str, Any]) -> None:
        """Act on a flagged tick (the detector made every decision,
        rate limits included): a flight event with the batch
        composition, an armed profile of the next ticks, a black-box
        bundle."""
        # "kind" would collide with the recorder's event kind
        fields = {("anomaly_kind" if k == "kind" else k): v
                  for k, v in ev.items()
                  if k not in ("arm_profile", "dump")}
        # first-use evidence (allocator deltas, new product shapes)
        fields.update(self._tick_first_use)
        self.telemetry.recorder.record("tick_anomaly", **fields)
        if ev.get("arm_profile") and self.anomaly is not None:
            self._arm_profile_locked(self.anomaly.config.profile_ticks)
        if ev.get("dump"):
            self.dump_blackbox("tick_anomaly",
                               extra={"anomaly_event": ev})

    def _on_alert_event(self, kind: str, event: Dict[str, Any]) -> None:
        """FlightRecorder alert hook: a guard violation or a KV
        exhaustion black-boxes a bundle."""
        self.dump_blackbox(kind, extra={"alert_event": event})

    def dump_blackbox(self, cause: str, error: Optional[str] = None,
                      extra: Optional[Dict[str, Any]] = None
                      ) -> Optional[str]:
        """Snapshot a postmortem bundle to the spool: flight recorder,
        recent tick times, metric exposition, engine config, in-flight
        requests, slots, allocator, perf, attribution, anomaly and
        parked requests. Returns the bundle id (None when disabled or
        the write failed). Lock-free by contract: the crash path calls
        it with the step lock held."""
        if not self.config.enable_blackbox:
            return None
        try:
            ticks: List[Any] = []
            for _ in range(4):
                try:
                    ticks = list(self._tick_times)[-64:]  # racelint: disable=RL004 -- lock-free by contract: the crash path holds _step_lock; a bounded retry absorbs a concurrent append
                    break
                except RuntimeError:      # a concurrent append
                    continue
            try:
                cfg = json.loads(json.dumps(
                    dataclasses.asdict(self.config), default=repr))
            except Exception:
                cfg = {"repr": repr(self.config)}
            try:
                self.telemetry.update_gauges(self)
                exposition = metrics_api.export_prometheus()
            except Exception as e:
                exposition = f"# exposition failed: {e!r}"
            bundle = {
                "error": error,
                "engine_config": cfg,
                "counters": {
                    "ticks": self.ticks,
                    "dispatches": self.dispatches,
                    "compiled_programs": self.compiles,
                    "active": self.num_active(),
                    "waiting": len(self.waiting),
                },
                "tick_times_ms": [list(t) for t in ticks],
                "flight_recorder": self.telemetry.recorder.events(),
                "in_flight_requests": self.telemetry.live_snapshot(),
                "waiting_requests": [r.request_id for r in self.waiting],  # racelint: disable=RL004 -- lock-free by contract: reads the list reference step() publishes
                # one read of s.request a slot: a manual dump races the
                # pump's retirements
                "slots": [
                    {"index": s.index,
                     "request_id": req.request_id,
                     "position": s.position,
                     "prefill_pos": s.prefill_pos,
                     "ready": s.ready}
                    for s in self.slots
                    for req in (s.request,) if req is not None],
                "allocator": self.allocator.stats(),
                "perf": (self.perf.summary()
                         if self.perf is not None else None),
                "attribution": (self.attrib.summary(top_k=4)
                                if self.attrib is not None else None),
                "anomaly": (self.anomaly.stats()
                            if self.anomaly is not None else None),
                "parked_requests": [
                    {"request_id": p.request.request_id,
                     "position": p.position, "pages": p.n_pages,
                     "reason": p.reason,
                     "parked_s": round(p.idle_s(), 3)}
                    for p in self.parked],
                "preemptions": dict(self.preempt_counts),  # racelint: disable=RL004 -- lock-free by contract: a torn read beats a wedged crash path
                "metrics_exposition": exposition,
                **(extra or {}),
            }
            bid = self.blackbox.dump(cause, bundle)
            if bid is not None:
                self.telemetry.recorder.record(
                    "blackbox_dump", cause=cause, bundle_id=bid)
            return bid
        except Exception:
            return None      # never turn a failure into a new failure

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition of this package's registry with
        this engine's gauges refreshed (gauges are read at scrape time
        only; ticks pay nothing for them)."""
        self.telemetry.update_gauges(self)
        return metrics_api.export_prometheus()

    def attribution_summary(self, top_k: int = 8) -> Dict[str, Any]:
        """Top-K receipts by FLOPs, tenant rollups and conservation
        totals (the ledger's own lock, never the step lock)."""
        if self.attrib is None:
            return {"enabled": False}
        return self.attrib.summary(top_k=top_k)

    def chrome_trace(self) -> Dict[str, Any]:
        """Per-request lifecycle timelines as Chrome-trace JSON, merged
        with the process tracing ring and the perf counter tracks."""
        return self.telemetry.chrome_trace(perf=self.perf)

    # -- KV memory hierarchy ------------------------------------------------
    # Every method here runs at structural time (after a drain, outside
    # the steady decode path). Pages move as the JAX engine moves them
    # with jnp.take and .at[].set: a gather of page ids into fresh
    # buffers (index_select over dim 1) and a write-back into the pools
    # in place (index_copy_ into a view: never a rebind, since the decode
    # graphs captured the pools' addresses). The port does not pad page
    # ids to a power of two as the reference does for its compile cache.
    # Page ids and restored pages are uploads, reported to an armed
    # dispatch guard like any structural upload.

    @property
    def parked(self) -> List[ParkedSequence]:
        """Parked (spilled or imported) requests, in restore order."""
        return self.host_tier.entries() if self.host_tier else []

    def _reserve_tokens(self, prompt_len: int, max_tokens: int) -> int:
        """Admission reservation in tokens: prompt + max_tokens, or under
        optimistic admission prompt + min(max_tokens, watermark)."""
        wm = self.config.kv_watermark_tokens
        if wm is None:
            return prompt_len + max_tokens
        return prompt_len + min(max_tokens, wm)

    def _pools(self) -> List[torch.Tensor]:
        """The pools a page lives in: values, then scales if quantized."""
        out = [self.k_pages, self.v_pages]
        if self.k_scales is not None:
            out += [self.k_scales, self.v_scales]
        return out

    def _gather_pages(self, pages: List[int]) -> List[torch.Tensor]:
        """Copy `pages` of every pool into fresh device buffers (L, n,
        ...), enqueued on the current stream ahead of any write that
        reuses the pages."""
        ids = self._dev(np.asarray(pages, np.int64), "page ids")
        return [_bits(p).index_select(1, ids).view(p.dtype)
                for p in self._pools()]

    def _copy_to_host(self, bufs: List[torch.Tensor]
                      ) -> Tuple[List[torch.Tensor], Optional[Any]]:
        """Start copying gathered pages into pinned host memory without
        blocking, on the current stream (the gathered buffers may be
        recycled once it passes the copy); returns the host tensors and
        the event after the copies. On the CPU the gather already is the
        host copy."""
        if self.device.type != "cuda":
            return bufs, None
        hosts = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                 for b in bufs]
        for h, b in zip(hosts, bufs):
            _bits(h).copy_(_bits(b), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return hosts, done

    def _scatter_pages(self, pages: List[int], arrays: List[Any]) -> None:
        """Write host page arrays, one per pool (dim 1: pages), into
        `pages` of the pools, in place: an upload from pinned memory,
        then index_copy_. On the card the host memory is held until an
        event after the copies has passed."""
        ids = self._dev(np.asarray(pages, np.int64), "page ids")
        cuda = self.device.type == "cuda"
        held = []
        for pool, arr in zip(self._pools(), arrays):
            src = host_tensor(arr)
            self._count_upload("restored pages")
            if cuda:
                if not (src.is_contiguous() and src.is_pinned()):
                    pinned = torch.empty(src.shape, dtype=src.dtype,
                                         pin_memory=True)
                    _bits(pinned).copy_(_bits(src))
                    src = pinned
                held.append(src)
                src = src.to(self.device, non_blocking=True)
            _bits(pool).index_copy_(1, ids, _bits(src))
        if cuda:
            done = torch.cuda.Event()
            done.record()
            self._upload_holds.append((done, held))

    @staticmethod
    def _host_pages(parked: ParkedSequence) -> List[Any]:
        """A parked request's host arrays in _pools() order."""
        out = [parked.k_host, parked.v_host]
        if parked.k_scales_host is not None:
            out += [parked.k_scales_host, parked.v_scales_host]
        return out

    def _finalize_spills(self) -> None:
        """Pick up the host copies of last tick's spills (they have had
        a tick to land), and let go of restore uploads' host memory once
        their copies have passed."""
        if self._upload_holds:
            self._upload_holds = [h for h in self._upload_holds
                                  if not h[0].query()]
        if not self._pending_spills:
            return
        with self._sync_allowed():
            for parked in self._pending_spills:
                parked.materialize()
        self._pending_spills.clear()

    def _forget_spill(self, parked: Optional[ParkedSequence]) -> None:
        if parked in self._pending_spills:
            self._pending_spills.remove(parked)

    def _preempt_slot(self, victim: _Slot, reason: str) -> bool:
        """Preempt one slot (the caller has drained). A decoding victim
        spills: its cached pages gather into fresh buffers, their copy
        to the host starts, the request parks and the pages free for the
        winner. A prefilling victim requeues at the head of the queue:
        it emitted nothing, and its cached prompt pages stay in the
        prefix cache. False when the victim cannot be preempted (no host
        tier for a decoding victim, or a full one)."""
        req = victim.request
        if not victim.ready:
            self.allocator.free(victim.pages)
            self._clear_slot(victim)
            req.restarts += 1
            self.waiting.insert(0, req)
            self.preempt_counts[reason] = \
                self.preempt_counts.get(reason, 0) + 1
            self.telemetry.on_preempted(req, reason, mode="requeue")
            return True
        tier = self.host_tier
        if tier is None:
            return False
        n_pages = self.allocator.pages_needed(victim.position)
        if not tier.can_store(n_pages):
            return False
        hosts, done = self._copy_to_host(
            self._gather_pages(victim.pages[:n_pages]))
        self._note_offload(req, d2h=n_pages)
        quant = len(hosts) == 4
        parked = ParkedSequence(
            request=req, seed=victim.seed, position=victim.position,
            last_token=victim.last_token, n_pages=n_pages, reason=reason,
            k_pending=hosts[0], v_pending=hosts[1], kv_kind=self.kv_kind,
            k_scales_pending=hosts[2] if quant else None,
            v_scales_pending=hosts[3] if quant else None, done=done)
        tier.park(parked)
        self._pending_spills.append(parked)
        self.allocator.free(victim.pages)
        self._clear_slot(victim)
        self.preempt_counts[reason] = self.preempt_counts.get(reason, 0) + 1
        self.telemetry.on_preempted(req, reason, mode="spill",
                                    pages=n_pages,
                                    position=victim.position)
        return True

    def _note_offload(self, req: Optional[Request], d2h: int = 0,
                      h2d: int = 0) -> None:
        """Page traffic between the pools and the host (pages moved:
        the port pads no page ids, so exactly these) into the tick's
        cost sample and, for a request, its receipt."""
        if self.perf is None:
            return
        pb = self.perf.model.page_bytes
        self.perf.note_offload(d2h=d2h * pb, h2d=h2d * pb)
        if req is not None and self.attrib is not None:
            self.attrib.charge_offload(req, d2h=d2h * pb, h2d=h2d * pb)

    def _alloc_or_preempt(self, n: int, protect,
                          reason: str) -> Optional[List[int]]:
        """allocate_pages with preemption as the valve: while pages are
        short, preempt victims in pick_victim's order until the
        allocation fits or no victim remains (None: exhausted)."""
        if n <= 0:
            return []
        while n > self.allocator.free_pages:
            victim = (pick_victim(self.slots, protect,
                                  spill_ok=self.host_tier is not None)
                      if self.config.enable_kv_offload else None)
            if victim is None \
                    or not self._preempt_slot(victim, reason):
                return None
        return self.allocator.allocate_pages(n)

    def _grow_slots(self, touched: List[Request]) -> None:
        """Optimistic admission's page growth: a decoding slot whose next
        ticks would write past its pages grows before the dispatch: to
        its full remaining need when pages are plentiful (it grows once),
        minimally (with preemption) under pressure. A failed growth
        finishes the slot with "error"."""
        if self.config.kv_watermark_tokens is None:
            return
        page = self.allocator.page_size
        k = int(self.config.decode_steps_per_call)
        # headroom past the host position: the next dispatch writes at
        # s.position (min(k, remaining) tokens for a multi-step round),
        # the fold keeps one more row for the in-flight successor's
        # write, and with async_readback the host position lags the
        # device by the tick in flight, so growth triggers one tick
        # early or the fold's assert trips
        slack = 2 if self._async else 1

        def targets(s):
            """(minimum, full) token targets, both clamped to the
            request's final need (prompt + max_tokens, which add_request
            held to max_seq): growth never asks for a page past the
            table row, nor preempts for one never written."""
            rem = max(s.request.params.max_tokens
                      - len(s.request.output_tokens), 1)
            final = s.position + rem + 1
            return min(s.position + min(k, rem) + slack, final), final

        def short(s):
            if s.request is None or not s.ready:
                return False
            return len(s.pages) * page < targets(s)[0]

        if not any(short(s) for s in self.slots):
            return
        self._drain(touched)          # structural: tables change
        for s in self.slots:
            if not short(s):
                continue              # may have retired in the fold
            min_tokens, full_tokens = targets(s)
            full_need = self.allocator.pages_needed(full_tokens) \
                - len(s.pages)
            min_need = self.allocator.pages_needed(min_tokens) \
                - len(s.pages)
            self._alloc_ctx = s.index
            try:
                free = self.allocator.free_pages
                if free >= min_need:
                    got = self.allocator.allocate_pages(
                        max(min(full_need, free), min_need))
                else:
                    # the victim order holds across growers too: if this
                    # slot is itself the designated victim, it parks
                    # rather than preempting a higher-ranked peer
                    if self.config.enable_kv_offload and pick_victim(
                            self.slots, (),
                            spill_ok=self.host_tier is not None) is s \
                            and self._preempt_slot(s, "growth"):
                        continue
                    got = self._alloc_or_preempt(min_need, (s.index,),
                                                 "growth")
            finally:
                self._alloc_ctx = None
            if got is None:
                self._kv_exhausted(s, touched, where="growth")
                continue
            s.pages.extend(got)
            self._page_tables[s.index][:len(s.pages)] = s.pages
            self._tables_version += 1
            self._state_stale = True

    def _restore_reserve(self, parked: ParkedSequence) -> int:
        """Tokens a restore reserves: the spilled ones, the pending one,
        and the remaining output (or up to the watermark)."""
        req = parked.request
        remaining = req.params.max_tokens - len(req.output_tokens)
        wm = self.config.kv_watermark_tokens
        return parked.position + 1 + (remaining if wm is None
                                      else min(remaining, wm))

    def _restore_parked(self) -> None:
        """Re-admit parked requests in FIFO order, token-exact: full
        prompt pages still in the prefix cache are shared as they are
        (their content is the original prefill's), the rest upload from
        the host tier into fresh pages. The slot resumes the spilled
        decode state (position cached tokens, last_token pending, the
        same seed), so the next tick samples with the key a
        never-preempted engine would have used. A parked request waits
        while the waiting head outranks it."""
        tier = self.host_tier
        if tier is None or not len(tier):
            return
        for parked in tier.entries():
            slot = next((s for s in self.slots if s.request is None), None)
            if slot is None:
                break
            if self.waiting \
                    and self.waiting[0].priority > parked.request.priority:
                # continue, not break: a parked request deeper in the
                # queue that the head does not outrank still restores
                continue
            req = parked.request
            shared, _ = self.allocator.match_prefix(req.prompt_tokens,
                                                    req.lora)
            need = self.allocator.pages_needed(
                self._restore_reserve(parked)) - len(shared)
            if need > self.allocator.free_pages:
                self.allocator.free(shared)   # undo the match refs
                break        # the FIFO head waits; no preempt-to-restore
            with self._sync_allowed():
                parked.materialize()
            self._forget_spill(parked)
            tier.pop(req.request_id)
            pages = shared + self.allocator.allocate_pages(need)
            lo, hi = len(shared), parked.n_pages
            if hi > lo:
                self._scatter_pages(pages[lo:hi], [
                    a[:, lo:hi] for a in self._host_pages(parked)])
                self._note_offload(req, h2d=hi - lo)
            slot.request = req
            slot.pages = pages
            slot.prefill_pos = len(req.prompt_tokens)
            slot.position = parked.position
            slot.last_token = parked.last_token
            slot.ready = True
            slot.seed = parked.seed
            # offer the full prompt pages to the prefix cache again: an
            # imported session brings prompt KV this engine never
            # prefilled
            self.allocator.register_prefix(
                req.prompt_tokens,
                pages[:len(req.prompt_tokens) // self.allocator.page_size],
                req.lora)
            self._set_table(slot)
            req.restarts += 1
            self.telemetry.on_restored(req, pages=parked.n_pages,
                                       parked_s=parked.idle_s(),
                                       shared_pages=len(shared))

    def _restore_possible(self) -> bool:
        """_restore_parked's feasibility check for the first parked
        request the waiting head does not outrank (conservative toward
        True, like _admit_possible)."""
        tier = self.host_tier
        if tier is None or not len(tier):
            return False
        if not any(s.request is None for s in self.slots):
            return False
        head_pri = self.waiting[0].priority if self.waiting else None
        parked = next((p for p in tier.entries()
                       if head_pri is None
                       or p.request.priority >= head_pri), None)
        if parked is None:
            return False
        need = self.allocator.pages_needed(self._restore_reserve(parked))
        if self.allocator.shares(parked.request.lora):
            need -= ((len(parked.request.prompt_tokens) - 1)
                     // self.allocator.page_size)
        return need <= self.allocator.free_pages

    def _kv_exhausted(self, slot: Optional[_Slot],
                      touched: List[Request], where: str,
                      error: Optional[str] = None) -> None:
        """True page exhaustion: a flight-recorder event (alert-hooked:
        it black-boxes a bundle), and the victim finishes with "error"
        while the engine goes on serving."""
        req = slot.request if slot is not None else None
        self.telemetry.recorder.record(
            "kv_exhausted", where=where, error=error,
            request_id=req.request_id if req else None,
            free_pages=self.allocator.free_pages,
            parked=len(self.parked), waiting=len(self.waiting))
        if req is not None:
            self._finish(slot, "error")
            touched.append(req)

    def _handle_memory_error(self, exc: MemoryError,
                             touched: List[Request]) -> None:
        """A MemoryError out of an allocation that no check covered:
        finish the slot that was allocating (else the designated victim)
        with "error", and rebuild the device state over the survivors."""
        victim: Optional[_Slot] = None
        if self._alloc_ctx is not None:
            s = self.slots[self._alloc_ctx]
            if s.request is not None:
                victim = s
        self._alloc_ctx = None
        if victim is None:
            victim = pick_victim(self.slots, ())
        self._kv_exhausted(victim, touched, where="engine_boundary",
                           error=repr(exc))
        self._refresh_device_state()

    def page_pressure(self) -> float:
        """Demand on the device pool as a share of its usable pages: live
        pages plus parked pages that want back in (> 1: oversubscribed)."""
        usable = self.allocator.num_usable
        if not usable:
            return 0.0
        host = self.host_tier.used_pages if self.host_tier else 0
        return (self.allocator.used_pages + host) / usable

    def preempt(self, request_id: str, reason: str = "manual") -> bool:
        """Preempt one running request: it spills to the host tier when
        decoding, requeues when prefilling, and restores when pages
        allow. False if it is not in a slot, or cannot park (no host
        tier, or a full one, for a decoding request)."""
        with self._step_lock:
            hit = self._preempt_locked(request_id, reason)
            if hit:
                self._publish_counters_locked()
            return hit

    def _preempt_locked(self, request_id: str, reason: str) -> bool:
        for slot in self.slots:
            req = slot.request
            if req is None or req.request_id != request_id:
                continue
            if slot.ready and self.host_tier is None:
                return False
            self._drain(self._pending_touched)
            req = slot.request
            if req is None or req.request_id != request_id:
                return False          # finished in the drain's fold
            return self._preempt_slot(slot, reason)
        return False

    # -- session and prefix transport -----------------------------------
    def session_ids(self) -> List[str]:
        """Request ids resident on this engine: slots, waiting, parked."""
        with self._step_lock:
            return self._session_ids_locked()

    def _session_ids_locked(self) -> List[str]:
        out = [s.request.request_id for s in self.slots
               if s.request is not None]
        out += [r.request_id for r in self.waiting]
        out += [p.request.request_id for p in self.parked]
        return out

    def export_session(self, request_id: str, reason: str = "migration"
                       ) -> Optional[Dict[str, Any]]:
        """Detach one live request for shipping to another engine, as
        host state (serialized by serve/llm/kv_transport.py): a parked
        request leaves the host tier as it is, a decoding one spills
        first, a waiting or prefilling one leaves cold (no pages: it
        emitted nothing). None when the request is not here, finished,
        or cannot be captured (a decoding request with no host tier, or
        a full one). The request leaves with finish_reason "migrated"."""
        with self._step_lock:
            state = self._export_session_locked(request_id, reason)
            if state is not None:
                self._publish_counters_locked()
            return state

    def _export_session_locked(self, request_id: str, reason: str
                               ) -> Optional[Dict[str, Any]]:
        tier = self.host_tier
        if tier is not None and request_id in tier:
            parked = tier.export(request_id)
            self._forget_spill(parked)
            with self._sync_allowed():
                parked.materialize()
            return self._session_state(parked.request, parked, reason)
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                return self._session_state(req, None, reason)
        slot = next((s for s in self.slots if s.request is not None
                     and s.request.request_id == request_id), None)
        if slot is None:
            return None
        if slot.ready and tier is None:
            return None               # decoding KV cannot be captured
        self._drain(self._pending_touched)
        req = slot.request
        if req is None or req.request_id != request_id or req.finished:
            return None               # finished in the drain's fold
        was_ready = slot.ready
        if not self._preempt_slot(slot, reason):
            return None               # host tier full
        if not was_ready:
            # a prefilling victim requeued: take it back off the queue
            for i, r in enumerate(self.waiting):
                if r.request_id == request_id:
                    del self.waiting[i]
                    return self._session_state(r, None, reason)
            return None
        parked = tier.export(request_id)
        self._forget_spill(parked)
        with self._sync_allowed():
            parked.materialize()
        return self._session_state(parked.request, parked, reason)

    def _session_state(self, req: Request,
                       parked: Optional[ParkedSequence],
                       reason: str) -> Dict[str, Any]:
        """The exported session: the JAX engine's keys, so either package
        imports it. Marks the request finished with "migrated" and
        closes its receipt (its remaining cost accrues on the importing
        engine)."""
        req.finished = True
        req.finish_reason = "migrated"
        self._attrib_finish(req, "migrated")
        self.telemetry.recorder.record(
            "session_exported", request_id=req.request_id,
            reason=reason, pages=0 if parked is None else parked.n_pages,
            generated=len(req.output_tokens))
        ddl = None
        if req.deadline is not None:
            # a monotonic deadline does not survive a process hop: the
            # importer converts the wall instant back
            ddl = time.time() + (req.deadline - time.monotonic())
        return {
            "request_id": req.request_id,
            "prompt_tokens": list(req.prompt_tokens),
            "output_tokens": list(req.output_tokens),
            "params": dataclasses.asdict(req.params),
            "lora": req.lora,
            "priority": int(req.priority),
            "tenant": req.tenant,
            "lane": req.lane,
            "restarts": int(req.restarts),
            "trace": req.trace,
            "deadline_epoch": ddl,
            "seed": (parked.seed if parked is not None
                     else self._request_seed(req)),
            "position": 0 if parked is None else parked.position,
            "last_token": 0 if parked is None else parked.last_token,
            "n_pages": 0 if parked is None else parked.n_pages,
            "k": None if parked is None else parked.k_host,
            "v": None if parked is None else parked.v_host,
            # pages ship as stored: the importer must serve the same kind
            "kv_dtype": self.kv_kind,
            "k_scales": None if parked is None else parked.k_scales_host,
            "v_scales": None if parked is None else parked.v_scales_host,
        }

    def import_session(self, state: Dict[str, Any]) -> Request:
        """Admit a session exported by another engine (this package's or
        the JAX package's). A warm session (pages attached) parks in the
        host tier and restores at the next tick like a local spill: the
        slot resumes the shipped decode state, and since every token's
        noise is keyed on (seed, absolute index), with the exporter's
        seed pinned, the stream goes on as if it never moved. A cold one
        (nothing emitted) just queues. Returns the live Request. Raises
        ValueError on an id collision or pages this engine cannot take,
        MemoryError when the host tier cannot hold them."""
        with self._step_lock:
            req = self._import_session_locked(state)
            self._publish_counters_locked()
            return req

    def _import_session_locked(self, state: Dict[str, Any]) -> Request:
        lora = state.get("lora")
        if lora is not None and lora not in self._lora_names:
            # both paths: the reference checks only the cold one, and
            # restores a warm session onto the base weights
            raise ValueError(
                f"unknown LoRA adapter {lora!r} "
                f"(registered: {sorted(self._lora_raw)})")
        params = dict(state.get("params") or {})
        if params.get("stop_token_ids") is not None:
            params["stop_token_ids"] = tuple(params["stop_token_ids"])
        # pin the exporter's resolved seed: the noise keys must stay the
        # same under whatever request id the session runs here
        params["seed"] = int(state["seed"])
        req = Request(str(state["request_id"]),
                      [int(t) for t in state["prompt_tokens"]],
                      SamplingParams(**params),
                      lora=lora,
                      trace=state.get("trace"),
                      priority=int(state.get("priority") or 0),
                      tenant=str(state.get("tenant") or ""),
                      lane=str(state.get("lane") or "interactive"))
        req.output_tokens = [int(t) for t in state.get("output_tokens")
                             or []]
        req.restarts = int(state.get("restarts") or 0)
        if state.get("deadline_epoch") is not None:
            req.deadline = time.monotonic() + (
                float(state["deadline_epoch"]) - time.time())
        n_pages = int(state.get("n_pages") or 0)
        rid = req.request_id
        if rid in self._session_ids_locked():
            raise ValueError(f"request {rid!r} is already live on this "
                             f"engine")
        if n_pages == 0:
            if req.output_tokens:
                raise ValueError(
                    "cold session carries emitted tokens; replay it "
                    "through the continuation path instead")
            self._add_request_locked(req)
            self.telemetry.recorder.record(
                "session_imported", request_id=rid, pages=0)
            return req
        tier = self.host_tier
        if tier is None:
            raise ValueError("import_session requires enable_kv_offload "
                             "(no host tier to stage the pages in)")
        position = int(state["position"])
        if self.allocator.pages_needed(position) != n_pages:
            raise ValueError(
                f"inconsistent session: position {position} spans "
                f"{self.allocator.pages_needed(position)} pages, payload "
                f"carries {n_pages}")
        if len(req.prompt_tokens) + req.params.max_tokens > self.max_seq:
            raise ValueError(f"prompt+max_tokens exceeds max_seq_len "
                             f"{self.max_seq}")
        src_kind = str(state.get("kv_dtype") or "f32")
        if src_kind != self.kv_kind:
            # pages are never reinterpreted across storage kinds
            raise ValueError(
                f"incompatible KV dtype kind: session pages are "
                f"{src_kind!r}, this engine serves {self.kv_kind!r}")
        want = (self.k_pages.shape[0], n_pages, *self.k_pages.shape[2:])
        k, v = state.get("k"), state.get("v")
        self._check_pages((("k", k), ("v", v)), want, self.k_pages.dtype,
                          "session")
        ksc = vsc = None
        if self.k_scales is not None:
            ksc, vsc = state.get("k_scales"), state.get("v_scales")
            self._check_pages((("k_scales", ksc), ("v_scales", vsc)),
                              want[:-1], torch.float32, "quantized session")
        parked = ParkedSequence(
            request=req, seed=int(state["seed"]), position=position,
            last_token=int(state["last_token"]), n_pages=n_pages,
            reason="import", k_host=k, v_host=v, kv_kind=src_kind,
            k_scales_host=ksc, v_scales_host=vsc)
        tier.park(parked, count_spill=False)  # MemoryError when full
        self.telemetry.recorder.record(
            "session_imported", request_id=rid, pages=n_pages,
            generated=len(req.output_tokens))
        return req

    @staticmethod
    def _check_pages(named, want: Tuple[int, ...], dtype: torch.dtype,
                     what: str) -> None:
        """Shipped page arrays must have this pool's geometry and dtype."""
        for name, arr in named:
            if arr is None:
                raise ValueError(f"{what} is missing {name}")
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"incompatible KV geometry: {what} {name} is "
                    f"{tuple(arr.shape)}, this engine expects "
                    f"{tuple(want)}")
            if host_dtype(arr) != dtype:
                raise ValueError(
                    f"incompatible KV dtype: {what} {name} is "
                    f"{arr.dtype}, the pool is {dtype}")

    def export_prefix(self, prompt_tokens: List[int]
                      ) -> Optional[Dict[str, Any]]:
        """The cached full prompt pages of this token chain, gathered to
        host arrays ({tokens, k, v, kv_dtype}, and the scales of
        quantized pages). None when nothing is cached."""
        with self._step_lock:
            return self._export_prefix_locked(prompt_tokens)

    def _export_prefix_locked(self, prompt_tokens: List[int]
                              ) -> Optional[Dict[str, Any]]:
        if not self.allocator.enable_prefix_caching:
            return None
        pages = self.allocator.cached_prefix_pages(prompt_tokens)
        if not pages:
            return None
        self._drain(self._pending_touched)
        bufs = self._gather_pages(pages)
        # prefix traffic is the fleet's, not a request's: the tick's
        # totals only
        self._note_offload(None, d2h=len(pages))
        with self._sync_allowed():
            hosts = [host_array(b.cpu()) for b in bufs]
        out = {"k": hosts[0], "v": hosts[1]}
        if len(hosts) == 4:
            out["k_scales"], out["v_scales"] = hosts[2], hosts[3]
        out["tokens"] = [int(t) for t in
                         prompt_tokens[:len(pages) * self.allocator.page_size]]
        out["kv_dtype"] = self.kv_kind
        self.telemetry.recorder.record(
            "prefix_exported", pages=len(pages), tokens=len(out["tokens"]))
        return out

    def import_prefix(self, tokens: List[int], k_host, v_host,
                      k_scales=None, v_scales=None,
                      kv_dtype: str = "f32") -> int:
        """Seed the prefix cache with pages prefilled elsewhere: the
        missing tail of the chain uploads into fresh pages and registers
        under the keys a local prefill would have used, so the next
        admission of the prompt matches it. Returns the pages newly
        seeded (0: already cached, no room, or nothing to import)."""
        with self._step_lock:
            return self._import_prefix_locked(tokens, k_host, v_host,
                                              k_scales, v_scales, kv_dtype)

    def _import_prefix_locked(self, tokens, k_host, v_host, k_scales,
                              v_scales, kv_dtype) -> int:
        if not self.allocator.enable_prefix_caching:
            return 0
        if str(kv_dtype or "f32") != self.kv_kind:
            raise ValueError(
                f"incompatible prefix KV dtype kind: pages are "
                f"{kv_dtype!r}, this engine serves {self.kv_kind!r}")
        page = self.allocator.page_size
        n = min(len(tokens) // page, int(k_host.shape[1]))
        if n == 0:
            return 0
        want = (self.k_pages.shape[0], int(k_host.shape[1]),
                *self.k_pages.shape[2:])
        self._check_pages((("k", k_host), ("v", v_host)), want,
                          self.k_pages.dtype, "prefix")
        arrays = [k_host, v_host]
        if self.k_scales is not None:
            self._check_pages((("k_scales", k_scales),
                               ("v_scales", v_scales)), want[:-1],
                              torch.float32, "quantized prefix")
            arrays += [k_scales, v_scales]
        toks = [int(t) for t in tokens[:n * page]]
        have = self.allocator.cached_prefix_pages(toks)
        if len(have) >= n:
            return 0                  # fully cached already
        need = n - len(have)
        if need > self.allocator.free_pages:
            return 0                  # never evict live work for this
        self._drain(self._pending_touched)
        fresh = self.allocator.allocate_pages(need)
        self._scatter_pages(fresh, [a[:, len(have):n] for a in arrays])
        self._note_offload(None, h2d=need)
        self.allocator.register_prefix(toks, have + fresh)
        # registration took the cache's reference on the fresh pages:
        # release the allocation's, so they are cache-owned (evictable
        # under pressure, like a local prefill's)
        self.allocator.free(fresh)
        self.telemetry.recorder.record(
            "prefix_imported", pages=need, cached=len(have),
            tokens=len(toks))
        return need

    # -- internals ------------------------------------------------------------
    @staticmethod
    def _request_seed(req: Request) -> int:
        if req.params.seed is not None:
            return int(req.params.seed) & 0x7FFFFFFF
        return derive_seed(req.request_id)

    def _admit_possible(self) -> bool:
        """Could _admit restore or place anyone this tick? Conservative
        toward True (best-case prefix sharing): a needless drain costs
        only overlap, a missed one would let the ragged pack read
        one-tick-stale slot state."""
        if self.host_tier is not None and len(self.host_tier):
            top = max(p.request.priority for p in self.host_tier.entries())
            if not (self.waiting and self.waiting[0].priority > top):
                # parked requests restore before (and instead of) new
                # admissions
                return self._restore_possible()
            # a head that outranks every parked request admits past
            # them: a drain is due only when it can move (a free slot
            # its pages fit, or a victim it outranks)
            if any(s.request is None for s in self.slots) \
                    and self._head_fits():
                return True
            return self._priority_victim_exists()
        if not self.waiting:
            return False
        if not any(s.request is None for s in self.slots):
            return self._priority_victim_exists()
        return self._head_fits() or self._priority_victim_exists()

    def _head_fits(self) -> bool:
        """Could the waiting head's reservation be claimed now, with
        best-case prefix sharing (every full page of prompt[:-1], the
        match's cap, cached)?"""
        req = self.waiting[0]
        need = self.allocator.pages_needed(self._reserve_tokens(
            len(req.prompt_tokens), req.params.max_tokens))
        if self.allocator.shares(req.lora):
            need -= (len(req.prompt_tokens) - 1) // self.allocator.page_size
        return need <= self.allocator.free_pages

    def _priority_victim_exists(self) -> bool:
        """Does the waiting head strictly outrank the designated victim
        (the slot _preempt_for_priority would take), and can that victim
        be preempted now (a requeue needs nothing, a spill needs room in
        the host tier)?"""
        if not self.config.enable_kv_offload or not self.waiting:
            return False
        victim = pick_victim(self.slots, (),
                             spill_ok=self.host_tier is not None)
        if victim is None or victim.request.priority \
                >= self.waiting[0].priority:
            return False
        if not victim.ready:
            return True
        return (self.host_tier is not None
                and self.host_tier.can_store(
                    self.allocator.pages_needed(victim.position)))

    def _preempt_for_priority(self, touched: List[Request]) -> None:
        """While the waiting head strictly outranks the designated
        victim (pick_victim's order) and cannot be admitted as things
        stand, preempt that victim: a request must not queue behind the
        lower-priority work it exists to displace. Equal priorities
        never preempt. Bounded by the slot count."""
        if not self.config.enable_kv_offload or not self.waiting:
            return
        for _ in range(len(self.slots)):
            if not self.waiting:
                return
            # re-read the head each round: a requeued victim or a fold
            # can change it
            head = self.waiting[0]
            if any(s.request is None for s in self.slots) \
                    and self._head_fits():
                return
            victim = pick_victim(self.slots, (),
                                 spill_ok=self.host_tier is not None)
            if victim is None or victim.request.priority >= head.priority:
                return
            self._drain(touched)       # preemption is structural
            if victim.request is None:
                continue               # retired in the drain's fold
            if victim.request.priority >= head.priority:
                return
            vreq = victim.request
            if not self._preempt_slot(victim, "priority"):
                return                 # host tier full: the head waits
            # a requeued prefilling victim lands at waiting[0]; it was
            # preempted by the head, so move it behind every waiter that
            # outranks it (ahead of its own tier), or it would take the
            # slot back
            if self.waiting and self.waiting[0] is vreq:
                self.waiting.pop(0)
                i = 0
                while i < len(self.waiting) \
                        and self.waiting[i].priority > vreq.priority:
                    i += 1
                self.waiting.insert(i, vreq)

    def _admit(self, touched: List[Request]) -> None:
        """Restore parked requests first, then claim free slots and KV
        pages for waiting requests, head of line first; the prefix-cache
        match decides where each prefill starts. While any request is
        parked, new admissions wait (it holds host memory and came
        first), except a head that outranks every parked request."""
        self._restore_parked()
        if self.host_tier is not None and len(self.host_tier):
            top = max(p.request.priority for p in self.host_tier.entries())
            if not (self.waiting and self.waiting[0].priority > top):
                return
        self._preempt_for_priority(touched)
        parked_top: Optional[int] = (
            max(p.request.priority for p in self.host_tier.entries())
            if self.host_tier is not None and len(self.host_tier)
            else None)
        for slot in self.slots:
            if not self.waiting:
                break
            if slot.request is not None:
                continue
            req = self.waiting[0]
            if parked_top is not None and req.priority <= parked_top:
                # the exception holds per head: parked-first resumes once
                # the head no longer outranks every parked request
                break
            reserve = self._reserve_tokens(len(req.prompt_tokens),
                                           req.params.max_tokens)
            shared, matched = self.allocator.match_prefix(req.prompt_tokens,
                                                          req.lora)
            need = self.allocator.pages_needed(reserve) - len(shared)
            if need > self.allocator.free_pages:
                self.allocator.free(shared)   # undo the match refs
                break                         # head-of-line admission
            self.waiting.pop(0)
            if req.restarts == 0:
                # a requeued victim counts once; a request that bypasses
                # the cache made no lookup
                if self.allocator.shares(req.lora):
                    self.allocator.record_match(matched,
                                                len(req.prompt_tokens))
                self.telemetry.on_admitted(req, cached_tokens=matched)
                if self.attrib is not None:
                    self.attrib.note_queue(
                        req, time.monotonic() - req.submitted_at)
            else:
                self.telemetry.recorder.record(
                    "readmission", request_id=req.request_id,
                    restarts=req.restarts, cached_tokens=matched)
            slot.request = req
            self._alloc_ctx = slot.index
            try:
                slot.pages = shared + self.allocator.allocate_pages(need)
            finally:
                self._alloc_ctx = None
            slot.prefill_pos = matched
            slot.ready = False
            slot.position = 0
            slot.seed = self._request_seed(req)
            self._set_table(slot)

    def _set_table(self, slot: _Slot) -> None:
        """Write a slot's page table row (host), and mark the device
        state for a refill."""
        table = np.zeros(self.max_pages_per_seq, np.int32)
        table[:len(slot.pages)] = slot.pages
        self._page_tables[slot.index] = table
        self._tables_version += 1
        self._mark_seen_dirty(slot.index)
        self._state_stale = True

    def _expire_deadlines(self, touched: List[Request]) -> None:
        """Requests past their deadline finish with "deadline" at tick
        entry: parked ones drop their host KV, running ones retire as an
        abort does (after a drain), waiting ones leave the queue."""
        has_slot = any(s.request is not None
                       and s.request.deadline is not None
                       for s in self.slots)
        has_wait = any(r.deadline is not None for r in self.waiting)
        has_park = (self.host_tier is not None and len(self.host_tier) > 0
                    and any(p.request.deadline is not None
                            for p in self.parked))
        if not (has_slot or has_wait or has_park):
            return
        now = time.monotonic()
        if has_park:
            for parked in self.parked:
                req = parked.request
                if req.deadline is None or now < req.deadline:
                    continue
                self.host_tier.drop(req.request_id)
                self._forget_spill(parked)
                req.finished = True
                req.finish_reason = "deadline"
                self.telemetry.recorder.record(
                    "deadline_abort", request_id=req.request_id,
                    where="parked", generated=len(req.output_tokens))
                self.telemetry.on_finished(
                    req, "deadline",
                    cost=self._attrib_finish(req, "deadline"))
                touched.append(req)
        if has_slot:
            expired = [s for s in self.slots
                       if s.request is not None
                       and s.request.deadline is not None
                       and now >= s.request.deadline]
            if expired:
                self._drain(touched)
                for s in expired:
                    req = s.request
                    if req is None or req.finished:
                        continue       # finished in the drain's fold
                    self.telemetry.recorder.record(
                        "deadline_abort", request_id=req.request_id,
                        where="running", generated=len(req.output_tokens))
                    self._finish(s, "deadline")
                    touched.append(req)
        if has_wait:
            keep: List[Request] = []
            for req in self.waiting:
                if req.deadline is not None and now >= req.deadline:
                    req.finished = True
                    req.finish_reason = "deadline"
                    self.telemetry.recorder.record(
                        "deadline_abort", request_id=req.request_id,
                        where="waiting")
                    self.telemetry.on_finished(
                        req, "deadline",
                        cost=self._attrib_finish(req, "deadline"))
                    touched.append(req)
                else:
                    keep.append(req)
            self.waiting = keep

    # -- per-dispatch cost accounting -----------------------------------
    # Beside each dispatch, on the host: the JAX engine's closed forms
    # over the batch the engine just packed fold into the tick's pending
    # sample and the requests' receipts. Plain int arithmetic on host
    # slot state: no upload, no sync, no launch.
    def _account_ragged(self, plan) -> None:
        """One unified tick: each decoding slot advances one token at
        its context, each prefill chunk runs against its cached start."""
        if self.perf is None:
            return
        cm = self.perf.model
        tot: Dict[str, float] = {}
        ndec = npre = 0
        for s, n, is_pref in plan:
            if is_pref:
                c = cm.chunk_cost(s.prefill_pos, n)
                npre += n
            else:
                c = cm.decode_cost(s.position + 1)
                ndec += 1
            _merge_cost(tot, c)
            if self.attrib is not None:
                # the same closed-form dict on both sides: the receipts
                # sum to the tick total exactly
                self.attrib.charge(s.request, c,
                                   decode_tokens=0 if is_pref else 1,
                                   prefill_tokens=n if is_pref else 0,
                                   pages=len(s.pages))
        self.perf.add("ragged", tot, decode_tokens=ndec,
                      prefill_tokens=npre)

    def _account_decode_batch(self, kind: str = "decode") -> None:
        """One whole-batch decode dispatch: every active slot advances
        one token at its host position (with async_readback one tick
        behind the device, as in the JAX engine)."""
        if self.perf is None:
            return
        cm = self.perf.model
        tot: Dict[str, float] = {}
        ndec = 0
        for s in self.slots:
            if s.request is None or not s.ready \
                    or not self._host_active[s.index]:
                continue
            c = cm.decode_cost(s.position + 1)
            _merge_cost(tot, c)
            if self.attrib is not None:
                self.attrib.charge(s.request, c, decode_tokens=1,
                                   pages=len(s.pages))
            ndec += 1
        if ndec:
            self.perf.add(kind, tot, decode_tokens=ndec)

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
        # rows: tokens / slot_ids / positions / valid / LoRA slot
        tok_meta = np.zeros((5, T), np.int32)
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
            tok_meta[4, cur:cur + n] = self._lora_names.get(req.lora, 0)
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
        bucket = (T, ctx, self._all_greedy, self._lora_gen)
        if bucket not in self._ragged_buckets:
            # the JAX engine builds one program per bucket; here the
            # first tick of a bucket sets up the kernel's launch
            # attributes and plans
            self._ragged_buckets.add(bucket)
            self.compiles += 1
        # the tick's products run at (T, widths, the stacks' ranks):
        # whether this process has run them before (first-use evidence)
        gemm = (T, self.model_cfg.hidden, str(self.model_cfg.dtype),
                self._lora_ranks())
        self._tick_first_use["new_gemm_shapes"] = gemm not in _GEMM_SHAPES
        _GEMM_SHAPES.add(gemm)
        # no slot segment outgrows the chunk cap
        max_seg = min(T, max(self.config.max_prefill_tokens, 1))
        self.dispatches += 1
        self.ragged_ticks += 1
        logits = ragged_forward(
            self.model_cfg, self.params, tokens, slot_ids, positions, valid,
            start, last_idx, self.k_pages, self.v_pages, self._d_tables,
            ctx_pages=ctx, impl=self.impl, max_seg_len=max_seg,
            lora=self._lora_stacks,
            lora_idx=tm[4] if self._lora_stacks is not None else None,
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
        readback = self._start_readback(toks)
        # the tick's budget use and cost, from the host slot state the
        # fold below moves: under the device's work, not ahead of it
        self.telemetry.on_tick_budget(total, self._tick_token_budget())
        self._account_ragged(plan)
        toks_host = self._read_tokens(*readback)
        t_h = time.perf_counter()
        for s, n, is_pref in plan:
            tok = int(toks_host[s.index])
            if is_pref:
                self.telemetry.on_prefill_chunk(s.request, n,
                                                s.prefill_pos)
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

    # -- the legacy two-dispatch step ----------------------------------------
    # unified_step=False, as in the JAX engine: a tick with a prefilling
    # slot first runs padded prefill dispatches, each for one slot (the
    # whole prompt through `prefill` when it starts at 0 and fits one
    # chunk, else its next chunk through `prefill_chunk`) with the first
    # token sampled in the same dispatch, then the whole-batch decode
    # tick (`_decode`, shared with the unified step).
    def _bucket_for(self, n: int) -> int:
        """The padded length of an n-token prefill: the smallest
        prefill bucket that holds it (and max_seq past the largest)."""
        for b in self.config.prefill_buckets:
            if n <= b and b <= self.max_seq:
                return b
        return self.max_seq

    def _prep_full_prompt(self, req: Request) -> Tuple[np.ndarray, int]:
        """(1, bucket) padded tokens of a whole prompt, and the bucket."""
        n = len(req.prompt_tokens)
        bucket = self._bucket_for(n)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = req.prompt_tokens
        return tokens, bucket

    def _prep_chunk(self, slot: _Slot, req: Request
                    ) -> Tuple[np.ndarray, int, int]:
        """(1, bucket) padded tokens of a slot's next prompt chunk (at
        most max_prefill_tokens), its length and the bucket."""
        n = len(req.prompt_tokens)
        chunk = min(self.config.max_prefill_tokens, n - slot.prefill_pos)
        bucket = self._bucket_for(chunk)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :chunk] = req.prompt_tokens[
            slot.prefill_pos:slot.prefill_pos + chunk]
        return tokens, chunk, bucket

    def _account_prefill(self, slot: _Slot, start: int, n: int) -> None:
        """One slot's prefill dispatch (whole prompt or chunk) into the
        tick sample and the slot's receipt."""
        if self.perf is None:
            return
        c = self.perf.model.chunk_cost(start, n)
        self.perf.add("prefill", c, prefill_tokens=n)
        if self.attrib is not None:
            self.attrib.charge(slot.request, c, prefill_tokens=n,
                               pages=len(slot.pages))

    def _first_use(self, cache: set, key) -> None:
        """Count a forward's first run at `key` as one compile (the
        reference builds one program per key)."""
        if key not in cache:
            cache.add(key)
            self.compiles += 1

    def _advance_prefill(self, touched: List[Request]) -> None:
        """Advance prefilling slots: one chunk a tick while a batch
        decodes (its decode ticks keep flowing), every prefilling slot
        while nothing decodes. The reference's round-robin, which reads
        the cursor it moves (so a slot can take two chunks in one tick
        while another waits): the dispatch counts stay its own."""
        decoding = any(s.ready for s in self.slots)
        B = len(self.slots)
        for off in range(B):
            slot = self.slots[(self._prefill_rr + off) % B]
            if slot.request is not None and not slot.ready:
                self._prefill_rr = (slot.index + 1) % B
                self._prefill_one_chunk(slot, touched)
                if decoding:
                    return

    def _prefill_one_chunk(self, slot: _Slot,
                           touched: List[Request]) -> None:
        """One prefill dispatch for one slot: the whole prompt when it
        starts at 0 and fits a chunk (no context gather), else the next
        chunk over the cached context. The last one samples the first
        token and finishes the prefill."""
        req = slot.request
        n = len(req.prompt_tokens)
        cfg = self.model_cfg
        table = self._dev(self._page_tables[slot.index:slot.index + 1],
                          "page tables")
        lora = self._lora_stacks
        lidx = (self._dev(np.asarray([self._lora_names.get(req.lora, 0)],
                                     np.int32))
                if lora is not None else None)
        if slot.prefill_pos == 0 and n <= self.config.max_prefill_tokens:
            self.telemetry.on_prefill_chunk(req, n, 0)
            self._account_prefill(slot, 0, n)
            tokens, bucket = self._prep_full_prompt(req)
            self._first_use(self._prefill_fns, bucket)
            self.dispatches += 1
            logits = prefill(cfg, self.params, self._dev(tokens),
                             self._dev(np.asarray([n], np.int32)),
                             self.k_pages, self.v_pages, table, lora=lora,
                             lora_idx=lidx)[0]
            self._finish_legacy_prefill(slot, logits, touched)
            return
        tokens, chunk, bucket = self._prep_chunk(slot, req)
        start = slot.prefill_pos
        self.telemetry.on_prefill_chunk(req, chunk, start)
        self._account_prefill(slot, start, chunk)
        ctx = self._ctx_bucket(start)
        self._first_use(self._chunk_fns, (bucket, ctx))
        meta = self._dev(np.asarray([start, chunk], np.int32))
        self.dispatches += 1
        logits = prefill_chunk(cfg, self.params, self._dev(tokens),
                               meta[:1], meta[1:], self.k_pages,
                               self.v_pages, table, ctx_pages=ctx,
                               lora=lora, lora_idx=lidx)[0]
        slot.prefill_pos += chunk
        if slot.prefill_pos >= n:
            self._finish_legacy_prefill(slot, logits, touched)

    def _finish_legacy_prefill(self, slot: _Slot, logits: torch.Tensor,
                               touched: List[Request]) -> None:
        """Sample a finished prompt's first token from its last row's
        (1, V) logits, as the reference's prefill programs do: the whole
        prompt counts as seen for the penalty, the noise is keyed by
        (seed, prompt length); then finish the prefill. The slot joins
        the device decode state, its seen row rebuilt, before the next
        decode tick."""
        p = slot.request.params
        n = len(slot.request.prompt_tokens)
        V = self.model_cfg.vocab_size
        f = self._dev(np.asarray([[p.temperature], [p.top_p],
                                  [p.repetition_penalty]], np.float32),
                      "sampling row")
        seen = None
        if p.repetition_penalty != 1.0:
            row = np.zeros((1, V), bool)
            row[0, np.asarray(slot.request.prompt_tokens, np.int64) % V] = \
                True
            seen = self._dev(row, "seen row")
        if p.temperature <= 0.0:
            toks = _sample(logits, f[0], f[1], rep_pens=f[2], seen=seen,
                           all_greedy=True)
        else:
            i = self._dev(np.asarray([[p.top_k], [slot.seed], [n]],
                                     np.int32), "sampling row")
            toks = _sample(logits, f[0], f[1], i[0], f[2], seen,
                           gumbel=row_gumbel(i[1], i[2], V))
        first = int(self._readback(toks)[0])
        self._mark_seen_dirty(slot.index)
        self._state_stale = True
        self._finish_prefill(slot, first, touched)

    # -- speculative decoding ------------------------------------------------
    # The reference's rounds (ray_tpu/llm/_internal/engine.py:2188-2530),
    # run eagerly. Round invariant: canonical tokens [0, P) (prompt and
    # output), the target's KV written for [0, P-1), the newest token
    # pending. A round: (1) the draft chunk-prefills the canonical tokens
    # it has not seen, then runs k-2 decode steps: candidates d1..d_{k-1};
    # (2) the target verifies [t_last, d1..] in one chunk forward with
    # logits at every position; (3) the host accepts the longest prefix
    # the target's argmax agrees with, and emits it and the target's own
    # next token. Rejected candidates leave KV at [P+n, P+k-1) that the
    # next round's verify rewrites before any attention reads it.
    def _spec_prefill_draft(self, slot: _Slot) -> None:
        """Admission: the draft prefills the whole prompt in one
        dispatch (it is small; chunking buys nothing). With the prefix
        cache a shared page is rewritten with the values it holds."""
        sp = self._spec
        req = slot.request
        n = len(req.prompt_tokens)
        tokens, bucket = self._prep_full_prompt(req)
        self._first_use(sp["prefill_fns"], bucket)
        table = self._dev(self._page_tables[slot.index:slot.index + 1],
                          "page tables")
        if self.perf is not None:
            cm_d = sp["cost_model"]
            c = cm_d.chunk_cost(0, n)
            self.perf.add("spec", c, weight_bytes=cm_d.weight_bytes)
            if self.attrib is not None:
                self.attrib.charge(req, c, pages=len(slot.pages))
        self.dispatches += 1
        prefill(sp["cfg"], sp["params"], self._dev(tokens),
                self._dev(np.asarray([n], np.int32)), sp["dk"], sp["dv"],
                table, emit="hidden")
        sp["draft_pos"][slot.index] = n

    def _spec_ready(self) -> bool:
        """Rounds run only while every decoding request is greedy
        without a penalty (acceptance is an exact token match). Read
        from host slot state, before any device-state refresh: rounds
        back to back upload no slot state."""
        if self._spec is None:
            return False
        ready = [s for s in self.slots if s.request is not None and s.ready]
        return bool(ready) and all(
            s.request.params.temperature <= 0.0
            and s.request.params.repetition_penalty == 1.0 for s in ready)

    def _spec_draft(self, meta: torch.Tensor, tables: torch.Tensor,
                    ctx: int) -> torch.Tensor:
        """The draft's half of a round (one dispatch): a chunk forward
        over each slot's unseen canonical tokens, then k-2 decode steps
        on the draft's greedy tokens, each slot's KV writes held below
        its limit. meta: (B, k+1+4) int32, the delta tokens then start /
        length / active / limit. Returns the (B, k-1) candidates."""
        sp = self._spec
        dcfg, k = sp["cfg"], sp["k"]
        w = k + 1
        start, lens = meta[:, w], meta[:, w + 1]
        active, limit = meta[:, w + 2] != 0, meta[:, w + 3]
        logits = prefill_chunk(dcfg, sp["params"], meta[:, :w], start, lens,
                               sp["dk"], sp["dv"], tables,
                               ctx_pages=ctx)[0]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        pos = start + lens
        cands = [tok]
        for _ in range(k - 2):
            # a write past the slot's pages would land on a page another
            # request owns (a table's unused entries are page 0)
            lg = decode_step(dcfg, sp["params"], tok, pos, sp["dk"],
                             sp["dv"], tables, active & (pos < limit),
                             impl=self.impl)[0]
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            cands.append(tok)
            pos = pos + 1
        return torch.stack(cands, dim=1)

    def _spec_decode(self, touched: List[Request]) -> None:
        """One speculative round for every decoding slot (all greedy):
        the draft catch-up if a slot's unseen delta outgrew the round's
        buffer, the draft, the verify, and the host's acceptance."""
        sp = self._spec
        k = sp["k"]
        B = self.config.max_batch_size
        page = self.allocator.page_size
        active = [sl for sl in self.slots
                  if sl.request is not None and sl.ready]

        def canon(sl):
            return sl.request.prompt_tokens + sl.request.output_tokens

        tables = self._device_tables()
        w = k + 1
        # 0. draft catch-up: decode ticks outside the rounds (a sampled
        # request in the batch, a mixed tick) can leave a delta larger
        # than the round's buffer: prefill it into the draft in chunks
        while True:
            over = [sl for sl in active
                    if len(canon(sl)) - int(sp["draft_pos"][sl.index]) > w]
            if not over:
                break
            ct = np.zeros((B, w + 2), np.int32)
            for sl in over:
                seq = canon(sl)
                dp = int(sp["draft_pos"][sl.index])
                # leave at least one delta token for the round itself
                take = min(w, len(seq) - dp - 1)
                ct[sl.index, :take] = seq[dp:dp + take]
                ct[sl.index, w:] = (dp, take)
                sp["draft_pos"][sl.index] = dp + take
            if self.perf is not None:
                cm_d = sp["cost_model"]
                tot: Dict[str, float] = {}
                for sl in over:
                    c = cm_d.chunk_cost(int(ct[sl.index, w]),
                                        int(ct[sl.index, w + 1]))
                    _merge_cost(tot, c)
                    if self.attrib is not None:
                        self.attrib.charge(sl.request, c,
                                           pages=len(sl.pages))
                self.perf.add("spec", tot, weight_bytes=cm_d.weight_bytes)
            self._first_use(sp["draft_fns"], ("sync", w))
            self.dispatches += 1
            m = self._dev(ct)
            prefill_chunk(sp["cfg"], sp["params"], m[:, :w], m[:, w],
                          m[:, w + 1], sp["dk"], sp["dv"], tables,
                          ctx_pages=-1, emit="hidden")

        # 1. the draft: one dispatch for the batch
        dm = np.zeros((B, w + 4), np.int32)
        for sl in active:
            seq = canon(sl)
            dp = int(sp["draft_pos"][sl.index])
            delta = seq[dp:]
            assert 0 < len(delta) <= w, (dp, len(seq))
            dm[sl.index, :len(delta)] = delta
            dm[sl.index, w:] = (dp, len(delta), 1, len(sl.pages) * page)
        ctx = self._ctx_bucket(max(len(canon(sl)) for sl in active) + k)
        if self.perf is not None:
            # a delta chunk and k-2 decode steps a slot, charged against
            # the draft: k-1 forwards, each reading the draft's weights
            cm_d = sp["cost_model"]
            tot = {}
            for sl in active:
                dp, dn = int(dm[sl.index, w]), int(dm[sl.index, w + 1])
                sc: Dict[str, float] = {}
                _merge_cost(sc, cm_d.chunk_cost(dp, dn))
                for j in range(max(k - 2, 0)):
                    _merge_cost(sc, cm_d.decode_cost(dp + dn + j + 1))
                _merge_cost(tot, sc)
                if self.attrib is not None:
                    self.attrib.charge(sl.request, sc, pages=len(sl.pages))
            self.perf.add("spec", tot, weight_bytes=cm_d.weight_bytes,
                          weight_reads=max(k - 1, 1))
        self._first_use(sp["draft_fns"], (w, ctx))
        self.dispatches += 1
        cands = self._readback(self._spec_draft(self._dev(dm), tables, ctx))

        # 2. the verify: [t_last, d1..] a slot, its length clamped to the
        # request's remaining tokens so no write passes its pages
        vm = np.zeros((B, k + 2), np.int32)
        for sl in active:
            seq = canon(sl)
            P = len(seq)
            remaining = sl.request.params.max_tokens - len(
                sl.request.output_tokens)
            use = 1 + min(k - 1, max(remaining - 1, 0))
            vm[sl.index, 0] = seq[-1]
            vm[sl.index, 1:use] = cands[sl.index, :use - 1]
            vm[sl.index, k:] = (P - 1, use)
            # safe because admission reserves prompt + max_tokens
            assert P - 1 + use <= len(sl.pages) * page, (
                "verify write past allocated pages", sl.index, P, use,
                len(sl.pages), page)
        if self.perf is not None:
            # one chunk a slot with logits at every position: the head
            # runs for every verified row, not just the last
            cm = self.perf.model
            tot = {}
            for sl in active:
                use = int(vm[sl.index, k + 1])
                sc = dict(cm.chunk_cost(int(vm[sl.index, k]), use))
                sc["flops_gemm"] = (sc.get("flops_gemm", 0.0)
                                    + (use - 1) * cm.head_flops)
                _merge_cost(tot, sc)
                if self.attrib is not None:
                    self.attrib.charge(sl.request, sc, pages=len(sl.pages))
            self.perf.add("spec", tot)
        self._first_use(sp["verify_fns"], ctx)
        self.dispatches += 1
        m = self._dev(vm)
        logits_all = prefill_chunk(
            self.model_cfg, self.params, m[:, :k], m[:, k], m[:, k + 1],
            self.k_pages, self.v_pages, tables, ctx_pages=ctx,
            emit="logits_all")[0]
        preds = self._readback(
            torch.argmax(logits_all, dim=-1).to(torch.int32))   # (B, k)

        # 3. the host's acceptance
        t_h = time.perf_counter()
        n_emit = 0
        for sl in active:
            i = sl.index
            req = sl.request
            emit0 = n_emit
            use = int(vm[i, k + 1])
            P = int(vm[i, k]) + 1
            n_acc = 0
            while n_acc < use - 1 and preds[i, n_acc] == vm[i, n_acc + 1]:
                n_acc += 1
            new_tokens = [int(t) for t in vm[i, 1:1 + n_acc]] + [
                int(preds[i, n_acc])]
            sp["rounds"] += 1
            sp["accepted"] += n_acc
            # the draft re-syncs from the round's start: its candidates
            # past the accepted prefix may be wrong
            sp["draft_pos"][i] = P
            # position counts cached tokens: t_last and every accepted
            # candidate gained KV this round; the newest stays pending
            sl.position = P - 1
            for tok in new_tokens:
                sp["emitted"] += 1
                n_emit += 1
                sl.position += 1
                sl.last_token = tok
                self._append_token(sl, tok, touched)
                if sl.request is None:        # finished mid-round
                    break
            if self.attrib is not None and n_emit > emit0:
                self.attrib.charge(req, decode_tokens=n_emit - emit0)
        if self.perf is not None and n_emit:
            self.perf.note_tokens(decode_tokens=n_emit)
        self._tick_host_s += time.perf_counter() - t_h
        # the decode loop's device state (tokens, positions) did not
        # move: a decode tick outside the rounds refreshes it first
        self._state_stale = True

    def _decode_once(self, all_greedy: bool,
                     active: torch.Tensor) -> torch.Tensor:
        """One decode step on the static device state for the slots in
        `active`: the forward and KV write, sampling, the seen update,
        and the feedback of tokens and positions. Returns the (B,) int32
        tokens."""
        lora = self._lora_stacks
        logits = decode_step(
            self.model_cfg, self.params, self._d_tokens, self._d_positions,
            self.k_pages, self.v_pages, self._d_tables, active,
            impl=self.impl, lora=lora,
            lora_idx=self._d_lora if lora is not None else None,
            **self._kv_args())[0]
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
        self._d_positions.add_(active)
        return new

    def _decode_body(self, all_greedy: bool, k: int) -> torch.Tensor:
        """One pure-decode tick (k == 1: the (B,) tokens) or one
        multi-step round (k > 1: the (k, B) tokens, sub-step i run for
        the active slots whose budget, end - positions at the round's
        start, exceeds i). This is what a decode graph captures."""
        active = self._d_active != 0
        if k == 1:
            return self._decode_once(all_greedy, active)
        budget = self._d_end - self._d_positions
        return torch.stack([self._decode_once(all_greedy,
                                              active & (budget > i))
                            for i in range(k)])

    @contextlib.contextmanager
    def _capturing(self):
        """Around a decode graph's capture, inside step() (the lock
        held): counted, reported to an armed guard, syncs allowed."""
        self.graph_captures += 1
        self.compiles += 1  # racelint: disable=RL001 -- DecodeGraph enters this inside step(), under _step_lock
        if self._guard is not None:
            self._guard.capture(f"decode graph {len(self._decode_graphs)}")
        with self._sync_allowed():
            yield

    def _decode_graph(self, k: int = 1) -> DecodeGraph:
        """The decode program of (sampling mode, stacks present, k); an
        engine that never registers an adapter keeps k=1's one graph a
        sampling mode."""
        key = (self._all_greedy, self._lora_stacks is not None, k)
        graph = self._decode_graphs.get(key)
        if graph is None:
            if self._capture_graphs and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = DecodeGraph(
                functools.partial(self._decode_body, key[0], k),
                self._capture_graphs, self._graph_pool, self._capturing)
            self._decode_graphs[key] = graph
        self._tick_eager = graph.graph is None
        return graph

    def _multi_ok(self) -> bool:
        """Multi-step rounds only while nothing waits or prefills: a
        prompt advancing needs the one-step cadence."""
        if self.waiting:
            return False
        return not any(s.request is not None and not s.ready
                       for s in self.slots)

    def _decode(self, touched: List[Request]) -> None:
        """One pure-decode tick over every decoding slot: one graph
        replay, then the copy of its tokens to the host; with
        async_readback the previous tick folds now and this one on the
        next step. With decode_steps_per_call > 1 and nothing waiting or
        prefilling, a multi-step round instead; with a draft model and
        every decoding request greedy, a speculative round (before any
        device-state refresh: a round reads host state)."""
        if self._spec_ready():
            self._spec_decode(touched)
            return
        if self.config.decode_steps_per_call > 1 and self._multi_ok():
            # a round reads host budgets: the tick in flight lands first
            self._drain(touched)
            if self._state_stale:
                self._refresh_device_state()
            if self._host_active.any():
                self._multi_decode(touched)
            return
        if self._state_stale:
            self._refresh_device_state()
        self.dispatches += 1
        self.decode_ticks += 1
        toks = self._decode_graph()()
        rec = _InflightTick(*self._start_readback(toks),
                            self._host_active.copy())
        # the tick's cost, from the host slot state the fold below moves:
        # after the launch, so the host's arithmetic runs under the
        # device's work instead of ahead of it
        self._account_decode_batch()
        if not self._async:
            self._fold_inflight(rec, touched, lagged=False)
            return
        prev, self._inflight = self._inflight, rec
        if prev is not None and self._fold_inflight(prev, touched):
            # retirement is structural: fold the successor dispatched
            # above too (its token for the retired slot is the one-token
            # over-generation, discarded by the fold's active check)
            rec, self._inflight = self._inflight, None
            self._drains += 1
            self.telemetry.on_drain("retirement")
            self._fold_inflight(rec, touched, lagged=False)

    def _multi_decode(self, touched: List[Request]) -> None:
        """One multi-step round: one graph replay of K decode steps, one
        (K, B) readback, and every row folded in order before any device
        state refresh (EOS or max_tokens cut a slot mid-round; its later
        rows are discarded). Retirement marks the state stale: the next
        tick refreshes it."""
        K = int(self.config.decode_steps_per_call)
        budget = np.zeros(len(self.slots), np.int64)
        for s in self.slots:
            if s.request is not None and s.ready:
                budget[s.index] = (s.request.params.max_tokens
                                   - len(s.request.output_tokens))
        self.dispatches += 1
        self.multi_rounds += 1
        toks = self._decode_graph(K)()
        buf, done = self._host_round, self._round_event
        buf.copy_(toks, non_blocking=done is not None)
        if done is not None:
            done.record()
        self._account_multi(budget, K)
        toks_host = self._read_tokens(buf, done)
        t_h = time.perf_counter()
        active = self._host_active.copy()
        for i in range(K):
            for s in self.slots:
                if s.request is None or not active[s.index] \
                        or budget[s.index] <= i:
                    continue
                s.position += 1
                tok = int(toks_host[i, s.index])
                s.last_token = tok
                self._append_token(s, tok, touched)
        self._tick_host_s += time.perf_counter() - t_h

    def _account_multi(self, budget: np.ndarray, k: int) -> None:
        """A multi-step round: each active slot advances min(budget, K)
        tokens, the weights stream K times (the reference's
        "multi_decode" charge)."""
        if self.perf is None:
            return
        cm = self.perf.model
        tot: Dict[str, float] = {}
        ndec = 0
        for s in self.slots:
            if s.request is None or not self._host_active[s.index]:
                continue
            rows = min(int(budget[s.index]), k)
            sc: Dict[str, float] = {}
            for j in range(rows):
                _merge_cost(sc, cm.decode_cost(s.position + 1 + j))
            _merge_cost(tot, sc)
            if self.attrib is not None and rows:
                self.attrib.charge(s.request, sc, decode_tokens=rows,
                                   pages=len(s.pages))
            ndec += rows
        if ndec:
            self.perf.add("multi_decode", tot, decode_tokens=ndec,
                          weight_reads=k)

    def _drain(self, touched: List[Request]) -> None:
        """Pipeline barrier: fold the in-flight tick, if any, into host
        slot state now, before a structural event (admission, prefill,
        abort) reads or moves it."""
        rec = self._inflight
        if rec is None:
            return
        self._inflight = None
        self._drains += 1
        self.telemetry.on_drain("structural")
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
            req.prompt_tokens, slot.pages[:n // self.allocator.page_size],
            req.lora)
        slot.prefill_pos = n
        slot.position = n
        slot.ready = True
        slot.last_token = first_token
        if self._spec is not None:
            self._spec_prefill_draft(slot)
        self._append_token(slot, first_token, touched)

    def _append_token(self, slot: _Slot, tok: int,
                      touched: List[Request]) -> None:
        req = slot.request
        req.output_tokens.append(tok)
        self.telemetry.on_token(req)
        touched.append(req)
        p = req.params
        if tok in p.stop_token_ids:
            self._finish(slot, "stop")
        elif len(req.output_tokens) >= p.max_tokens:
            self._finish(slot, "length")

    def _attrib_finish(self, req: Request, reason: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
        """Close the request's cost receipt; its usage.cost brief for
        the finish event (None when it was never charged)."""
        if self.attrib is None:
            return None
        rec = self.attrib.finish(req, reason)
        return None if rec is None else rec.cost_block()

    def _finish(self, slot: _Slot, reason: str) -> None:
        slot.request.finished = True
        slot.request.finish_reason = reason
        cost = self._attrib_finish(slot.request, reason)
        self.telemetry.on_finished(slot.request, reason, cost=cost)
        self.allocator.free(slot.pages)
        self._clear_slot(slot)

    def _clear_slot(self, slot: _Slot) -> None:
        """Return a slot to the empty state (its pages already released:
        _finish frees them, a preemption spills and then frees)."""
        slot.request = None
        slot.pages = []
        slot.position = 0
        slot.prefill_pos = 0
        slot.ready = False
        self._page_tables[slot.index] = 0
        self._tables_version += 1
        self._mark_seen_dirty(slot.index)
        self._state_stale = True
