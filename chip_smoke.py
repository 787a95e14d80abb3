"""End-to-end smoke run of ray_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: name, and name + power limit from nvidia-smi;
  2. build: compile the CUDA kernels from ray_tpu_torch/ops/csrc (one
     nvcc per source, in parallel); the tensor-core instances (bf16
     flash forward, dq and dk/dv; the ragged kernel for bf16 queries on
     bf16, int8 and fp8 pages) must hold HGMMA instructions in their
     SASS, and their ptxas register and spill lines are printed; so
     are the registers, spills and stack of the 6 instances of the
     pipelined decode kernel;
  3. serving kernels vs plain: each against its plain PyTorch version
     at Llama-3-8B attention widths (H=32, KVH=8, D=128, page 16, bf16
     q), on bf16 pages and then on int8 and fp8 pages with their scale
     pools, with the kernel's time (CUDA events around the wrapper
     call, and the kernels' device time from the profiler), the host
     work of a wrapper call in us and the decode route it took, the
     plain version's and one PyTorch library call's times, and the
     least time the card could take; the ragged kernel on each tick of
     RAGGED_TICKS, two launches bit-identical; the sampler's noise
     kernel against its plain version at B 8, V 128256 (bits and
     uniforms bit-equal, Gumbel values within 2^-22 x max(1, |g|)) with
     its times (here, early in the process: late in it the profiler
     lost some of this kernel's launches, ROADMAP §C);
  4. flash kernels vs plain: forward, dq and dk/dv against their plain
     versions at 8b widths (B=4, S=2048, causal, bf16), at 1b widths
     (D=64), at S=1000 (every tile cut unevenly) and on a small
     non-causal Sq != Sk case; two launches must give the same bits;
     times as in phase 3 at 8b and 1b widths, with the achieved TFLOP/s
     of the function's work and the share of the bound;
  5. engine: InferenceEngine on the `8b` preset at full width and depth
     (random bf16 weights from a seeded generator), mixed prefill+decode
     ticks then pure decode, through add_request/step; both kernels'
     launch counters must move, and every decode launch must take the
     pipelined kernel (profiles give each serving kernel's device time a
     launch, and the decode launch's); the same requests on
     decode_impl="gather" must give the same greedy tokens (or differ
     only at a stated near-tie); the same holds for a small f32 engine;
     a 5200-token prompt beside a decoding request drives ticks at the
     full table width (512 context pages, 1024 tokens): their peak
     device memory and the ragged kernel's largest key-chunk scratch;
  5b. quantized engine: the same on int8 and then fp8 KV pages (same
     weights, full depth): the kind's launch counters equal layers x
     ticks and every other counter stays 0; kernel vs gather as in 5
     (fp8 with its own near-tie margin); a small f32 engine on int8
     pages token-exact; agreement with the bf16-pool streams, decode
     tick, kernel device time a tick and pool bytes printed;
  5c. decode tick mechanics: on bf16, int8 and fp8 pages (same weights,
     full depth), the default engines of phases 5 and 5b (one CUDA graph
     replay a decode tick, lagged readback) against cuda_graph=False,
     async_readback=False: greedy and sampled streams (temperature 0.8,
     top_p 0.95, top_k 50, per-request seeds) token-exact; the decode
     launch counters equal layers x decode ticks, all on the pipelined
     route; the unprofiled steady decode-tick median and, from a
     profile, kernels busy and device idle, for both engines; 16 steady
     ticks of the default engine under dispatch_guard with no upload,
     no capture, one readback a tick, and, in the profiler, no Memcpy
     HtoD and one cudaGraphLaunch a tick; each engine's peak memory;
  5d. KV memory hierarchy: on bf16, int8 and fp8 pages (same weights,
     full depth, default engines): 16 seeded prompts of 240-720 tokens,
     96 tokens each, at B 8 on 128 usable pages (kv_watermark_tokens
     32, an unbounded host tier) against the same requests on 1024
     pages, greedy (bf16) and sampled: every request finishes, at least
     one spill, growth preemption and restore, the tier empty at the
     end, the kind's serving kernels launched, tokens equal to the ample
     engine's or differing at a near tie (greedy: the teacher-logits
     rule of phase 5; sampled: the sampler's scores with the request's
     noise); preemptions by reason, peaks of parked requests and page
     pressure, wall and output tokens/s of both; then 16 guarded steady
     ticks after the storm (no upload, no capture, a readback and a
     cudaGraphLaunch a tick); a manual preempt and restore of 1 of 8
     decoding requests, all 8 streams token-exact against the engine
     never preempting, no new capture, the pools in place, the restored
     rows byte-equal to the host copy; spill and restore of 8 and 48
     pages timed (CUDA events, GB/s) beside a pinned copy_ of the same
     bytes; a session exported mid-decode through the RTKV wire into a
     second engine, token-exact; an int8 frame into an fp8 engine
     refused; an exported prefix hitting in the second engine;
  5e. serving replica: LLMServerImpl on the `8b` preset at full width
     and depth (random bf16 weights from seed 0, B 8, pages of 16, 1025
     pages, every observability switch on): 8 completions, 2 chats and
     2 token streams (prompts of 14-1535 tokens, greedy, 64 tokens) at
     once through asyncio; the tokens of each equal those of an engine
     driven directly with the same weights (or differ at a near tie as
     in phase 5), responses agree with their tokens; TTFT, TPOT and e2e
     (p50, p99, from the /debug/trace lifecycles, one a request) and
     stats()["requests"], output tokens/s; stats()["perf"] against the
     h100 envelope (every MFU and MBU share in (0, 1]) and the mixed and
     decode ticks' walls, with a decode tick's bytes by the cost model
     beside the bytes of the engine's tensors; decode ticks with every
     switch on against off on one engine (median within the spread); a
     guarded window with observability on (no upload, no capture, one
     readback and one cudaGraphLaunch a tick); the cold ticks (compile
     events) and every tick the anomaly detector flagged, by class; a
     black-box bundle written and read back; profile_next_ticks(4) over
     mixed and decode ticks, whose Chrome trace holds as many ragged and
     decode launches as the counters moved; the exposition parses with
     the JAX family names; a session moved from one server to a second
     through the RTKV wire, token-exact;
  5f. multi-LoRA serving and multi-step decode: on the `8b` preset at
     full width and depth (the bf16 phase's weights, B 8, pages of 16,
     1025 pages): lora_delta against lora_delta_plain at 8b widths (T
     512 and B 8, bf16); the steady decode tick and the mixed tick
     base-only with no stacks, then 3 rank-16 adapters on
     wq/wk/wv/wo (seeded numpy: strong, mild, zero) registered (compiles
     +1, graph captures +0; a later registration of the same ranks +0,
     +0, and no capture after it); 8 requests at once (2 base, 2 on each
     adapter, prompts of 14-1535 tokens, 64 tokens), greedy and sampled,
     on bf16, int8 and fp8 pages: the default engine against
     cuda_graph=False, async_readback=False token-exact, against the
     gather engine within phase 5's near tie (greedy) or phase 5d's
     pickable rule (sampled), with each request's adapter in the
     teacher-forced logits; the zero adapter bit-equal to base, the
     strong one's greedy tokens different; launch counters layers x
     ticks, all decode launches pipelined; the steady decode and mixed
     ticks with 3 adapters active, LoRA launches a tick, the stacks'
     bytes; 16 guarded LoRA decode ticks; a base request after an
     adapter request on one 40-token prompt equal to a fresh engine's
     (the prefix-cache bypass); decode_steps_per_call=4 against K=1 on
     the 8 requests all base and under the adapters, greedy and
     sampled, 62 tokens and a stop token: step-exact; the K=4 graphs'
     capture time and reserve, ms a token at K=1 and K=4, 8 guarded
     rounds (no upload, no capture, one readback and one
     cudaGraphLaunch a round); LLMServerImpl with `lora_adapters` serving
     4 adapter and 2 base completions at once (tokens equal a directly
     driven engine's, or differ at a near tie), a live register_lora,
     an unknown model refused; every flagged tick's first-use evidence;
  5g. speculative decoding and the legacy step: on the `8b` preset at
     full width and depth (the bf16 phase's weights, B 8, pages of 16,
     1025 pages): 8 greedy requests at once (prompts of 14-1535 tokens,
     64 tokens) through the default engine, then through a speculative
     engine with (a) a perfect draft (the `8b` preset on the target's own
     tensors, shared) and (b) a `1b` draft with its own seeded random
     weights, k 4: tokens equal to the default engine's or, where they
     first differ, the speculative engine's token within a near tie
     (phase 5's margin, or two bf16 ulps of the top logit where wider)
     of the teacher-forced argmax of the gather impl (phase 5's
     reference); first the same exactly, token for token, at
     a small size in float32 (the `tiny` preset: a perfect draft, a bf16
     draft on the pipelined decode kernel, and the legacy step);
     acceptance, tokens a round, dispatches,
     catch-up syncs, peak memory; the launch counters (the ragged kernel
     layers x mixed ticks, the draft's decode kernel draft layers x (k-2)
     x draft dispatches, all pipelined); a steady round's ms split into
     draft, verify, sync and host, and ms a token a slot against the
     default decode tick; (c) the `1b` draft's decode shape (D 64)
     through kernel #2 against its plain version; (d) a sampled request
     joining and leaving a perfect-draft engine: decode ticks while it
     runs, a catch-up sync and rounds after, the greedy stream by the
     same rule; (e) the legacy step (unified_step=False) on phase 5's six
     prompts, 16 tokens, against the unified engine (the legacy engine's
     token judged as in (a)): no
     ragged launch, decode launches layers x decode ticks, dispatches a
     tick, the wall of prefill ticks against mixed ticks;
  6. train: TrainStepBundle on the `8b` preset at full width, 4 layers
     (random f32 parameters from a seeded generator, bf16 compute,
     remat, loss chunk 512), batch 4 x 2048 tokens: a warm-up step and
     8 timed steps through init_state/step; losses finite and falling;
     the three flash kernels' launch counters as remat implies; step
     time, tokens/s, MFU, peak memory and a profiler breakdown; one
     step on attention_impl="xla" from the same parameters must agree;
  7. summary: one {"kernels": [...]} line, the card line, then the
     {"ok": true, "device": ...} line last.

`--only decode` (development) stops after phase 3's decode rows and
prints them instead of the result line. `--only profiler` (development)
runs the profiler-loss check instead of every phase (see
`profiler_check`) and prints its counts instead of the result line.

Imports neither jax nor ray_tpu.
Exits non-zero before printing any result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# data-sheet peaks of an H100 SXM at its full power limit (NVIDIA)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

DECODE_TOL = 3e-2     # bf16 output: both sides round f32 results once;
#                       one bf16 ulp at |x| < 4 is 1.6e-2
STAT_RTOL = 1e-3      # float32 row max / denominator, summed in other order
RAGGED_TOL = 3e-2     # as DECODE_TOL
NEAR_TIE = 0.05       # logit gap under which a greedy flip between the
#                       two engines counts as a near tie: bf16
#                       activations summed in another order
NEAR_TIE_FP8 = 0.15   # the same on fp8 pages: e4m3 keeps 3 mantissa bits,
#                       so a K/V value the two engines compute one bf16
#                       ulp apart can land one fp8 step (6-12%) apart,
#                       and the teacher-forced replay, which prefills the
#                       context in one pass, rounds its K/V apart again
FLASH_REL = 1.6e-2    # flash kernels vs plain, bf16 outputs: two bf16
#                       ulps of the element (each side rounds its float32
#                       sum once) ...
FLASH_ABS = 1e-3      # ... plus this share of the largest element (sums
#                       that cancel to near zero)
LSE_TOL = 1e-4        # float32 logsumexp, summed in another order
TRAIN_LOSS_RTOL = 5e-3   # kernel step vs "xla" step, same parameters:
TRAIN_GNORM_RTOL = 5e-2  # bf16 activations; the reference rounds its
#                          probabilities to bf16 before the value product,
#                          the kernels keep them in float32


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dev_us(e):
    """Device microseconds of a profiler row (its own kernels only)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The profiler's device kernel rows (an aten op's row repeats its
    kernels' time, so only the kernels themselves), the lead-in's
    kernels left out."""
    evs = [e for e in prof.key_averages() if dev_us(e) > 0
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not evs:
        evs = [e for e in prof.key_averages() if dev_us(e) > 0
               and not e.key.startswith(("aten::", "cuda"))]
    return [e for e in evs if "spin_kernel" not in e.key]


def repeat(fn, n):
    for _ in range(n):
        fn()


def traced(fn, host=False):
    """torch.profiler over fn() and a synchronise: the device's activity
    (kernels, copies, the CUDA runtime's calls), and with `host` the
    host's operators too (slow to gather over eager ticks); returns
    (profile, wall ms of fn and the synchronise). The window is padded as
    util/profiling.py says (lead-in kernels before fn, idle time after
    the synchronise): the profiler loses records at unpadded edges."""
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.util import profiling
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        profiling.lead_in()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        profiling.settle()
    return prof, wall


def device_ms(fn, keys, calls=10, by_kernel=False):
    """Device milliseconds a call of fn() spends in the kernels whose
    name holds one of `keys` (torch.profiler over `calls` calls after a
    warm-up): the kernels' own time, without the wrapper's host work
    that the CUDA-event time of a single call also holds when the
    device waits on the host. With by_kernel, also {kernel: ms a call}.
    Fails when the profile holds no such kernel, or a kernel's launches
    are not a whole number a call (a record the profiler lost)."""
    fn()

    def short(evs):
        mine = [e for e in evs if any(k in e.key for k in keys)]
        return [(e.key[:40], e.count) for e in mine
                if e.count % calls] or (not mine and "no launch")
    prof, _ = profiled(lambda: repeat(fn, calls), f"device_ms {keys}",
                       check=short)
    evs = [e for e in device_events(prof) if any(k in e.key for k in keys)]
    rows = {e.key: dev_us(e) / 1e3 / calls for e in evs}
    total = sum(rows.values())
    return (total, rows) if by_kernel else total


def fmt_ms(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def host_us(fn, calls=200):
    """Host microseconds a call of fn() takes to return: the wrapper's
    checks, allocations and launches, with the device running behind
    it. (median, min) over `calls` calls, each after a synchronise, so
    no queue of launches backs up; the minimum is the least disturbed
    by other work on a shared host."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6, min(times) * 1e6


# ------------------------------------------------------------ decode kernel

def decode_case(gen, dev, lens, max_pages, H=32, KVH=8, D=128, page=16,
                dtype=torch.bfloat16):
    B = len(lens)
    num_pages = B * max_pages + 1
    k_pages = torch.randn((num_pages, page, KVH, D), generator=gen,
                          device=dev).to(dtype)
    v_pages = torch.randn((num_pages, page, KVH, D), generator=gen,
                          device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)
    tables = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    k_new = torch.randn((B, KVH, D), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((B, KVH, D), generator=gen, device=dev).to(dtype)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables,
                seq_lens=seq_lens, k_new=k_new, v_new=v_new)


def quantize_pools(c, kind):
    """Replace the case's bf16 pools by `kind` (int8/fp8) pools; returns
    the scale pools as keyword arguments (empty for kind None)."""
    if kind is None:
        return {}
    from ray_tpu_torch.ops import kv_quant
    c["k_pages"], ks = kv_quant.quantize_rows(c["k_pages"], kind)
    c["v_pages"], vs = kv_quant.quantize_rows(c["v_pages"], kind)
    return dict(k_scales=ks, v_scales=vs)


def gathered_context(pa, pages, scales, tables, dtype):
    """Each sequence's context by the table in `dtype` (dequantized
    first for quantized pools): the library yardstick's input."""
    return pa.gather_context(pages, scales, tables).to(dtype)


def kv_row_bytes(c, kind):
    """Bytes of one (key, kv head) row of K or V in the pool: D values,
    plus a float32 scale for quantized pools."""
    d = c["k_pages"].shape[-1]
    return d * c["k_pages"].element_size() + (4 if kind else 0)


def check_decode(gen, dev, label, lens, max_pages, kind=None):
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import paged_attention as pa
    import torch.nn.functional as F
    c = decode_case(gen, dev, lens, max_pages)
    sc = quantize_pools(c, kind)
    label = f"{label}{' ' + kind if kind else ''}"
    args = (c["q"], c["k_pages"], c["v_pages"], c["tables"], c["seq_lens"])
    out, m, l = pa.paged_decode_attention(*args, return_stats=True, **sc)
    ref, m_ref, l_ref = pa.paged_decode_attention_plain(
        *args, return_stats=True, **sc)
    out_n = pa.paged_decode_with_new_token(*args, c["k_new"], c["v_new"],
                                           **sc)
    ref_n = pa.paged_decode_with_new_token_plain(*args, c["k_new"],
                                                 c["v_new"], **sc)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    err_n = (out_n.float() - ref_n.float()).abs().max().item()
    m_err = ((m - m_ref).abs() / m_ref.abs().clamp(min=1)).max().item()
    l_err = ((l - l_ref).abs() / l_ref.abs().clamp(min=1)).max().item()
    log(f"[decode {label}] lens={lens} max_pages={max_pages} "
        f"max_abs_err out={err:.3e} with_new_token={err_n:.3e} "
        f"(tol {DECODE_TOL}); m rel={m_err:.2e} l rel={l_err:.2e} "
        f"(tol {STAT_RTOL})")
    for name, e, tol in (("out", err, DECODE_TOL),
                         ("with_new_token", err_n, DECODE_TOL),
                         ("m", m_err, STAT_RTOL), ("l", l_err, STAT_RTOL)):
        if not (e <= tol):
            raise AssertionError(f"decode {label}: {name} error {e} > {tol}")
    new_args = args + (c["k_new"], c["v_new"])
    call = lambda: pa.paged_decode_with_new_token(*new_args, **sc)
    kern = _kernels.PAGED_DECODE_BY_KIND[{None: 0, "int8": 1,
                                          "fp8": 2}[kind]]
    before = dict(kern.routes)
    call()
    torch.cuda.synchronize()
    route = [r for r, n in kern.routes.items() if n != before.get(r, 0)]
    if route != ["pipelined"]:
        raise AssertionError(f"decode {label}: a bf16-query call at 8b "
                             f"shapes took the routes {route}, not the "
                             f"pipelined kernel")
    ms = time_ms(call)
    dev_ms, by_kernel = device_ms(call, ("paged_decode",), by_kernel=True)
    for name, t in sorted(by_kernel.items()):
        log(f"[decode {label}]   device {t:.4f} ms  {name[:100]}")
    h_us, h_min = host_us(call)
    plain_ms = time_ms(lambda: pa.paged_decode_with_new_token_plain(
        *new_args, **sc), iters=5)
    # library yardstick: SDPA over the pre-gathered dense KV + new token
    # (for quantized pools: the already-dequantized context in bf16, the
    # dequant not timed; no PyTorch call fuses it)
    B, H, D = c["q"].shape
    kvh = c["k_pages"].shape[2]
    kg = gathered_context(pa, c["k_pages"], sc.get("k_scales"), c["tables"],
                          c["q"].dtype)
    vg = gathered_context(pa, c["v_pages"], sc.get("v_scales"), c["tables"],
                          c["q"].dtype)
    group = H // kvh
    kd = torch.cat([kg, c["k_new"][:, None]], 1).repeat_interleave(
        group, dim=2).transpose(1, 2).contiguous()
    vd = torch.cat([vg, c["v_new"][:, None]], 1).repeat_interleave(
        group, dim=2).transpose(1, 2).contiguous()
    ctx = kg.shape[1]
    length = c["seq_lens"].long().clamp(min=1)
    idx = torch.arange(ctx + 1, device=dev)
    mask = ((idx[None, :] < length[:, None]) | (idx[None, :] == ctx))
    mask = mask[:, None, None, :]
    qd = c["q"][:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    # least work: each live cached key row read once (K and V, with its
    # scale when quantized), q and the new token read, out written;
    # 4*H*D flops per live key
    item = c["q"].element_size()
    keys = int(length.sum().item())
    nbytes = (2 * keys * kvh * kv_row_bytes(c, kind) + B * H * D * item
              + 2 * B * kvh * D * item + B * H * D * item
              + B * 4 + keys // 16 * 4)
    flops = 4 * H * D * (keys + B)
    b_ms, b_by = bound(nbytes, flops, c["q"].dtype)
    log(f"[decode {label}] kernel {ms:.4f} ms (device {fmt_ms(dev_ms)} ms, "
        f"host {h_us:.1f} us a call, least {h_min:.1f}; route "
        f"{route[0]}), "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=max(err, err_n), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                device_ms=dev_ms, host_us=h_us, host_us_min=h_min,
                decode_route=route[0])


# ------------------------------------------------------------ ragged kernel

def ragged_case(gen, dev, segs, pad, max_pages, H=32, KVH=8, D=128,
                page=16, dtype=torch.bfloat16):
    B = len(segs)
    num_pages = B * max_pages + 1
    k_pages = torch.randn((num_pages, page, KVH, D), generator=gen,
                          device=dev).to(dtype)
    v_pages = torch.randn((num_pages, page, KVH, D), generator=gen,
                          device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)
    tables = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    t = sum(n for _, n in segs) + pad
    slot_ids = torch.zeros(t, dtype=torch.int32)
    positions = torch.zeros(t, dtype=torch.int32)
    valid = torch.zeros(t, dtype=torch.bool)
    cur = 0
    for s, (start, n) in enumerate(segs):
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = torch.arange(start, start + n)
        valid[cur:cur + n] = True
        cur += n
    start = torch.tensor([s for s, _ in segs], dtype=torch.int32)
    q = torch.randn((t, H, D), generator=gen, device=dev).to(dtype)
    k_new = torch.randn((t, KVH, D), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((t, KVH, D), generator=gen, device=dev).to(dtype)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables,
                slot_ids=slot_ids.to(dev), positions=positions.to(dev),
                valid=valid.to(dev), start=start.to(dev), k_new=k_new,
                v_new=v_new)


# Mixed ticks at the engine's budget (512-token chunk cap + 8 slots):
# (label, [(start, n)] per slot, padding rows, ctx_pages).
RAGGED_TICKS = [
    # decode rows over contexts ending mid-page, a fresh single-token
    # slot (start=0), a fresh 200-token chunk, a 300-token chunk over a
    # 700-token context, and padding rows up to the 512 bucket; 256
    # pages is the pow2 bucket covering start 3999
    ("kernel phase tick", [(33, 1), (130, 1), (1023, 1), (2047, 1),
                           (3999, 1), (0, 1), (0, 200), (700, 300)],
     6, 256),
    # the engine's heaviest mixed tick: a 512-token chunk at start 1024
    # beside 7 decode rows, in the 1024-token bucket, over the 128-page
    # bucket covering start 1535
    ("512-chunk tick", [(1024, 512), (14, 1), (61, 1), (117, 1),
                        (311, 1), (673, 1), (1000, 1), (1535, 1)],
     505, 128),
]


def ragged_tick(gen, dev, kind, label, segs, pad, ctx_pages):
    """The ragged kernel on one mixed tick against its plain version
    (padding rows must be exact zeros); its time, the plain version's,
    SDPA's and the least-time bound."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops import ragged_paged_attention as rpa
    import torch.nn.functional as F
    max_pages = 512                      # the engine's full table width
    c = ragged_case(gen, dev, segs, pad, max_pages)
    sc = quantize_pools(c, kind)
    label = f"ragged{' ' + kind if kind else ''}, {label}"
    t = c["q"].shape[0]
    max_seg = min(t, 512)
    args = (c["q"], c["k_pages"], c["v_pages"], c["tables"], c["slot_ids"],
            c["positions"], c["valid"], c["start"], c["k_new"], c["v_new"])
    plan = rpa.ragged_plan(c["slot_ids"], c["positions"], c["valid"],
                           c["start"], max_seg)
    kw = dict(ctx_pages=ctx_pages, max_seg_len=max_seg, **sc)
    out = rpa.ragged_paged_attention(*args, plan=plan, **kw)
    again = rpa.ragged_paged_attention(*args, plan=plan, **kw)
    ref = rpa.ragged_paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = bool((out[~c["valid"]] == 0).all().item())
    same = torch.equal(out, again)
    log(f"[{label}] segs={segs} pad={pad} ctx_pages={ctx_pages} "
        f"max_abs_err={err:.3e} (tol {RAGGED_TOL}); padding rows exact "
        f"zero: {pad_zero}; repeat launches bit-identical: {same}")
    if not (err <= RAGGED_TOL) or not pad_zero or not same:
        raise AssertionError(f"{label} kernel disagrees: err {err}, "
                             f"padding zero {pad_zero}, repeat {same}")
    del ref, again
    call = lambda: rpa.ragged_paged_attention(*args, plan=plan, **kw)
    ms = time_ms(call)
    dev_ms = device_ms(call, ("ragged",))
    plain_ms = time_ms(lambda: rpa.ragged_paged_attention_plain(*args, **kw),
                       iters=5)
    # library yardstick: SDPA per slot over pre-gathered context + the
    # slot's own keys, padded to the longest segment, boolean mask
    B = len(segs)
    H, D = c["q"].shape[1], c["q"].shape[2]
    kvh = c["k_pages"].shape[2]
    smax = max(n for _, n in segs)
    ctx = ctx_pages * c["k_pages"].shape[1]
    tb = c["tables"][:, :ctx_pages]
    kg = gathered_context(pa, c["k_pages"], sc.get("k_scales"), tb,
                          c["q"].dtype)
    vg = gathered_context(pa, c["v_pages"], sc.get("v_scales"), tb,
                          c["q"].dtype)
    qp = torch.zeros((B, smax, H, D), dtype=c["q"].dtype, device=dev)
    kp = torch.zeros((B, smax, kvh, D), dtype=c["q"].dtype, device=dev)
    vp = torch.zeros_like(kp)
    mask = torch.zeros((B, smax, ctx + smax), dtype=torch.bool, device=dev)
    cur = 0
    for s, (st, n) in enumerate(segs):
        qp[s, :n] = c["q"][cur:cur + n]
        kp[s, :n] = c["k_new"][cur:cur + n]
        vp[s, :n] = c["v_new"][cur:cur + n]
        mask[s, :, :st] = True
        mask[s, :, ctx:ctx + smax] = torch.tril(torch.ones(
            smax, smax, dtype=torch.bool, device=dev))
        mask[s, :, ctx + n:] = False
        cur += n
    group = H // kvh
    kd = torch.cat([kg, kp], 1).repeat_interleave(group, dim=2).transpose(
        1, 2).contiguous()
    vd = torch.cat([vg, vp], 1).repeat_interleave(group, dim=2).transpose(
        1, 2).contiguous()
    qd = qp.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None]))
    del kd, vd, qd, kg, vg, mask
    item = c["q"].element_size()
    ctx_keys = sum(st for st, _ in segs)
    live = sum(n for _, n in segs)
    nbytes = (2 * ctx_keys * kvh * kv_row_bytes(c, kind)  # cached K, V
              + t * H * D * item                # q
              + 2 * t * kvh * D * item          # new K, V
              + t * H * D * item)               # out
    flops = sum(4 * H * D * (st + i + 1) for st, n in segs
                for i in range(n))
    b_ms, b_by = bound(nbytes, flops, c["q"].dtype)
    log(f"[{label}] T={t} live={live} kernel {ms:.4f} ms (device "
        f"{fmt_ms(dev_ms)} ms), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                device_ms=dev_ms)


def check_ragged(gen, dev, kind=None):
    """The ragged kernel on each tick of RAGGED_TICKS. Returns the kernel
    phase tick's numbers (the kernels line's row), max_abs_err the
    largest over the ticks, and every tick's numbers under "ticks"."""
    ticks = {}
    for label, segs, pad, ctx_pages in RAGGED_TICKS:
        ticks[label] = ragged_tick(gen, dev, kind, label, segs, pad,
                                   ctx_pages)
        torch.cuda.empty_cache()
    main = dict(ticks[RAGGED_TICKS[0][0]])
    main["max_abs_err"] = max(x["max_abs_err"] for x in ticks.values())
    return main, ticks


# ------------------------------------------------------------ flash kernels

def flash_case(gen, dev, b, sq, sk, h, kvh, d, dtype=torch.bfloat16):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d), \
        rnd(b, sq, h, d)


def flash_err(out, ref):
    """max |out - ref| and whether every element is within FLASH_REL of
    itself plus FLASH_ABS of the largest element."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    lim = FLASH_REL * r.abs() + FLASH_ABS * r.abs().max()
    return diff.max().item(), bool((diff <= lim).all().item())


def flash_work(b, sq, sk, h, kvh, d, causal, item):
    """(pairs, bytes of each kernel) for the least-time bound: the
    (row, col) pairs the mask leaves live, each input read once and
    each output written once."""
    if causal:
        pairs = sum(min(r + 1, sk) for r in range(sq))
    else:
        pairs = sq * sk
    pairs *= b * h
    q_b = b * sq * h * d * item
    kv_b = b * sk * kvh * d * item
    row_b = b * h * sq * 4                       # lse or delta, float32
    return pairs, dict(
        flash_fwd=(q_b + 2 * kv_b) + (q_b + row_b),
        flash_dq=(2 * q_b + 2 * kv_b + 2 * row_b) + q_b,
        flash_dkv=(2 * q_b + 2 * kv_b + 2 * row_b) + 2 * kv_b)


def check_flash_case(gen, dev, label, shape, causal, timed):
    """Each flash kernel against its plain version on one case; two
    launches must be bit-identical. With `timed`, also each kernel's,
    its plain version's and SDPA's times and the least-time bound."""
    from ray_tpu_torch.ops import attention as fa
    import torch.nn.functional as F
    b, sq, sk, h, kvh, d = shape
    q, k, v, do = flash_case(gen, dev, *shape)
    scale = d ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    delta = fa.flash_delta(out, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, scale)
    again = (fa.flash_forward(q, k, v, causal, scale)
             + (fa.flash_dq(q, k, v, do, lse, delta, causal, scale),)
             + fa.flash_dkv(q, k, v, do, lse, delta, causal, scale))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in
               zip((out, lse, dq, dk, dv), again))
    ref, lse_ref = fa.flash_forward_plain(q, k, v, causal, scale)
    # the backward's plain versions on the kernels' own residuals
    dq_ref = fa.flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal,
                                        scale)
    errs = {}
    for name, a, r in (("out", out, ref), ("dq", dq, dq_ref),
                       ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        e, ok = flash_err(a, r)
        errs[name] = e
        if not ok:
            raise AssertionError(f"flash {label}: {name} disagrees with "
                                 f"its plain version (max abs err {e})")
    lse_err = (lse - lse_ref).abs().max().item()
    log(f"[flash {label}] B,Sq,Sk,H,KVH,D={shape} causal={causal}: max abs "
        f"err out {errs['out']:.3e} dq {errs['dq']:.3e} dk {errs['dk']:.3e} "
        f"dv {errs['dv']:.3e} (rel {FLASH_REL} + {FLASH_ABS} of max); lse "
        f"{lse_err:.2e} (tol {LSE_TOL}); repeat launches bit-identical: "
        f"{same}")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash {label}: lse error {lse_err}")
    if not same:
        raise AssertionError(f"flash {label}: two launches differ")
    del ref, dq_ref, dk_ref, dv_ref, again
    res = dict(flash_fwd=dict(max_abs_err=max(errs["out"], lse_err)),
               flash_dq=dict(max_abs_err=errs["dq"]),
               flash_dkv=dict(max_abs_err=max(errs["dk"], errs["dv"])))
    if not timed:
        return res
    calls = dict(
        flash_fwd=lambda: fa.flash_forward(q, k, v, causal, scale),
        flash_dq=lambda: fa.flash_dq(q, k, v, do, lse, delta, causal, scale),
        flash_dkv=lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                       scale))
    ms = {name: time_ms(fn) for name, fn in calls.items()}
    dev = {name: device_ms(fn, (name,), calls=5)
           for name, fn in calls.items()}
    plain = dict(
        flash_fwd=time_ms(lambda: fa.flash_forward_plain(q, k, v, causal,
                                                         scale), iters=3),
        flash_dq=time_ms(lambda: fa.flash_dq_plain(q, k, v, do, lse, delta,
                                                   causal, scale), iters=3),
        flash_dkv=time_ms(lambda: fa.flash_dkv_plain(
            q, k, v, do, lse, delta, causal, scale), iters=3))
    # library yardstick: SDPA forward, and its autograd backward, which
    # gives dq, dk and dv in one call (so both backward rows carry it)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                        enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), dot, retain_graph=True))
    library = dict(flash_fwd=lib_fwd, flash_dq=lib_bwd, flash_dkv=lib_bwd)
    pairs, nbytes = flash_work(b, sq, sk, h, kvh, d, causal,
                               q.element_size())
    products = dict(flash_fwd=2, flash_dq=3, flash_dkv=4)
    for name in res:
        flops = 2 * d * pairs * products[name]
        b_ms, b_by = bound(nbytes[name], flops, q.dtype)
        res[name].update(ms=ms[name], plain_ms=plain[name],
                         library_ms=library[name], bound_ms=b_ms,
                         bound_by=b_by, device_ms=dev[name])
        log(f"[flash {label}] {name}: kernel {ms[name]:.4f} ms (device "
            f"{fmt_ms(dev[name])} ms), plain "
            f"{plain[name]:.4f} ms, sdpa {library[name]:.4f} ms "
            f"({'forward' if name == 'flash_fwd' else 'backward, dq+dk+dv'}"
            f"), bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, "
            f"{nbytes[name] / 1e6:.1f} MB); {flops / ms[name] / 1e9:.1f} "
            f"TFLOP/s of the function's work, {100 * b_ms / ms[name]:.1f}% "
            f"of the bound")
    return res


# Tensor-core kernels that must hold HGMMA in their SASS: (library, entry
# name, instances). Flash: bf16 at D 64 and 128; ragged: bf16, int8 and
# fp8 pages at D 64 and 128.
TC_KERNELS = [
    ("libflash_attention.so", "flash_fwd_tc_kernel", 2),
    ("libflash_attention.so", "flash_dq_tc_kernel", 2),
    ("libflash_attention.so", "flash_dkv_tc_kernel", 2),
    ("libragged_paged.so", "ragged_tc_kernel", 6),
]


def check_tensor_cores(info):
    """The tensor-core kernels (bf16 flash forward, dq and dk/dv; the
    ragged kernel for bf16 queries on bf16, int8 and fp8 pages) must run
    their products on the tensor cores: each instance must hold HGMMA
    instructions in the SASS of the built library (cuobjdump -sass).
    Prints each instance's HGMMA count and its ptxas register and spill
    lines."""
    from ray_tpu_torch.ops import _kernels
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    hgmma = {}
    for lib in sorted({lib for lib, _, _ in TC_KERNELS}):
        sass = subprocess.run([tool, "-sass", os.path.join(info["dir"], lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        hgmma[lib] = {}
        for chunk in sass.split("Function : ")[1:]:
            hgmma[lib][chunk.split("\n", 1)[0].strip()] = chunk.count("HGMMA")
    found = {}
    for lib, kern, n_inst in TC_KERNELS:
        ptxas = info["ptxas"].get(lib[3:-3] + ".cu", "")
        inst = {n: c for n, c in hgmma[lib].items() if kern in n}
        found[kern] = inst
        for n, c in inst.items():
            lines = ptxas_lines(ptxas, n)
            log(f"[tensor cores] {kern} instance {n[:72]}: {c} HGMMA; "
                f"ptxas: {' | '.join(lines)}")
        if len(inst) != n_inst or not all(inst.values()):
            raise AssertionError(f"{kern}: all {n_inst} instances must hold "
                                 f"HGMMA instructions: {inst}")
    others = sum(c for lib in hgmma for n, c in hgmma[lib].items()
                 if not any(k in n for _, k, _ in TC_KERNELS))
    log(f"[tensor cores] HGMMA outside the tensor-core kernels: {others}")
    return found


def ptxas_lines(text, entry):
    """ptxas -v's register and spill lines for one entry function."""
    out, on = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            on = f"'{entry}'" in line
        elif on and ("spill" in line or "Used" in line):
            out.append(line.strip())
    return out


def decode_ptxas(info):
    """ptxas -v's registers, spills and stack (local memory) of each
    instance of the pipelined decode kernel (bf16 queries; bf16, int8
    and fp8 pages x D 64, 128)."""
    import re
    text = info["ptxas"].get("paged_decode.cu", "")
    names = sorted(set(re.findall(
        r"Compiling entry function '([^']*paged_decode_pipe_kernel[^']*)'",
        text)))
    rows = {}
    for n in names:
        lines = " ".join(ptxas_lines(text, n))
        num = lambda pat: int((re.search(pat, lines) or [0, 0])[1])
        rows[n] = dict(registers=num(r"Used (\d+) registers"),
                       spill_stores=num(r"(\d+) bytes spill stores"),
                       spill_loads=num(r"(\d+) bytes spill loads"),
                       stack_bytes=num(r"(\d+) bytes stack frame"))
        log(f"[ptxas decode] {n[:80]}: {rows[n]}")
    return rows


def check_flash(gen, dev):
    """The three flash kernels on the main path's shape (timed), at 1b
    widths (timed too: half the head dim, the same number of scores),
    on a shape that cuts every tile unevenly and on a small non-causal
    Sq != Sk case. Returns the main case's numbers, max_abs_err the
    largest over the cases."""
    main = check_flash_case(gen, dev, "8b", (4, 2048, 2048, 32, 8, 128),
                            True, timed=True)
    for label, shape, causal, timed in (
            ("1b", (4, 2048, 2048, 32, 8, 64), True, True),
            ("uneven tiles", (2, 1000, 1000, 32, 8, 128), True, False),
            ("small non-causal", (2, 384, 640, 8, 2, 128), False, False)):
        other = check_flash_case(gen, dev, label, shape, causal, timed)
        for name in main:
            main[name]["max_abs_err"] = max(main[name]["max_abs_err"],
                                            other[name]["max_abs_err"])
    torch.cuda.empty_cache()
    return main


# ------------------------------------------------------------------ engine

PROMPT_TEXTS = [
    ("The history of paged attention begins with virtual memory. " * 26),
    ("Continuous batching keeps every slot of the batch busy. " * 12),
    ("A ragged batch packs decode rows and prefill chunks together. " * 5),
    "Hopper adds the tensor memory accelerator and warpgroup MMA.",
    "Hello, world!",
    ("Llama-3 uses grouped-query attention with eight kv heads. " * 2),
]


def drive(eng, prompts, max_tokens, tag, **sp):
    from ray_tpu_torch import Request, SamplingParams
    reqs = [Request(f"{tag}{i}", list(p),
                    SamplingParams(max_tokens=max_tokens, **sp))
            for i, p in enumerate(prompts)]
    for r in reqs[:3]:
        eng.add_request(r)
    tick_ms = []
    pending = reqs[3:]
    while eng.has_work() or pending:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if pending:
            eng.add_request(pending.pop(0))
    return [r.output_tokens for r in reqs], tick_ms


def teacher_logits(eng, tokens, lora=None):
    """Next-token logits after `tokens`, one fresh single-slot forward
    with the engine's weights and attention impl (and the adapter `lora`,
    its stacks and slot, when given)."""
    from ray_tpu_torch.models.llama_infer import ragged_forward
    cfg = eng.model_cfg
    dev = eng.device
    page = eng.config.page_size
    n = len(tokens)
    pages = -(-n // page)
    kv = (cfg.n_layers, pages + 1, page, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.zeros(kv, dtype=eng.k_pages.dtype, device=dev)
    vp = torch.zeros(kv, dtype=eng.k_pages.dtype, device=dev)
    scales = {}
    if eng.k_scales is not None:
        scales = dict(k_scales=torch.zeros(kv[:-1], device=dev),
                      v_scales=torch.zeros(kv[:-1], device=dev))
    i32 = dict(dtype=torch.int32, device=dev)
    if lora is not None:
        scales.update(lora=eng._lora_stacks, lora_idx=torch.full(
            (n,), eng._lora_names[lora], **i32))
    logits = ragged_forward(
        cfg, eng.params, torch.tensor(tokens, **i32),
        torch.zeros(n, **i32), torch.arange(n, **i32),
        torch.ones(n, dtype=torch.bool, device=dev), torch.zeros(1, **i32),
        torch.tensor([n - 1], **i32), kp, vp,
        torch.arange(pages, **i32)[None], ctx_pages=0, impl=eng.impl,
        max_seg_len=n, kv_kind=eng.kv_kind, **scales)[0]
    return logits[0]


ENGINE_KW = dict(model="8b", max_batch_size=8, page_size=16,
                 max_prefill_tokens=512, num_pages=1025, seed=0)


def run_engine(dev):
    from ray_tpu_torch import ByteTokenizer, EngineConfig, InferenceEngine
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    log(f"[engine] prompt lengths {[len(p) for p in prompts]}")
    kw = ENGINE_KW
    t0 = time.perf_counter()
    eng = InferenceEngine(EngineConfig(decode_impl="kernel", **kw))
    torch.cuda.synchronize()
    log(f"[engine] 8b init (random bf16 weights, seed 0) "
        f"{time.perf_counter() - t0:.1f} s; "
        f"params {sum(p.numel() for p in _leaves(eng.params)) / 1e9:.3f}B")
    # the default engine (a CUDA graph a decode tick, lagged readback) is
    # also phase 5c's graph side: greedy then sampled streams
    out_k, out_s, graph = serve_streams(eng, "f32", prompts, "graph f32")
    counts = graph["greedy"]["launches"]
    ticks_k = graph["greedy"]["ticks_ms"]
    prof = run_profile(eng, prompts)
    launch = decode_launch_ms(prof, "8b bf16")
    memory = full_table_memory(eng)
    # phase 5c's windows, and the graphs released before the next engine
    graph_side = (out_k, out_s, finish_graph_side(eng, graph, "graph f32"))
    geng = InferenceEngine(EngineConfig(decode_impl="gather", **kw),
                           params=eng.params)
    out_g, ticks_g = drive(geng, prompts, 16, "g")
    log(f"[engine gather] tick ms: median {statistics.median(ticks_g):.2f}")
    exact = compare_streams(eng, geng, prompts, out_k, out_g, "8b bf16")
    geng.release_graphs()
    del geng
    # strict parity at a small size: f32 model, tokens must match exactly
    small = dict(model="tiny", max_batch_size=4, page_size=16,
                 max_prefill_tokens=64, num_pages=129, seed=1)
    from ray_tpu_torch.models import llama
    cfg32 = llama.config("tiny", dtype=torch.float32)
    small["model"] = cfg32
    e1 = InferenceEngine(EngineConfig(decode_impl="kernel", **small))
    e2 = InferenceEngine(EngineConfig(decode_impl="gather", **small),
                         params=e1.params)
    sp = [p[:200] for p in prompts]
    s1, _ = drive(e1, sp, 12, "s")
    s2, _ = drive(e2, sp, 12, "s")
    compare_streams(e1, e2, sp, s1, s2, "tiny f32")
    return counts, dict(tick_ms_kernel=statistics.median(ticks_k),
                        tick_ms_gather=statistics.median(ticks_g),
                        ticks_ms_kernel=ticks_k, ticks_ms_gather=ticks_g,
                        exact=exact, profile=prof, memory=memory,
                        decode_launch_ms=launch,
                        pool_bytes=pool_bytes(eng)), \
        eng.params, out_k, graph_side


def check_decode_route(kernels, name, n):
    """Every decode launch of a bf16 engine at 8b shapes took the
    pipelined kernel (the launch counters by route)."""
    routes = kernels.route_counts().get(name, {})
    log(f"[engine] {name} launches by route: {routes}")
    if routes != {"pipelined": n}:
        raise AssertionError(f"{name}: {n} launches, routes {routes}: the "
                             f"pipelined kernel must take all of them")


def decode_launch_ms(prof, label):
    """Device ms a launch of the decode kernel and of its combine pass in
    the profiled decode ticks."""
    rows = prof["decode"]["serving"]
    main = [r for r in rows if "paged_decode" in r["name"]
            and "combine" not in r["name"]]
    n = max(sum(r["calls"] for r in main), 1)
    kern = sum(r["device_ms"] for r in main) / n
    comb = sum(r["device_ms"] for r in rows
               if "paged_decode_combine" in r["name"]) / n
    log(f"[engine {label}] decode launch {kern:.4f} + {comb:.4f} ms "
        f"(kernel + combine, device, profiled decode ticks)")
    return dict(kernel=kern, combine=comb)


def full_table_memory(eng):
    """Serving at the full table width: a 5200-token prompt (seeded
    random tokens) whose 512-token chunks pass start 4096, so their ticks
    sweep the 512-page context bucket, beside a request that decodes the
    whole time, so those ticks hold 513 tokens (the 1024-token bucket).
    That is the ragged kernel's key-chunk scratch at its largest for
    this engine, which must be what the run's ticks allocated. Returns
    the device memory held before the drive, its peak during it, and the
    largest scratch a tick allocated (bytes)."""
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.models import llama_infer
    from ray_tpu_torch.ops import ragged_paged_attention as rpa
    cfg, ec = eng.model_cfg, eng.config
    gen = torch.Generator().manual_seed(5200)
    long_p = torch.randint(1000, 100000, (5200,), generator=gen).tolist()
    short_p = torch.randint(1000, 100000, (24,), generator=gen).tolist()
    reqs = [Request("mem-short", short_p, SamplingParams(max_tokens=24)),
            Request("mem-long", long_p, SamplingParams(max_tokens=2))]
    sizes = []
    own = llama_infer.ragged_scratch

    def recording(*a, **k):
        buf = own(*a, **k)
        sizes.append(0 if buf is None else buf.numel() * 4)
        return buf

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    llama_infer.ragged_scratch = recording
    try:
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
    finally:
        llama_infer.ragged_scratch = own
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for r, n in zip(reqs, (24, 2)):
        if len(r.output_tokens) != n:
            raise AssertionError(f"{r.request_id}: {r.output_tokens}")
    n_chunks = rpa.tc_geometry(1024, ec.max_batch_size,
                               cfg.n_heads // cfg.n_kv_heads,
                               ec.max_prefill_tokens, eng.max_pages_per_seq,
                               ec.page_size)[2]
    want = rpa.scratch_numel(1024, cfg.n_heads, cfg.head_dim, n_chunks) * 4
    if max(sizes) != want:
        raise AssertionError(f"largest scratch {max(sizes)} B, the "
                             f"full-table bucket's is {want} B")
    log(f"[engine memory] full-table ticks ({len(sizes)} ragged): held "
        f"before {base / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB "
        f"(+{(peak - base) / 2**20:.1f} MiB); largest key-chunk scratch "
        f"{max(sizes) / 2**20:.1f} MiB ({n_chunks} chunks, T=1024)")
    return dict(base_bytes=base, peak_bytes=peak, scratch_bytes=max(sizes),
                n_chunks=n_chunks)


def pool_bytes(eng):
    """Device bytes of the engine's KV pools, scale pools included."""
    ts = [eng.k_pages, eng.v_pages]
    if eng.k_scales is not None:
        ts += [eng.k_scales, eng.v_scales]
    return sum(t.numel() * t.element_size() for t in ts)


def agreement(out_q, out_ref):
    """Share of equal greedy tokens (position by position) and each
    request's first divergence (None where identical)."""
    same = sum(a == b for x, y in zip(out_q, out_ref) for a, b in zip(x, y))
    total = sum(len(x) for x in out_ref)
    first = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(out_q, out_ref)]
    return same / total, first


def run_quant_engine(dev, kind, params, out_bf16):
    """The 8b engine on `kind` (int8/fp8) KV pages at full depth, with the
    bf16 phase's weights: the kind's kernels on the main path (counters
    equal layers x ticks, the bf16 counters untouched), kernel vs gather
    greedy streams (near ties allowed, as in the bf16 phase), and a small
    f32 engine on the same pages token-exact between the impls. The
    engine is the default one, and so also phase 5c's graph side."""
    from ray_tpu_torch import ByteTokenizer, EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    kw = dict(ENGINE_KW, kv_dtype=kind)
    eng = InferenceEngine(EngineConfig(decode_impl="kernel", **kw),
                          params=params)
    out_k, out_s, graph = serve_streams(eng, kind, prompts, f"graph {kind}")
    counts = graph["greedy"]["launches"]
    ticks_k = graph["greedy"]["ticks_ms"]
    share, first = agreement(out_k, out_bf16)
    nbytes = pool_bytes(eng)
    log(f"[engine {kind}] greedy agreement with the bf16-pool engine "
        f"{share:.3f}, first divergence per request {first}; pools "
        f"{nbytes / 2**30:.3f} GiB (scales included), "
        f"{eng.stats()['kv_page_bytes']} bytes a page")
    prof = run_profile(eng, prompts)
    launch = decode_launch_ms(prof, f"8b {kind}")
    graph_side = (out_k, out_s, finish_graph_side(eng, graph,
                                                  f"graph {kind}"))
    geng = InferenceEngine(EngineConfig(decode_impl="gather", **kw),
                           params=params)
    out_g, ticks_g = drive(geng, prompts, 16, f"{kind}g")
    log(f"[engine {kind} gather] tick ms: median "
        f"{statistics.median(ticks_g):.2f}")
    margin = NEAR_TIE_FP8 if kind == "fp8" else NEAR_TIE
    exact = compare_streams(eng, geng, prompts, out_k, out_g, f"8b {kind}",
                            margin)
    geng.release_graphs()
    del geng
    # a small f32 engine on the same kind of pages: kernel and gather
    # token-exact on int8 pages, within the near tie on fp8 pages
    small = dict(model=llama.config("tiny", dtype=torch.float32),
                 max_batch_size=4, page_size=16, max_prefill_tokens=64,
                 num_pages=129, seed=1, kv_dtype=kind)
    e1 = InferenceEngine(EngineConfig(decode_impl="kernel", **small))
    e2 = InferenceEngine(EngineConfig(decode_impl="gather", **small),
                         params=e1.params)
    sp = [p[:200] for p in prompts]
    s1, _ = drive(e1, sp, 12, "s")
    s2, _ = drive(e2, sp, 12, "s")
    if not compare_streams(e1, e2, sp, s1, s2, f"tiny f32 {kind}",
                           margin) and kind == "int8":
        raise AssertionError(f"tiny f32 {kind}: kernel and gather engines "
                             f"are not token-exact")
    return counts, dict(tick_ms_kernel=statistics.median(ticks_k),
                        tick_ms_gather=statistics.median(ticks_g),
                        ticks_ms_kernel=ticks_k, exact=exact,
                        bf16_agreement=share, first_divergence=first,
                        pool_bytes=nbytes,
                        page_bytes=eng.stats()["kv_page_bytes"],
                        decode_launch_ms=launch, profile=prof), graph_side


def compare_streams(eng_k, eng_g, prompts, out_k, out_g, label,
                    margin=NEAR_TIE, names=("kernel", "gather"),
                    loras=None):
    """Greedy streams of two engines (by default the kernel and gather
    engines; `names` says which) must be identical, or first differ
    where the two candidates' logits lie within the near-tie margin
    (the teacher-forced logits at the divergence point are printed for
    both engines; every divergence is printed before a failure is
    raised; `loras`: each request's adapter, for those logits). Returns
    whether all were identical."""
    nk, ng = names
    exact = out_k == out_g
    log(f"[engine {label}] {nk} vs {ng} greedy streams identical: {exact}")
    beyond = []
    for i, (a, b) in enumerate(zip(out_k, out_g)):
        if a == b:
            continue
        j = next(j for j in range(len(a)) if a[j] != b[j])
        ctx = prompts[i] + a[:j]
        lora = loras[i] if loras else None
        lk = teacher_logits(eng_k, ctx, lora)
        lg = teacher_logits(eng_g, ctx, lora)
        top = lg.topk(2)
        gap = abs(lg[a[j]].item() - lg[b[j]].item())
        log(f"[engine {label}] request {i} diverges at output {j}: {nk} "
            f"token {a[j]}, {ng} token {b[j]}; {ng} top2 "
            f"{top.indices.tolist()} {top.values.tolist()}; {nk} top2 "
            f"{lk.topk(2).indices.tolist()} {lk.topk(2).values.tolist()}; "
            f"gap {gap:.4f} (near-tie margin {margin:.4f})")
        if gap > margin:
            beyond.append(i)
    if beyond:
        raise AssertionError(f"{label} requests {beyond}: {nk} and {ng} "
                             f"engines differ beyond a near tie")
    return exact


def profiler_check(seconds=75.0, n=10):
    """How often a torch.profiler session loses kernel records, by how
    the session opens: "none" (the work right after the start), "idle"
    (20 ms of host idle first), "lead" (util/profiling's lead_in and
    settle around the work). Every ~3 s (bf16 matmuls in between, so
    the process ages under load) one session a mode, each over `n` spin
    kernels of ~20 us; a session is short when the trace lacks a kernel
    whose launch call it holds. Returns {mode: {sessions, short, lost
    launch indices}}; run it with TEARDOWN_CUPTI=0 in the environment to
    keep CUPTI up between sessions."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.util import profiling
    tmp = tempfile.mkdtemp()
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    out = {m: dict(sessions=0, short=0, lost=[]) for m in
           ("none", "idle", "lead")}
    t0 = time.time()
    while time.time() - t0 < seconds:
        for mode, res in out.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if mode == "idle":
                    time.sleep(0.02)
                elif mode == "lead":
                    profiling.lead_in()
                for _ in range(n):
                    torch.cuda._sleep(40_000)
                if mode == "lead":
                    profiling.settle()
                else:
                    torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                evs = json.load(f)["traceEvents"]
            kern = {e["args"].get("correlation") for e in evs
                    if e.get("cat") == "kernel" and "spin" in e["name"]}
            calls = sorted((e for e in evs if e.get("cat") == "cuda_runtime"
                            and "LaunchKernel" in e["name"]),
                           key=lambda e: e["ts"])[-n:]
            lost = [i for i, e in enumerate(calls)
                    if e["args"].get("correlation") not in kern]
            res["sessions"] += 1
            if lost:
                res["short"] += 1
                res["lost"].append((round(time.time() - t0, 1), lost))
        t1 = time.time()
        while time.time() - t1 < 2.0:
            for _ in range(50):
                x @ x
            torch.cuda.synchronize()
    log(f"[profiler check] TEARDOWN_CUPTI="
        f"{os.environ.get('TEARDOWN_CUPTI', 'unset')}: " + "; ".join(
            f"{m} {r['short']} of {r['sessions']} sessions short"
            for m, r in out.items()))
    return out


# kernel name part -> the launch counters that count its launches
RECORDED = (("ragged", "ragged_paged"), ("paged_decode", "paged_decode"),
            ("flash_fwd", "flash_fwd"), ("flash_dq", "flash_dq"),
            ("flash_dkv", "flash_dkv"), ("row_gumbel", "row_gumbel"))


def lost_records(evs, before):
    """Each hand-written kernel's launches in a profile's rows against
    the launch counters' moves since `before` (combine passes apart):
    {kernel: (recorded, counted)} where they differ."""
    from ray_tpu_torch.ops import _kernels
    after = _kernels.launch_counts()
    out = {}
    for key, counter in RECORDED:
        got = sum(e.count for e in evs
                  if key in e.key and "combine" not in e.key)
        want = sum(after[k] - before[k] for k in after
                   if k.startswith(counter))
        if got != want:
            out[key] = (got, want)
    return out


# profile windows this run, and those that lost a record
PROFILES = dict(windows=0, lost=0)
PROFILE_ATTEMPTS = 3


def profiled(window, label, host=False, check=None):
    """traced(window) with a check of the records: by default every
    hand-written kernel's launches against the launch counters
    (lost_records); `check(evs)` returns what is missing instead. A
    profile that lost records is taken again over the next call of
    `window` (equivalent work: more steady ticks, another train step,
    the same kernel calls), at most PROFILE_ATTEMPTS windows; then the
    run fails. Every loss is printed (ROADMAP §C: the profiler at times
    loses a whole session)."""
    from ray_tpu_torch.ops import _kernels
    for attempt in range(PROFILE_ATTEMPTS):
        before = _kernels.launch_counts()
        prof, wall = traced(window, host=host)
        evs = device_events(prof)
        lost = check(evs) if check else lost_records(evs, before)
        PROFILES["windows"] += 1
        if not lost:
            return prof, wall
        PROFILES["lost"] += 1
        log(f"[profiler] {label}: the profile lost records {lost} "
            f"(window {attempt + 1} of {PROFILE_ATTEMPTS})")
    raise AssertionError(f"{label}: {PROFILE_ATTEMPTS} profiles lost "
                         f"records")


def kernel_groups(evs):
    """The profiler's kernel rows by group: {group: {ms, launches}}."""
    groups = {}
    for e in evs:
        key = e.key.lower()
        g = ("flash kernels" if "flash_" in key else
             "serving attention" if ("ragged" in key
                                     or "paged_decode" in key) else
             "noise kernel" if "row_gumbel" in key else
             "float32 matmuls" if "sgemm" in key else
             "matmuls" if ("nvjet" in key or "gemm" in key
                           or "cutlass" in key) else
             "copies and casts" if "copy" in key else
             "reductions" if "reduce" in key else
             "elementwise" if "elementwise" in key else "other")
        r = groups.setdefault(g, dict(ms=0.0, launches=0))
        r["ms"] += dev_us(e) / 1e3
        r["launches"] += e.count
    return groups


def profile_ticks(eng, prompts, n_ticks, label):
    """torch.profiler over `n_ticks` engine steps: the kernels with the
    most device time, and device time against wall time. The serving
    kernels' launches in the profile must equal the launch counters'."""
    prof, wall = profiled(lambda: repeat(eng.step, n_ticks),
                          f"profile {label}")
    evs = device_events(prof)
    total = sum(dev_us(e) for e in evs) / 1e3
    top = sorted(evs, key=dev_us, reverse=True)[:10]
    log(f"[profile {label}] {n_ticks} ticks: kernels busy {total:.2f} ms "
        f"on the device ({total / n_ticks:.2f} ms a tick); wall under the "
        f"profiler {wall:.2f} ms")
    groups = kernel_groups(evs)
    for g, r in sorted(groups.items(), key=lambda x: -x[1]["ms"]):
        log(f"[profile {label}] {g:18s} {r['ms'] / n_ticks:8.3f} ms a tick "
            f"in {r['launches'] / n_ticks:6.1f} launches "
            f"({100 * r['ms'] / total:.1f}%)")
    rows = []
    for e in top:
        rows.append(dict(name=e.key[:90], device_ms=dev_us(e) / 1e3,
                         calls=e.count))
        log(f"[profile {label}]   {dev_us(e) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    # the serving attention kernels, whether or not they made the top 10
    serving = []
    for e in sorted(evs, key=lambda e: e.key):
        if "ragged" in e.key or "paged_decode" in e.key:
            serving.append(dict(name=e.key[:90], device_ms=dev_us(e) / 1e3,
                                calls=e.count))
            log(f"[profile {label}] serving kernel {e.key[:60]}: "
                f"{dev_us(e) / 1e3:.3f} ms over {e.count} launches, "
                f"{dev_us(e) / 1e3 / e.count:.4f} ms a launch")
    return dict(ticks=n_ticks, profiled_wall_ms=wall, device_ms=total,
                top=rows, serving=serving, groups=groups)


def run_profile(eng, prompts):
    """Profile mixed ticks (prefill chunks riding with decode rows), then
    pure-decode ticks, of the kernel engine on fresh requests."""
    from ray_tpu_torch import Request, SamplingParams
    for i, p in enumerate(prompts):
        # a fresh first token per prompt: no prefix-cache hit, so the
        # prompts prefill in full and the first ticks are mixed ticks
        eng.add_request(Request(f"prof{i}", [200 + i] + list(p),
                                SamplingParams(max_tokens=64)))
    mixed = profile_ticks(eng, prompts, 3, "mixed ticks")
    while any(s.request is not None and not s.ready for s in eng.slots):
        eng.step()
    decode = profile_ticks(eng, prompts, 8, "decode ticks")
    walls = []
    for _ in range(8):                  # the same ticks, unprofiled
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    busy = decode["device_ms"] / decode["ticks"]
    decode.update(tick_wall_ms=wall, idle_share=max(0.0, 1 - busy / wall))
    log(f"[profile decode ticks] unprofiled tick {wall:.2f} ms, kernels "
        f"{busy:.2f} ms: device idle {100 * decode['idle_share']:.1f}%")
    while eng.has_work():
        eng.step()
    return dict(mixed=mixed, decode=decode)


# ------------------------------------------------- decode tick mechanics

SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=50)
STEADY_TICKS = 16       # unprofiled steady decode ticks timed per engine
PROFILED_TICKS = 8
GUARD_TICKS = 16
GUMBEL_TOL = 2.0 ** -22  # |kernel - plain| <= this * max(1, |g|): each
#                          side's logf lies within an ulp of the true
#                          value (tests/test_torch_threefry.py)


def check_noise(dev, b=8, vocab=128256):
    """The noise kernel against its plain version at the engine's
    sampling shape: bits and uniforms bit-equal, Gumbel values within
    GUMBEL_TOL; its time, device time, the plain version's and the
    bound (the B x V float32 values written)."""
    from ray_tpu_torch.ops import threefry as tf
    gen = torch.Generator().manual_seed(4242)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen,
                          dtype=torch.int32).to(dev)
    index = torch.randint(0, 4096, (b,), generator=gen,
                          dtype=torch.int32).to(dev)
    got = {st: tf.row_noise(seeds, index, vocab, st) for st in tf.STAGES}
    want = {st: tf.row_noise_plain(seeds, index, vocab, st)
            for st in tf.STAGES}
    torch.cuda.synchronize()
    bits_eq = torch.equal(got["bits"], want["bits"])
    uni_eq = torch.equal(got["uniform"].view(torch.int32),
                         want["uniform"].view(torch.int32))
    g, w = got["gumbel"], want["gumbel"]
    err = (g - w).abs().max().item()
    within = bool(((g - w).abs() <= GUMBEL_TOL * w.abs().clamp(min=1.0))
                  .all().item())
    same = (g == w).float().mean().item()
    log(f"[noise] B={b} V={vocab}: bits bit-equal {bits_eq}, uniforms "
        f"bit-equal {uni_eq}, gumbel max abs err {err:.3e} within "
        f"2^-22*max(1,|g|) {within} ({100 * same:.2f}% bit-equal)")
    if not (bits_eq and uni_eq and within and torch.isfinite(g).all()):
        raise AssertionError("noise kernel disagrees with its plain version")
    call = lambda: tf.row_gumbel(seeds, index, vocab)
    ms = time_ms(call)
    dev_ms = device_ms(call, ("row_gumbel",))
    # the launch as the decode graph runs it: 20 launches captured in
    # one graph, replayed back to back (no host work between them)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            call()
    graph_ms = time_ms(graph.replay) / 20
    plain_ms = time_ms(lambda: tf.row_noise_plain(seeds, index, vocab),
                       iters=5)
    b_ms, b_by = bound(b * vocab * 4 + 2 * b * 4, 0, torch.float32)
    log(f"[noise] kernel {ms:.4f} ms (device {fmt_ms(dev_ms)} ms in the "
        f"profiler; {graph_ms:.4f} ms a launch replayed in a graph), "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, device_ms=dev_ms,
                graph_ms=graph_ms, gumbel_bit_equal_share=same)


def steady_decode(eng, label, guard):
    """A full batch of greedy requests in steady decode: the unprofiled
    tick median over STEADY_TICKS (step() and a synchronise), kernels
    busy and device idle over PROFILED_TICKS profiled ticks, then (the
    default engine) GUARD_TICKS ticks under dispatch_guard inside a
    profile: no upload, no capture, one readback a tick, no Memcpy HtoD,
    one graph launch a tick. Then the same batch sampled, timed."""
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    gen = torch.Generator().manual_seed(77)
    B = eng.config.max_batch_size
    # room for the mixed ticks of the prefill: no request may finish
    # inside the timed, profiled or guarded windows
    n_tok = STEADY_TICKS + (PROFILED_TICKS + GUARD_TICKS) \
        * PROFILE_ATTEMPTS + 24
    out = {}
    for mode, sp in (("greedy", {}), ("sampled", SAMPLED)):
        for i in range(B):
            eng.add_request(Request(
                f"steady-{mode}{i}",
                torch.randint(1000, 100000, (40 + 61 * i,),
                              generator=gen).tolist(),
                SamplingParams(max_tokens=n_tok, seed=900 + i, **sp)))
        while eng.waiting or any(s.request is not None and not s.ready
                                 for s in eng.slots):
            eng.step()
        for _ in range(3):                 # first decode ticks: capture
            eng.step()

        walls = []
        for _ in range(STEADY_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        res = dict(tick_ms=wall, ticks_ms=walls)
        if mode == "greedy":
            prof, _ = profiled(lambda: repeat(eng.step, PROFILED_TICKS),
                               f"ticks {label} profile")
            busy = sum(dev_us(e) for e in device_events(prof)) / 1e3 \
                / PROFILED_TICKS
            res.update(busy_ms=busy, idle_share=max(0.0, 1 - busy / wall))
            log(f"[ticks {label}] greedy decode tick median {wall:.2f} ms "
                f"over {STEADY_TICKS} (unprofiled; all "
                f"{[round(x, 2) for x in walls]}); kernels busy "
                f"{busy:.2f} ms a tick over {PROFILED_TICKS} profiled "
                f"ticks: device idle {100 * res['idle_share']:.1f}%")
            if guard:
                res["guard"] = guarded_window(eng, label, dispatch_guard)
        else:
            log(f"[ticks {label}] sampled decode tick median {wall:.2f} ms "
                f"over {STEADY_TICKS} (unprofiled; all "
                f"{[round(x, 2) for x in walls]})")
        out[mode] = res
        for s in eng.slots:
            if s.request is not None:
                eng.abort(s.request.request_id)
        while eng.has_work():
            eng.step()
    return out


def guarded_window(eng, label, dispatch_guard, n=GUARD_TICKS):
    """n steady steps (decode ticks, or multi-step rounds) under
    dispatch_guard inside a profile: no upload, no capture, one readback,
    one cudaGraphLaunch and no Memcpy HtoD a step."""
    captures = eng.graph_captures
    reports = []

    def window():
        with dispatch_guard(engine=eng) as report:
            for _ in range(n):
                eng.step()
        reports.append(report)
    prof, _ = profiled(window, f"ticks {label} guard", host=True)
    report = reports[-1]
    rows = prof.key_averages()
    htod = sum(e.count for e in rows if "Memcpy HtoD" in e.key)
    launches = sum(e.count for e in rows if "cudaGraphLaunch" in e.key)
    log(f"[ticks {label}] {n} steps under dispatch_guard: "
        f"uploads {len(report.uploads)}, captures {len(report.captures)}, "
        f"readbacks {report.readbacks}; profiler: Memcpy HtoD {htod}, "
        f"cudaGraphLaunch {launches}")
    if any(r.uploads or r.captures for r in reports) or htod \
            or report.readbacks != n \
            or launches != n or eng.graph_captures != captures:
        raise AssertionError(f"{label}: a steady decode tick is not one "
                             f"graph launch with no upload")
    return dict(uploads=len(report.uploads), captures=len(report.captures),
                readbacks=report.readbacks, memcpy_htod=htod,
                graph_launches=launches)


def serve_streams(eng, kind, prompts, label):
    """A fresh engine's first work: the warm-up request, then the 6
    prompts greedy and then sampled (SAMPLED; seeds from the request
    ids), 16 tokens each. In each drive the kind's serving counters
    equal layers x ticks, every decode launch takes the pipelined route,
    the other serving counters stay 0, and row_gumbel launches in the
    sampled drive only. Returns (greedy out, sampled out, numbers); the
    numbers hold the peak memory above the engine as built, over this
    work."""
    from ray_tpu_torch import SamplingParams
    from ray_tpu_torch.ops import _kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # warm-up on a throwaway request so the timed run excludes one-time
    # costs (kernel load, allocator growth)
    eng.generate([prompts[4]], SamplingParams(max_tokens=2))
    suffix = "" if kind == "f32" else f"_{kind}"
    n_layers = eng.model_cfg.n_layers
    res, outs = {}, []
    for mode, sp in (("greedy", {}), ("sampled", SAMPLED)):
        _kernels.reset_launch_counts()
        r0, d0 = eng.ragged_ticks, eng.decode_ticks
        out, ticks = drive(eng, prompts, 16, f"t{kind}{mode}", **sp)
        counts = _kernels.launch_counts()
        nr, nd = eng.ragged_ticks - r0, eng.decode_ticks - d0
        decode = f"paged_decode{suffix}"
        want = {f"ragged_paged{suffix}": n_layers * nr, decode: n_layers * nd}
        log(f"[ticks {label}] {mode}: {nr} mixed and {nd} decode ticks, launches "
            f"{ {k: n for k, n in counts.items() if n} }; tick median "
            f"{statistics.median(ticks):.2f} ms, all "
            f"{[round(x, 2) for x in ticks]}")
        for name, n in counts.items():
            if name != "row_gumbel" and n != want.get(name, 0):
                raise AssertionError(f"{label}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
        if min(want.values()) <= 0:
            raise AssertionError(f"{label}: a serving kernel never ran")
        if (mode == "sampled") != (counts["row_gumbel"] > 0):
            raise AssertionError(f"{label}: row_gumbel {counts['row_gumbel']}"
                                 f" launches in {mode} streams")
        check_decode_route(_kernels, decode, want[decode])
        for o in out:
            if len(o) != 16 or not all(0 <= t < 128256 for t in o):
                raise AssertionError(f"bad output stream {o}")
        outs.append(out)
        res[mode] = dict(launches=counts, ticks_ms=ticks)
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    log(f"[ticks {label}] peak memory above the engine as built, over the "
        f"warm-up and both drives: {res['peak_bytes'] / 2**30:.3f} GiB")
    return outs[0], outs[1], res


def finish_graph_side(eng, res, label):
    """Phase 5c on a default engine that phase 5 or 5b has used: the
    steady windows with the guarded one; then its graphs are released."""
    res["steady"] = steady_decode(eng, label, guard=True)
    st = eng.stats()
    res.update(graph_captures=st["graph_captures"],
               lagged_ticks=st["lagged_ticks"], drains=st["drains"])
    log(f"[ticks {label}] graph captures {st['graph_captures']}, lagged ticks "
        f"{st['lagged_ticks']}, drains {st['drains']}")
    eng.release_graphs()
    return res


def eager_engine(kind, params, prompts):
    """Phase 5c's other side: cuda_graph=False, async_readback=False (the
    eager, synchronous path) on the default engine's weights, with the
    same work as phases 5 and 5b gave the default engine first."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    gc.collect()
    torch.cuda.empty_cache()
    eng = InferenceEngine(EngineConfig(
        decode_impl="kernel", kv_dtype=kind, cuda_graph=False,
        async_readback=False, **ENGINE_KW), params=params)
    label = f"eager {kind}"
    greedy, sampled, res = serve_streams(eng, kind, prompts, label)
    res["steady"] = steady_decode(eng, label, guard=False)
    if eng.stats()["graph_captures"]:
        raise AssertionError(f"{label}: the eager engine captured a graph")
    del eng
    return greedy, sampled, res


def run_tick_mechanics(dev, params, graph_sides):
    """Phase 5c: the decode tick's mechanics at 8b, full depth, on bf16,
    int8 and fp8 pages with the bf16 phase's weights: the default
    engines of phases 5 and 5b (one CUDA graph a decode tick, lagged
    readback; `graph_sides`) against cuda_graph=False,
    async_readback=False; token-exact greedy and sampled streams, honest
    launch counters, steady tick times and idle shares of both, a
    guarded window of the default engine, peak memory of each. Returns
    the numbers."""
    from ray_tpu_torch import ByteTokenizer
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    out = {}
    for kind in ("f32", "int8", "fp8"):
        eager = eager_engine(kind, params, prompts)
        graph = graph_sides[kind]
        for i, mode in enumerate(("greedy", "sampled")):
            if graph[i] != eager[i]:
                raise AssertionError(f"{kind} pages: {mode} streams of the "
                                     f"graph and eager engines differ")
        log(f"[ticks {kind}] graph vs eager: greedy and sampled streams "
            f"token-exact")
        out[kind] = dict(eager=eager[2], graph=graph[2])
    return out


# --------------------------------------------------- KV hierarchy (5d)

OVERSUB_N = 16           # seeded prompts of 240-720 tokens
OVERSUB_TOKENS = 96      # output tokens each: up to 51 pages a request
# a token budget that holds a full 512-token chunk for every slot: each
# prompt is chunked at the same offsets in every engine, whatever else
# shares its ticks (on int8/fp8 pages a token reads the keys of its own
# chunk unquantized, so other chunk offsets would be other numbers)
KV_KW = dict(ENGINE_KW, max_num_batched_tokens=8 * 512 + 8)
# 128 usable pages, under half of what 8 resident requests want (~290,
# up to 408); optimistic admission reserves prompt + 32 tokens
OVERSUB_KW = dict(KV_KW, num_pages=129, enable_kv_offload=True,
                  kv_watermark_tokens=32)
MOVE_PAGES = (8, 48)     # page counts of the timed spills and restores
MOVE_ITERS = 5


def kind_label(kind):
    return "bf16" if kind == "f32" else kind


def oversub_requests(tag, sp):
    """The oversubscription workload: the same prompts and per-request
    seeds in every run (request ids differ by `tag`)."""
    from ray_tpu_torch import Request, SamplingParams
    gen = torch.Generator().manual_seed(5151)
    lens = torch.randint(240, 721, (OVERSUB_N,), generator=gen).tolist()
    return [Request(f"{tag}{i}",
                    torch.randint(1000, 100000, (n,), generator=gen).tolist(),
                    SamplingParams(max_tokens=OVERSUB_TOKENS, seed=700 + i,
                                   **sp))
            for i, n in enumerate(lens)]


def serve_all(eng, reqs):
    """Every request added at once, then step() until done (the prefix
    cache cleared first, so earlier runs give no hits). Returns the
    wall seconds (to a synchronise) and the peaks of parked requests
    and page pressure over the ticks."""
    eng.allocator.clear_cache()
    for r in reqs:
        eng.add_request(r)
    parked = pressure = 0
    steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        steps += 1
        parked = max(parked, len(eng.parked))
        pressure = max(pressure, eng.page_pressure())
        if steps > 20000:
            raise AssertionError("the engine did not finish the workload")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, parked, pressure


def sampler_kept(logits, p):
    """The engine sampler's top-k/top-p filter (`_sample`) on one row:
    a bool mask over the vocabulary."""
    scaled = logits / p.temperature
    order = torch.argsort(-scaled, stable=True)
    sl = scaled[order]
    if p.top_k > 0:
        rank = torch.arange(sl.numel(), device=sl.device)
        sl = torch.where(rank >= p.top_k, torch.full_like(sl, -math.inf), sl)
    probs = torch.softmax(sl, dim=-1)
    keep = ((torch.cumsum(probs, dim=-1) - probs) < p.top_p) \
        & torch.isfinite(sl)
    return torch.zeros_like(keep).scatter(0, order, keep)


def pickable(logits, noise, tok, p, margin):
    """Could the sampler pick `tok` from some logits within `margin` of
    these (each entry moved by at most margin)? It must pass the filter
    with its logit raised and all others lowered, and every kept rival
    whose score (logit / temperature + noise) beats its own by more than
    2 x margin / temperature must drop out of the filter with its logit
    lowered and all others raised (rivals checked one at a time)."""
    up = logits - margin
    up[tok] = logits[tok] + margin
    if not bool(sampler_kept(up, p)[tok]):
        return False
    score = logits / p.temperature + noise
    rivals = sampler_kept(logits, p) \
        & (score > score[tok] + 2 * margin / p.temperature)
    for c in torch.nonzero(rivals).flatten().tolist():
        down = logits + margin
        down[c] = logits[c] - margin
        if bool(sampler_kept(down, p)[c]):
            return False
    return True


def compare_sampled(eng_o, eng_a, reqs_o, reqs_a, label, margin):
    """Sampled streams of an engine against a reference engine's, same
    prompts and seeds: identical, or first differing at a near tie of
    the sampler: at the first divergence, under the reference engine's
    teacher-forced logits (as in compare_streams) and the request's own
    noise, each of the two tokens is `pickable` within `margin` (with a
    random model the top-k/top-p edge runs through near-equal logits, so
    most such ties are a token at the edge). Every divergence is printed
    before a failure is raised. Returns whether all were identical."""
    from ray_tpu_torch.ops.threefry import row_gumbel
    dev = eng_a.device
    i32 = dict(dtype=torch.int32, device=dev)
    beyond, n_div = [], 0
    for ro, ra in zip(reqs_o, reqs_a):
        a, b = ro.output_tokens, ra.output_tokens
        if a == b:
            continue
        n_div += 1
        j = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        p = ra.params
        lg = teacher_logits(eng_a, ra.prompt_tokens + b[:j],
                            ra.lora).float()
        g = row_gumbel(torch.tensor([p.seed], **i32),
                       torch.tensor([len(ra.prompt_tokens) + j], **i32),
                       lg.numel())[0]
        kept = sampler_kept(lg, p)
        picks = {t: pickable(lg, g, t, p, margin) for t in (a[j], b[j])}
        tie = all(picks.values())
        log(f"[kv {label}] {ro.request_id} diverges at output {j}: token "
            f"{a[j]} against {b[j]}; teacher logits {lg[a[j]].item():.4f} / "
            f"{lg[b[j]].item():.4f}, kept {bool(kept[a[j]])} / "
            f"{bool(kept[b[j]])} of {int(kept.sum())}; each pickable within "
            f"{margin}: {picks}; near tie {tie}")
        if not tie:
            beyond.append(ro.request_id)
    if beyond:
        raise AssertionError(f"{label}: sampled streams differ beyond a "
                             f"near tie: {beyond}")
    return n_div == 0


def oversubscribe(eng, ample, kind, modes):
    """The workload on the 128-page engine and on the ample one, per
    sampling mode: every request finishes with "length"; at least one
    spill, one growth or requeue preemption and one restore; the tier
    empty at the end; the kind's serving kernels launched; tokens equal
    to the ample engine's or differing at a near tie. Returns each
    run's numbers."""
    from ray_tpu_torch import SamplingParams
    from ray_tpu_torch.ops import _kernels
    label = kind_label(kind)
    suffix = "" if kind == "f32" else f"_{kind}"
    margin = NEAR_TIE_FP8 if kind == "fp8" else NEAR_TIE
    tier = eng.host_tier
    runs = {}
    for mode, sp in modes:
        for e in (ample, eng):     # this mode's graph captured untimed
            e.generate([[1000 + i for i in range(40)]],
                       SamplingParams(max_tokens=4, seed=1, **sp))
        reqs_a = oversub_requests(f"ample-{kind}-{mode}-", sp)
        wall_a, _, _ = serve_all(ample, reqs_a)
        reqs = oversub_requests(f"over-{kind}-{mode}-", sp)
        pre0 = dict(eng.preempt_counts)
        sp0, rs0 = tier.spills_total, tier.restores_total
        _kernels.reset_launch_counts()
        wall, parked, pressure = serve_all(eng, reqs)
        counts = _kernels.launch_counts()
        pre = {k: n - pre0.get(k, 0) for k, n in eng.preempt_counts.items()
               if n - pre0.get(k, 0)}
        spills = tier.spills_total - sp0
        restores = tier.restores_total - rs0
        requeues = sum(pre.values()) - spills
        n_out = sum(len(r.output_tokens) for r in reqs)
        tps, tps_a = n_out / wall, n_out / wall_a
        log(f"[kv {label} {mode}] 128 pages: {wall:.2f} s, {tps:.1f} output "
            f"tokens/s; ample (1024 pages) {wall_a:.2f} s, {tps_a:.1f} "
            f"tokens/s ({tps / tps_a:.2f}x); preemptions {pre}, spills "
            f"{spills}, restores {restores}; peak parked {parked}, peak "
            f"page pressure {pressure:.3f}; launches "
            f"{ {k: n for k, n in counts.items() if n} }; requeued "
            f"{requeues}")
        bad = [r.request_id for r in reqs
               if r.finish_reason != "length"
               or len(r.output_tokens) != OVERSUB_TOKENS]
        if bad:
            raise AssertionError(f"{label} {mode}: unfinished {bad}")
        if spills < 1 or restores < 1 or pre.get("growth", 0) < 1:
            raise AssertionError(f"{label} {mode}: the pool never ran short "
                                 f"(preemptions {pre}, spills {spills})")
        if len(tier) or tier.used_pages or tier.used_bytes:
            raise AssertionError(f"{label} {mode}: the host tier is not "
                                 f"empty at the end")
        for name in (f"ragged_paged{suffix}", f"paged_decode{suffix}"):
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{label} {mode}: {name} never ran")
        out_o = [r.output_tokens for r in reqs]
        out_a = [r.output_tokens for r in reqs_a]
        if mode == "greedy":
            exact = compare_streams(
                eng, ample, [r.prompt_tokens for r in reqs], out_o, out_a,
                f"{label} {mode}", margin, names=("128-page", "ample"))
        else:
            exact = compare_sampled(eng, ample, reqs, reqs_a,
                                    f"{label} {mode}", margin)
        runs[mode] = dict(wall_s=wall, tokens_per_s=tps, ample_wall_s=wall_a,
                          ample_tokens_per_s=tps_a, preemptions=pre,
                          spills=spills, restores=restores,
                          requeues=requeues, peak_parked=parked, peak_page_pressure=pressure,
                          exact=exact, launches=counts)
    return runs


def steady_guard(eng, kind):
    """After the storm: 8 sampled requests that fit whole, past their
    growth (every slot's pages cover its final need), then phase 5c's
    guarded window (no upload, no capture, a readback and a graph launch
    a tick)."""
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    gen = torch.Generator().manual_seed(78)
    B = eng.config.max_batch_size
    page = eng.allocator.page_size
    eng.allocator.clear_cache()
    reqs = [Request(f"guard-{kind}-{i}",
                    torch.randint(1000, 100000, (40 + 9 * i,),
                                  generator=gen).tolist(),
                    SamplingParams(max_tokens=96, seed=60 + i,
                                   **SAMPLED))
            for i in range(B)]
    for r in reqs:
        eng.add_request(r)

    def grown():
        return all(s.request is not None and s.ready
                   and len(s.pages) * page >= s.position + 1
                   + s.request.params.max_tokens
                   - len(s.request.output_tokens) for s in eng.slots)

    steps = 0
    while not grown():
        eng.step()
        steps += 1
        if steps > 200:
            raise AssertionError("the steady batch never grew whole")
    for _ in range(3):
        eng.step()
    res = guarded_window(eng, f"kv {kind_label(kind)} after the storm",
                         dispatch_guard)
    for r in reqs:
        eng.abort(r.request_id)
    while eng.has_work():
        eng.step()
    return res


def restored_rows_equal(eng, slot, parked):
    """A gather of the restored slot's first `position` token rows
    against the host copy it was restored from, byte for byte (values
    and, on one-byte pages, scales)."""
    from ray_tpu_torch.llm._internal.engine import _bits
    from ray_tpu_torch.llm._internal.kv_offload import host_tensor
    got = eng._gather_pages(slot.pages[:parked.n_pages])
    for g, h in zip(got, eng._host_pages(parked)):
        rows_g = _bits(g.cpu()).flatten(1, 2)[:, :parked.position]
        rows_h = _bits(host_tensor(h)).flatten(1, 2)[:, :parked.position]
        if not torch.equal(rows_g, rows_h):
            return False
    return True


def manual_preempt(eng, kind):
    """8 sampled requests in steady decode, no admission pending: a run
    never preempted, then the same requests with one preempted (spilled)
    8 ticks into decode and restored at the next step. All 8 streams
    token-exact, no graph capture in the second run, the pools at their
    addresses, and the restored rows byte-equal to the host copy."""
    from ray_tpu_torch import Request, SamplingParams
    gen = torch.Generator().manual_seed(79)
    prompts = [torch.randint(1000, 100000, (60 + 23 * i,),
                             generator=gen).tolist() for i in range(8)]
    victim = 3

    def run(tag, preempt):
        eng.allocator.clear_cache()
        reqs = [Request(f"{tag}{i}", p, SamplingParams(
            max_tokens=48, seed=80 + i, **SAMPLED))
            for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        while eng.waiting or any(s.request is not None and not s.ready
                                 for s in eng.slots):
            eng.step()
        for _ in range(8):
            eng.step()
        info = {}
        if preempt:
            rid = reqs[victim].request_id
            if not eng.preempt(rid):
                raise AssertionError(f"{kind}: preempt refused")
            parked = eng.parked[0]
            eng.step()                       # restores, then decodes
            slot = next((s for s in eng.slots
                         if s.request is reqs[victim]), None)
            if slot is None or eng.parked:
                raise AssertionError(f"{kind}: the victim was not restored "
                                     f"at the next step")
            info = dict(pages=parked.n_pages, position=parked.position,
                        bytes_equal=restored_rows_equal(eng, slot, parked))
        while eng.has_work():
            eng.step()
        return [r.output_tokens for r in reqs], info

    want, _ = run(f"man-ref-{kind}-", False)
    captures = eng.graph_captures
    ptrs = [t.data_ptr() for t in eng._pools()]
    got, info = run(f"man-pre-{kind}-", True)
    info.update(exact=got == want,
                captures_unchanged=eng.graph_captures == captures,
                pools_in_place=[t.data_ptr() for t in eng._pools()] == ptrs)
    log(f"[kv {kind_label(kind)}] manual preempt of 1 of 8 decoding "
        f"requests ({info['pages']} pages, position {info['position']}), "
        f"restored at the next step: 8 streams token-exact {info['exact']}; "
        f"graph captures unchanged {info['captures_unchanged']}; pools in "
        f"place {info['pools_in_place']}; restored rows byte-equal to the "
        f"host copy {info['bytes_equal']}")
    if not all(info[k] for k in ("exact", "captures_unchanged",
                                 "pools_in_place", "bytes_equal")):
        raise AssertionError(f"{kind}: manual preempt and restore: {info}")
    return info


def time_moves(eng, kind):
    """Spill (page gather + copy into pinned memory) and restore (upload
    from pinned memory + in-place index_copy_) of MOVE_PAGES pages, CUDA
    events around the engine's own calls, each beside a plain pinned
    copy_ of the same bytes in the same direction; GB/s of the page
    bytes (values and scales)."""
    out = {}
    for n in MOVE_PAGES:
        pages = list(range(n))
        nbytes = n * eng.kv_page_bytes

        def spill():
            return eng._copy_to_host(eng._gather_pages(pages))[0]

        hosts = spill()
        torch.cuda.synchronize()
        spill_ms = time_ms(spill, iters=MOVE_ITERS, warmup=1)
        restore_ms = time_ms(lambda: eng._scatter_pages(pages, hosts),
                             iters=MOVE_ITERS, warmup=1)
        eng._finalize_spills()           # lets go of the uploads' holds
        dev_buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        host_buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        d2h_ms = time_ms(lambda: host_buf.copy_(dev_buf, non_blocking=True),
                         iters=MOVE_ITERS, warmup=1)
        h2d_ms = time_ms(lambda: dev_buf.copy_(host_buf, non_blocking=True),
                         iters=MOVE_ITERS, warmup=1)
        gbs = {k: nbytes / ms / 1e6 for k, ms in (
            ("spill", spill_ms), ("restore", restore_ms),
            ("d2h_copy", d2h_ms), ("h2d_copy", h2d_ms))}
        log(f"[kv {kind_label(kind)}] {n} pages ({nbytes / 2**20:.1f} MiB): "
            f"spill {spill_ms:.3f} ms = {gbs['spill']:.1f} GB/s (pinned "
            f"d2h copy_ {d2h_ms:.3f} ms = {gbs['d2h_copy']:.1f} GB/s); "
            f"restore {restore_ms:.3f} ms = {gbs['restore']:.1f} GB/s "
            f"(pinned h2d copy_ {h2d_ms:.3f} ms = {gbs['h2d_copy']:.1f} "
            f"GB/s)")
        out[n] = dict(bytes=nbytes, spill_ms=spill_ms, restore_ms=restore_ms,
                      d2h_copy_ms=d2h_ms, h2d_copy_ms=h2d_ms, gb_s=gbs)
    return out


def transport(eng, params, kind, frames):
    """A decoding session exported mid-stream, through the RTKV wire,
    into a second engine (same weights, its own pool), finished there:
    token-exact against the exporter never exporting; an int8 frame into
    an fp8 engine raises; a prefix exported from the first engine and
    imported into the second hits at the next admission of its prompt.
    `frames` collects each kind's session frame."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request, \
        SamplingParams
    from ray_tpu_torch.serve.llm import kv_transport as kvt
    label = kind_label(kind)
    gen = torch.Generator().manual_seed(81)
    prompt = torch.randint(1000, 100000, (333,), generator=gen).tolist()
    sp = SamplingParams(max_tokens=64, seed=99, **SAMPLED)

    def request(tag):
        return Request(f"ship-{kind}-{tag}", list(prompt),
                       SamplingParams(**vars(sp)))

    eng.allocator.clear_cache()
    ref = request("ref")
    eng.add_request(ref)
    while eng.has_work():
        eng.step()
    eng.allocator.clear_cache()
    src = request("moved")
    eng.add_request(src)
    while len(src.output_tokens) < 20:
        eng.step()
    state = eng.export_session(src.request_id)
    blob = kvt.encode_session(state)
    frames[kind] = blob
    dst = InferenceEngine(EngineConfig(decode_impl="kernel", **dict(
        KV_KW, num_pages=257, kv_dtype=kind, enable_kv_offload=True)),
        params=params)
    got = dst.import_session(kvt.decode_session(blob))
    while dst.has_work():
        dst.step()
    exact = got.output_tokens == ref.output_tokens
    log(f"[kv {label}] session exported at {len(state['output_tokens'])} "
        f"tokens ({state['n_pages']} pages, frame {len(blob) / 2**20:.2f} "
        f"MiB), imported into a second engine: token-exact {exact}; its "
        f"graph captures {dst.graph_captures}")
    if not exact or got.finish_reason != "length":
        raise AssertionError(f"{label}: the imported session diverged")
    refused = True
    if kind == "fp8":
        try:
            kvt.ship_kind_compatible(
                kvt.decode_session(frames["int8"])["kv_dtype"], dst.kv_kind)
            refused = False
        except kvt.TransportError:
            pass
        try:
            dst.import_session(kvt.decode_session(frames["int8"]))
            refused = False
        except ValueError:
            pass
        log(f"[kv {label}] an int8 session frame into the fp8 engine: "
            f"refused {refused}")
        if not refused:
            raise AssertionError("an int8 frame entered an fp8 engine")
    # a prefix prefilled on the first engine seeds the second's cache
    p2 = torch.randint(1000, 100000, (300,), generator=gen).tolist()
    eng.add_request(Request(f"pfx-{kind}", p2, SamplingParams(max_tokens=2)))
    while eng.has_work():
        eng.step()
    exp = eng.export_prefix(p2)
    pfx = kvt.decode_prefix(kvt.encode_prefix(
        exp["tokens"], exp["k"], exp["v"], exp.get("k_scales"),
        exp.get("v_scales"), kv_dtype=exp["kv_dtype"]))
    seeded = dst.import_prefix(pfx["tokens"], pfx["k"], pfx["v"],
                               pfx["k_scales"], pfx["v_scales"],
                               kv_dtype=pfx["kv_dtype"])
    hits0 = dst.allocator.cache_hit_tokens
    probe = Request(f"pfx-{kind}-probe", p2, SamplingParams(max_tokens=2))
    dst.add_request(probe)
    while dst.has_work():
        dst.step()
    hit = dst.allocator.cache_hit_tokens - hits0
    log(f"[kv {label}] prefix of {len(p2)} tokens: {seeded} pages imported, "
        f"the next admission hit {hit} tokens")
    if seeded != len(p2) // 16 or hit != (len(p2) - 1) // 16 * 16:
        raise AssertionError(f"{label}: the imported prefix did not hit")
    dst.release_graphs()
    return dict(exact=exact, pages=state["n_pages"], frame_bytes=len(blob),
                refused_other_kind=refused, prefix_pages=seeded,
                prefix_hit_tokens=hit)


def run_kv_hierarchy(params):
    """Phase 5d on bf16, int8 and fp8 pages with the bf16 phase's
    weights, default engines (CUDA graph, lagged readback): the
    oversubscribed workload against an ample pool (greedy and sampled on
    bf16 pages, sampled on int8 and fp8), the guarded window after it, a
    manual preempt and restore in steady decode, spill and restore
    times, session and prefix transport."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    out, frames = {}, {}
    for kind in ("f32", "int8", "fp8"):
        modes = ([("greedy", {}), ("sampled", SAMPLED)] if kind == "f32"
                 else [("sampled", SAMPLED)])
        eng = InferenceEngine(EngineConfig(
            decode_impl="kernel", **dict(OVERSUB_KW, kv_dtype=kind)),
            params=params)
        ample = InferenceEngine(EngineConfig(
            decode_impl="kernel", **dict(KV_KW, kv_dtype=kind)),
            params=params)
        res = dict(runs=oversubscribe(eng, ample, kind, modes))
        ample.release_graphs()
        del ample
        res["guard"] = steady_guard(eng, kind)
        res["manual"] = manual_preempt(eng, kind)
        res["moves"] = time_moves(eng, kind)
        res["transport"] = transport(eng, params, kind, frames)
        eng.release_graphs()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        out[kind_label(kind)] = res
    return out


# ----------------------------------------------------------- serving replica

SERVER_MODEL = "8b"
SERVER_KW = dict(max_batch_size=8, page_size=16, max_prefill_tokens=512,
                 num_pages=1025, seed=0, enable_kv_offload=True)
SERVER_TOKENS = 64
AB_TICKS = 16           # steady decode ticks a window of the overhead A/B
PROFILE_TICKS = 4
# the observability switches, all off (the A/B's other arm)
OBS_OFF = dict(enable_metrics=False, enable_perf_accounting=False,
               enable_attribution=False, enable_anomaly_detection=False,
               enable_blackbox=False)
# families every exposition must carry (the JAX package's names)
FAMILIES = ("ray_tpu_llm_ttft_seconds", "ray_tpu_llm_itl_seconds",
            "ray_tpu_llm_queue_wait_seconds",
            "ray_tpu_llm_e2e_latency_seconds",
            "ray_tpu_llm_generated_tokens_total",
            "ray_tpu_llm_finished_total", "ray_tpu_llm_kv_pages_used",
            "ray_tpu_llm_flops_total", "ray_tpu_llm_hbm_bytes_total",
            "ray_tpu_llm_mfu", "ray_tpu_llm_mbu")


def server_bodies():
    """12 OpenAI bodies, greedy, SERVER_TOKENS each: 8 completions, 2
    chats and 2 token streams over prompts of 14-1535 tokens."""
    t = PROMPT_TEXTS
    comp = [dict(prompt=x) for x in t] + [
        dict(prompt=t[0][:700] + " Part two."), dict(prompt=t[2] + " Again.")]
    chat = [dict(messages=[{"role": "user", "content": t[3]}]),
            dict(messages=[{"role": "system", "content": "Be brief."},
                           {"role": "user", "content": t[1]}])]
    stream = [dict(prompt=t[4] + " Tell me more."),
              dict(prompt=t[5] + " Why?")]
    for b in comp + chat + stream:
        b.update(max_tokens=SERVER_TOKENS, temperature=0.0)
    return comp, chat, stream


async def serve_bodies(srv, comp, chat, stream):
    """All bodies at once through the server's entry points; returns
    (unary results, stream token lists, wall s)."""
    import asyncio

    async def tokens(body):
        out = []
        async for c in srv.completions_stream_tokens(dict(body)):
            out += c["toks"]
        return out
    t0 = time.perf_counter()
    res = await asyncio.gather(
        *[srv.completions(dict(b)) for b in comp],
        *[srv.chat(dict(b)) for b in chat],
        *[tokens(b) for b in stream])
    wall = time.perf_counter() - t0
    n = len(comp) + len(chat)
    return res[:n], res[n:], wall


def lifecycles(trace):
    """Per request of a /debug/trace document: TTFT, TPOT and e2e (ms)
    from its lifecycle events; fails unless every request has exactly
    one queued, prefill, first_token, decode and finished event."""
    by = {}
    for e in trace["traceEvents"]:
        rid = (e.get("args") or {}).get("request_id")
        if rid is None or e.get("cat") != "request" \
                or e["name"] == "prefill_chunk":
            continue
        name = "finished" if e["name"].startswith("finished:") else e["name"]
        by.setdefault(rid, {}).setdefault(name, []).append(e)
    out = {}
    for rid, evs in by.items():
        if sorted(evs) != ["decode", "finished", "first_token", "prefill",
                           "queued"] or any(len(v) != 1
                                            for v in evs.values()):
            raise AssertionError(f"request {rid}: lifecycle events "
                                 f"{ {k: len(v) for k, v in evs.items()} }")
        q, d = evs["queued"][0]["ts"], evs["decode"][0]
        n = d["args"]["generated_tokens"]
        out[rid] = dict(ttft=(evs["first_token"][0]["ts"] - q) / 1e3,
                        tpot=d["dur"] / 1e3 / max(n - 1, 1),
                        e2e=(evs["finished"][0]["ts"] - q) / 1e3, tokens=n)
    return out


def pctl(vals, q):
    s = sorted(vals)
    return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)] if s else 0.0


def tick_kinds(eng):
    """The perf window's ticks by kind (ragged: mixed, decode): count,
    median wall ms, and MFU/MBU over their summed walls."""
    env = eng.perf.envelope
    out = {}
    for kind in ("ragged", "decode"):
        ts = [t for t in eng.perf.window() if t.kind == kind]
        if not ts:
            continue
        busy = sum(t.wall_ms for t in ts) / 1e3
        out[kind] = dict(
            ticks=len(ts), wall_ms=statistics.median(t.wall_ms for t in ts),
            tokens=statistics.median(t.decode_tokens + t.prefill_tokens
                                     for t in ts),
            tflop=statistics.median(t.flops for t in ts) / 1e12,
            gb=statistics.median(t.hbm_bytes for t in ts) / 1e9,
            mfu=sum(t.flops for t in ts) / (busy * env.peak_flops),
            mbu=sum(t.hbm_bytes for t in ts) / (busy * env.peak_bytes_per_s))
    return out


def actual_decode_bytes(eng, sample):
    """A decode tick's weight bytes as this engine holds them (every
    layer matrix and norm, the final norm and the float32 head, read
    once; one embedding row a token), beside the cost model's closed
    form for the same tick."""
    p = eng.params
    nb = lambda t: t.numel() * t.element_size()
    weights = (sum(nb(t) for t in p["layers"].values()) + nb(p["final_norm"])
               + nb(p["lm_head"])
               + sample.decode_tokens * p["embed"].shape[1]
               * p["embed"].element_size())
    kv = sample.bytes_kv_read + sample.bytes_kv_write
    return dict(model_weights=sample.bytes_weights, actual_weights=weights,
                kv=kv, model_total=sample.hbm_bytes, actual_total=weights + kv)


def quiet_profiler(eng):
    """Let a profile the anomaly detector armed on `eng` run out before
    this script profiles or times it: one profiler at a time, and no
    profiled tick inside a timed window."""
    from ray_tpu_torch import Request, SamplingParams
    n = 0
    while eng._profile is not None:
        if not eng.has_work():
            n += 1
            eng.add_request(Request(f"quiet{n}", [5, 6, 7],
                                    SamplingParams(max_tokens=2)))
        eng.step()


def pump_gaps(eng):
    """Host ms between consecutive ticks spent outside step() (the
    server's pump, its executor hop and the streams' work): each tick's
    commit stamp minus the previous one's, less its own wall; median,
    p90 and max over the ticks of the perf window, and their sum beside
    the summed tick walls."""
    ts = eng.perf.window()
    gaps = [(b.mono_ts - a.mono_ts) * 1e3 - b.wall_ms
            for a, b in zip(ts, ts[1:])]
    return dict(median_ms=statistics.median(gaps), p90_ms=pctl(gaps, 0.9),
                max_ms=max(gaps), sum_ms=sum(gaps),
                walls_ms=sum(t.wall_ms for t in ts), ticks=len(gaps))


def set_observability(eng, saved=None):
    """Turn every observability switch of `eng` off (returns what to
    restore), or back on from `saved`: the overhead A/B on one engine."""
    names = ("perf", "attrib", "anomaly")
    if saved is None:
        saved = {n: getattr(eng, n) for n in names}
        saved["metrics"] = eng.telemetry.enabled
        for n in names:
            setattr(eng, n, None)
        eng.telemetry.enabled = False
        return saved
    for n in names:
        setattr(eng, n, saved[n])
    eng.telemetry.enabled = saved["metrics"]
    return None


def overhead_ab(eng):
    """Steady decode ticks, windows of AB_TICKS with observability off,
    on, on, off, on one engine (same requests, weights and graphs):
    each window's median tick (step() and a synchronise). The on
    windows' median must not exceed the off windows' by more than the
    spread between windows of one arm (or 2%)."""
    from ray_tpu_torch import Request, SamplingParams
    gen = torch.Generator().manual_seed(88)
    for i in range(eng.config.max_batch_size):
        eng.add_request(Request(
            f"ab{i}", torch.randint(1000, 100000, (30 + 40 * i,),
                                    generator=gen).tolist(),
            SamplingParams(max_tokens=4 * AB_TICKS + 40
                           + PROFILE_ATTEMPTS * GUARD_TICKS)))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(3):
        eng.step()
    meds = {}
    for arm in ("off", "on", "on2", "off2"):
        quiet_profiler(eng)
        saved = set_observability(eng) if arm.startswith("off") else None
        walls = []
        for _ in range(AB_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if saved is not None:
            set_observability(eng, saved)
        meds[arm] = statistics.median(walls)
    on = statistics.median([meds["on"], meds["on2"]])
    off = statistics.median([meds["off"], meds["off2"]])
    spread = max(abs(meds["on"] - meds["on2"]),
                 abs(meds["off"] - meds["off2"]))
    log(f"[server] overhead A/B, {AB_TICKS} steady decode ticks a window: "
        f"median tick off {meds['off']:.3f} / on {meds['on']:.3f} / on "
        f"{meds['on2']:.3f} / off {meds['off2']:.3f} ms; on {on:.3f} vs off "
        f"{off:.3f} ms, spread {spread:.3f} ms")
    if on > off + max(spread, 0.02 * off):
        raise AssertionError(f"decode tick with observability on {on:.3f} "
                             f"ms against off {off:.3f} ms: beyond the "
                             f"spread {spread:.3f} ms")
    return dict(windows_ms=meds, on_ms=on, off_ms=off, spread_ms=spread)


def profile_window(srv):
    """profile_next_ticks over PROFILE_TICKS ticks holding mixed ticks
    (two 600-token prompts prefilling beside six decoding requests) and a
    decode tick: the Chrome trace must hold as many ragged and decode
    kernel launches as the launch counters moved (the combine passes
    apart). A trace that lost records is taken again on a fresh window
    (at most PROFILE_ATTEMPTS), as `profiled` does."""
    for attempt in range(PROFILE_ATTEMPTS):
        res = profile_attempt(srv, attempt)
        PROFILES["windows"] += 1
        if res["recorded"] == res["counted"]:
            return res
        PROFILES["lost"] += 1
        log(f"[profiler] profile_next_ticks: the trace lost records "
            f"(window {attempt + 1} of {PROFILE_ATTEMPTS})")
    raise AssertionError("the profile's kernel launches differ from the "
                         "launch counters")


def profile_attempt(srv, attempt):
    import asyncio
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import profiling
    eng = srv.engine
    gen = torch.Generator().manual_seed(99 + attempt)
    for i in range(8):
        n = 600 if i >= 6 else 40 + 11 * i
        eng.add_request(Request(
            f"prof{attempt}-{i}", torch.randint(1000, 100000, (n,),
                                                generator=gen).tolist(),
            SamplingParams(max_tokens=24)))
        if i == 5:
            while eng.waiting or any(s.request is not None and not s.ready
                                     for s in eng.slots):
                eng.step()
            eng.step()
    log_dir = asyncio.run(srv.start_profile(
        {"ticks": PROFILE_TICKS}))["log_dir"]
    before = _kernels.launch_counts()
    ragged0 = eng.ragged_ticks
    for _ in range(PROFILE_TICKS):
        eng.step()
    after = _kernels.launch_counts()
    mixed = eng.ragged_ticks - ragged0
    files = profiling.trace_files(log_dir)
    if len(files) != 1 or mixed < 1 or mixed == PROFILE_TICKS:
        raise AssertionError(f"profile_next_ticks wrote {files} over "
                             f"{mixed} mixed ticks")
    with open(files[0]) as f:
        evs = json.load(f)["traceEvents"]
    rec = profiling.kernel_launches(evs, "ragged", "paged_decode")
    got = {k: sum(n for name, n in rec.items()
                  if k in name and "combine" not in name)
           for k in ("ragged", "paged_decode")}
    want = {k: after[c] - before[c] for k, c in (
        ("ragged", "ragged_paged"), ("paged_decode", "paged_decode"))}
    log(f"[server] profile_next_ticks({PROFILE_TICKS}): {mixed} mixed and "
        f"{PROFILE_TICKS - mixed} decode ticks; trace {files[0]} "
        f"({os.path.getsize(files[0]) / 2**20:.1f} MiB): kernel launches "
        f"{got}, counters {want}")
    while eng.has_work():
        eng.step()
    return dict(mixed_ticks=mixed, recorded=got, counted=want)


def check_exposition(text):
    """Prometheus text: every sample line parses, every family of
    FAMILIES is declared; returns the sample count."""
    import re
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*'
                        r'="(?:[^"\\]|\\.)*",?)*\})? \S+$')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not sample.match(line):
            raise AssertionError(f"exposition line does not parse: {line!r}")
        n += 1
    missing = [f for f in FAMILIES if f"# TYPE {f} " not in text]
    if missing:
        raise AssertionError(f"exposition lacks families {missing}")
    return n


def move_session(srv_a, srv_b):
    """One request served alone on server A end to end, and the same
    request exported from A mid-decode (through the RTKV wire) and
    resumed on server B: token-exact."""
    import asyncio
    body = dict(prompt=PROMPT_TEXTS[1], max_tokens=48, temperature=0.0)

    async def whole():
        out = []
        async for c in srv_a.completions_stream_tokens(
                dict(body, _request_id="whole")):
            out += c["toks"]
        return out

    async def moved():
        got = []

        async def consume():
            async for c in srv_a.completions_stream_tokens(
                    dict(body, _request_id="mover")):
                got.extend(c["toks"])
        task = asyncio.create_task(consume())
        while len(got) < 16:
            await asyncio.sleep(0.005)
        exp = await srv_a.export_session({"request_id": "mover"})
        await task
        if exp["session"] is None:
            raise AssertionError("export_session found no session")
        rest = []
        async for c in srv_b.resume_stream_tokens(
                {"_session": exp["session"], "_resume_offset": len(got)}):
            rest.extend(c["toks"])
        return got, rest, exp
    ref = asyncio.run(whole())
    got, rest, exp = asyncio.run(moved())
    log(f"[server] session moved after {len(got)} tokens ({exp['pages']} "
        f"pages, {exp['bytes'] / 2**20:.1f} MiB frame): {len(rest)} more on "
        f"server B; token-exact with the unmoved request: "
        f"{got + rest == ref}")
    if got + rest != ref:
        raise AssertionError("the moved session's tokens differ")
    return dict(tokens_before=len(got), pages=exp["pages"],
                frame_bytes=exp["bytes"])


def watch_detector(eng):
    """Every tick the engine's anomaly detector observes, as (kind, wall
    ms, compile events in the tick), recorded beside it."""
    ticks = []
    det = eng.anomaly
    observe = det.observe
    last = [eng.compiles]

    def observing(sample, wall_ms, host_ms, device_ms, compiles, *a, **k):
        ticks.append((sample.kind, wall_ms, compiles - last[0]))
        last[0] = compiles
        return observe(sample, wall_ms, host_ms, device_ms, compiles, *a,
                       **k)
    det.observe = observing
    return ticks


def cold_ticks(eng, ticks, since):
    """The cold ticks (those with compile events: a ragged bucket's first
    tick, a decode graph's capture (in the tick that first runs its
    sampling mode, eagerly), a kernel build) of the server's run, then
    of a recapture after the detector's warm-up (the graphs dropped, 8
    fresh requests): each is printed with its wall and whether the
    detector judged it; every flagged tick is printed with its class.
    The recapture's first decode tick must carry a compile event, so the
    detector reads it as recompile (its first rule), never unknown; a
    flagged tick with compile events must
    read recompile; the anomaly bundles stay within the rate limit (one
    per dump_min_interval_s since the server started at `since`)."""
    from ray_tpu_torch import Request, SamplingParams
    start = len(ticks)
    eng.release_graphs()
    gen = torch.Generator().manual_seed(66)
    for i in range(eng.config.max_batch_size):
        eng.add_request(Request(f"cold{i}", torch.randint(
            1000, 100000, (50,), generator=gen).tolist(),
            SamplingParams(max_tokens=12)))
    while eng.has_work():
        eng.step()
    det = eng.anomaly
    warm = det.config.warmup_ticks
    flagged = [e for e in eng.telemetry.recorder.events()
               if e["event"] == "tick_anomaly"]
    cold = [(i, k, w, d) for i, (k, w, d) in enumerate(ticks) if d > 0]
    for i, k, w, d in cold:
        where = "recapture" if i >= start else "serving run"
        log(f"[server] cold tick {i} ({where}, {k}): wall {w:.2f} ms, "
            f"{d} compile event(s), detector class recompile, "
            f"{'absorbed by the warm-up' if i < warm else 'judged'}")
    for e in flagged:
        log(f"[server] flagged tick: {e['anomaly_kind']}, wall "
            f"{e['wall_ms']} ms against {e['predicted_ms']} ms predicted, "
            f"z {e['z']}, compile events {e['compile_delta']}, composition "
            f"{e['composition']}; {first_use(e)}")
    st = det.stats()
    bundles = sum(1 for b in eng.blackbox.list()
                  if b["cause"] == "tick_anomaly")
    limit = 1 + int((time.monotonic() - since)
                    / det.config.dump_min_interval_s)
    log(f"[server] anomaly detector: {st['ticks']} ticks (warm-up {warm}),"
        f" flagged {st['anomalies_total']} by kind {st['by_kind']}; "
        f"{bundles} anomaly bundles in the spool")
    recap = [d for i, (k, w, d) in enumerate(ticks)
             if i >= start and k == "decode"][:2]
    if recap != [int(eng._capture_graphs), 0] or any(e["compile_delta"] > 0
                              and e["anomaly_kind"] != "recompile"
                              for e in flagged) or bundles > limit:
        raise AssertionError(f"cold ticks: recapture compile events "
                             f"{recap}, flagged {flagged}, {bundles} "
                             f"bundles")
    return dict(cold=cold, flagged=flagged, by_kind=st["by_kind"],
                bundles=bundles)


def run_server():
    """Phase 5e: LLMServerImpl on the `8b` preset at full width and depth
    (random bf16 weights from seed 0), every observability switch on."""
    import asyncio
    from ray_tpu_torch import (EngineConfig, InferenceEngine, LLMServerImpl,
                               Request, SamplingParams)
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    cfg = dict(model_id="8b", model_source=SERVER_MODEL,
               engine_kwargs=SERVER_KW)
    t0 = time.perf_counter()
    since = time.monotonic()
    srv = LLMServerImpl(dict(cfg))
    eng = srv.engine
    log(f"[server] LLMServerImpl 8b on {eng.device} in "
        f"{time.perf_counter() - t0:.1f} s; envelope "
        f"{eng.perf.envelope.name} ({eng.perf.envelope.source})")
    if eng.perf.envelope.name != "h100":
        raise AssertionError(f"perf envelope {eng.perf.envelope.name}")
    ticks = watch_detector(eng)
    submitted = []
    add = eng.add_request

    def recording(req):
        submitted.append(req)
        return add(req)
    eng.add_request = recording
    comp, chat, stream = server_bodies()
    unary, streamed, wall = asyncio.run(serve_bodies(srv, comp, chat, stream))
    del eng.add_request
    by_prompt = {tuple(r.prompt_tokens): r for r in submitted}
    tok = srv.tokenizer
    prompts = ([tok.encode(b["prompt"]) for b in comp]
               + [tok.encode(tok.apply_chat_template(b["messages"]))
                  for b in chat]
               + [tok.encode(b["prompt"]) for b in stream])
    reqs = [by_prompt[tuple(p)] for p in prompts]
    for r, u in zip(reqs, unary):
        text = u["choices"][0].get("text", u["choices"][0].get(
            "message", {}).get("content"))
        if text != tok.decode(r.output_tokens) \
                or u["usage"]["completion_tokens"] != len(r.output_tokens):
            raise AssertionError(f"{r.request_id}: response disagrees with "
                                 f"its tokens")
    for r, s in zip(reqs[len(unary):], streamed):
        if s != r.output_tokens:
            raise AssertionError(f"{r.request_id}: streamed tokens differ")
    n_out = sum(len(r.output_tokens) for r in reqs)
    log(f"[server] {len(reqs)} requests ({len(comp)} completions, "
        f"{len(chat)} chats, {len(stream)} token streams), prompts "
        f"{sorted(len(p) for p in prompts)} tokens: {n_out} output tokens "
        f"in {wall:.2f} s, {n_out / wall:.1f} output tokens/s; finish "
        f"{sorted({r.finish_reason for r in reqs})}")
    # the same requests on an engine driven directly with the same weights
    ref = InferenceEngine(EngineConfig(model=SERVER_MODEL, **SERVER_KW),
                          params=eng.params)
    rreqs = [Request(f"direct{i}", list(p),
                     SamplingParams(max_tokens=SERVER_TOKENS,
                                    stop_token_ids=r.params.stop_token_ids))
             for i, (p, r) in enumerate(zip(prompts, reqs))]
    for r in rreqs:
        ref.add_request(r)
    while ref.has_work():
        ref.step()
    exact = compare_streams(eng, ref, prompts,
                            [r.output_tokens for r in reqs],
                            [r.output_tokens for r in rreqs], "server 8b",
                            names=("server", "engine"))
    ref.release_graphs()
    del ref, rreqs
    st = eng.stats()
    rq = st["requests"]
    lc = lifecycles(asyncio.run(srv.debug_trace()))
    served = {r.request_id for r in reqs}
    if not served <= set(lc):
        raise AssertionError(f"requests without a lifecycle: "
                             f"{served - set(lc)}")
    times = {k: [lc[r][k] for r in served] for k in ("ttft", "tpot", "e2e")}
    log(f"[server] stats()['requests']: ttft avg {rq['ttft_ms_avg']} ms, itl "
        f"avg {rq['itl_ms_avg']} ms, queue wait avg {rq['queue_wait_ms_avg']}"
        f" ms, e2e avg {rq['e2e_ms_avg']} ms, finished {rq['finished']}, "
        f"generated {rq['generated_tokens']}")
    log("[server] lifecycles (/debug/trace), ms p50 / p99: " + "; ".join(
        f"{k} {pctl(v, 0.5):.2f} / {pctl(v, 0.99):.2f}"
        for k, v in times.items()))
    perf = st["perf"]
    kinds = tick_kinds(eng)
    gaps = pump_gaps(eng)
    log(f"[server] between ticks, outside step(): median "
        f"{gaps['median_ms']:.2f} ms, p90 {gaps['p90_ms']:.2f} ms, max "
        f"{gaps['max_ms']:.1f} ms, {gaps['sum_ms']:.0f} ms in all over "
        f"{gaps['ticks']} gaps, beside {gaps['walls_ms']:.0f} ms inside "
        f"step()")
    log(f"[server] stats()['perf']: envelope {perf['envelope']}, decode "
        f"{perf['decode_tokens_per_s']} and prefill "
        f"{perf['prefill_tokens_per_s']} tokens/s, MFU {perf['mfu']}, MBU "
        f"{perf['mbu']}, roof {perf['roof']}, {perf['window']} ticks")
    for k, v in kinds.items():
        log(f"[server] {'mixed' if k == 'ragged' else 'decode'} ticks: "
            f"{v['ticks']}, median wall {v['wall_ms']:.2f} ms, median "
            f"{v['tokens']} tokens, {v['tflop']:.3f} TFLOP and "
            f"{v['gb']:.2f} GB a tick (cost model); MFU {v['mfu']:.4f}, MBU "
            f"{v['mbu']:.4f}")
    shares = [perf["mfu"], perf["mbu"]] + [v[s] for v in kinds.values()
                                           for s in ("mfu", "mbu")]
    if perf["envelope"] != "h100" or not all(0 < x <= 1.0 for x in shares) \
            or set(kinds) != {"ragged", "decode"}:
        raise AssertionError(f"perf shares {shares} (each must lie in "
                             f"(0, 1]), tick kinds {sorted(kinds)}")
    dec = [t for t in eng.perf.window() if t.kind == "decode"][-1]
    nbytes = actual_decode_bytes(eng, dec)
    log(f"[server] a decode tick of {dec.decode_tokens} tokens: cost model "
        f"{nbytes['model_total'] / 1e9:.3f} GB (weights "
        f"{nbytes['model_weights'] / 1e9:.3f}), this engine's tensors "
        f"{nbytes['actual_total'] / 1e9:.3f} GB (weights "
        f"{nbytes['actual_weights'] / 1e9:.3f}: layer matrices in "
        f"{eng.params['layers']['wq'].dtype}, head in float32, one "
        f"embedding row a token); KV {nbytes['kv'] / 1e9:.3f}")
    ab = overhead_ab(eng)
    # black box with requests in flight (the A/B's requests still decode)
    dump = asyncio.run(srv.debug_dump({"cause": "smoke"}))
    bundle = asyncio.run(srv.debug_bundle(dump["bundle"]))
    listed = asyncio.run(srv.debug_bundles())
    if bundle is None or not bundle["flight_recorder"] \
            or not bundle["tick_times_ms"] \
            or "ray_tpu_llm_ttft_seconds" not in bundle["metrics_exposition"] \
            or not bundle["in_flight_requests"] \
            or dump["bundle"] not in {b["id"] for b in listed}:
        raise AssertionError(f"black-box bundle {dump} incomplete")
    log(f"[server] debug_dump {dump['bundle']}: {len(bundle['flight_recorder'])}"
        f" events, {len(bundle['tick_times_ms'])} tick times, "
        f"{len(bundle['in_flight_requests'])} in-flight requests, exposition "
        f"{len(bundle['metrics_exposition'])} chars; spool {len(listed)} "
        f"bundles")
    quiet_profiler(eng)
    guard = guarded_window(eng, "server 8b", dispatch_guard)
    for s in eng.slots:
        if s.request is not None:
            eng.abort(s.request.request_id)
    while eng.has_work():
        eng.step()
    anomaly = cold_ticks(eng, ticks, since)
    quiet_profiler(eng)
    prof = profile_window(srv)
    n_samples = check_exposition(asyncio.run(srv.metrics_text()))
    events = asyncio.run(srv.debug_events(since=0))
    if not events["events"] or events["high_water"] < len(events["events"]):
        raise AssertionError("debug_events(since=0) is empty")
    log(f"[server] metrics_text: {n_samples} samples, families {FAMILIES} "
        f"present; debug_events: {len(events['events'])} events, high water "
        f"{events['high_water']}; /debug/attribution top "
        f"{[r['request_id'] for r in asyncio.run(srv.debug_attribution(3))['top']]}")
    srv_b = LLMServerImpl(dict(cfg))
    moved = move_session(srv, srv_b)
    srv_b.engine.release_graphs()
    eng.release_graphs()
    del srv_b
    return dict(requests=len(reqs), output_tokens=n_out, wall_s=wall,
                tokens_per_s=n_out / wall, exact=exact,
                times={k: dict(p50=pctl(v, 0.5), p99=pctl(v, 0.99))
                       for k, v in times.items()},
                requests_summary=rq, perf={k: perf[k] for k in (
                    "envelope", "mfu", "mbu", "roof", "decode_tokens_per_s",
                    "prefill_tokens_per_s", "window")},
                tick_kinds=kinds, pump_gaps=gaps, decode_bytes=nbytes,
                overhead=ab,
                guard=guard, anomaly=anomaly,
                profile=prof, session=moved, bundle=dump["bundle"])


# ------------------------------------------- multi-LoRA and multi-step (5f)

LORA_RANK = 16
LORA_TOKENS = 64
MULTI_K = 4
MULTI_TOKENS = 62        # output tokens in the multi-step drives: not a
#                          multiple of MULTI_K, so budgets clamp mid-round
MULTI_GUARD_ROUNDS = 8
# the 8 requests: (PROMPT_TEXTS index, adapter). 0 and 1 are a base /
# zero-adapter pair on one prompt with one seed (their tokens must be
# bit-equal), 2 and 3 a base / strong pair (their greedy tokens must
# differ); prompts of 14-1535 tokens
LORA_MIX = [(4, None), (4, "zero"), (5, None), (5, "strong"), (0, "strong"),
            (1, "mild"), (2, "mild"), (3, "zero")]
BASE_MIX = [(i, None) for i, _ in LORA_MIX]
# a steady batch with every adapter active
STEADY_MIX = [None, "strong", "mild", "zero"] * 2
# the phase's engines: the anomaly detector judges and records every
# tick, but arms no profile and writes no bundle (either would stall a
# timed tick; phase 5e holds those paths)
LORA_KW = dict(ENGINE_KW, anomaly={"auto_profile": False,
                                   "auto_dump": False})


def lora_adapters(cfg):
    """Three rank-16 adapters on wq/wk/wv/wo from a seeded numpy
    generator (A ~ N(0, 1/in), so y @ A has unit scale): "strong" (B at
    0.05: its greedy tokens leave the base model's), "mild" (B at
    0.005) and "zero" (all zeros: a no-op, bit for bit)."""
    import numpy as np
    rng = np.random.default_rng(1111)
    L, r = cfg.n_layers, LORA_RANK
    dims = {"wq": (cfg.hidden, cfg.q_dim), "wk": (cfg.hidden, cfg.kv_dim),
            "wv": (cfg.hidden, cfg.kv_dim), "wo": (cfg.q_dim, cfg.hidden)}

    def adapter(b_std):
        return {p: (rng.standard_normal((L, i, r), np.float32)
                    / math.sqrt(i),
                    rng.standard_normal((L, r, o), np.float32) * b_std)
                for p, (i, o) in dims.items()}
    zero = {p: (np.zeros((L, i, r), np.float32),
                np.zeros((L, r, o), np.float32))
            for p, (i, o) in dims.items()}
    return {"strong": adapter(0.05), "mild": adapter(0.005), "zero": zero}


def check_lora_delta(dev, cfg):
    """lora_delta (the concatenated stacks, a slot mask) against
    lora_delta_plain (the reference's gather form) at 8b widths (wq:
    4096 -> 4096, r 16, 9 slots) on bf16, at T 512 (a mixed tick) and B
    8 (a decode tick): the max abs error (each side rounds its float32
    sums to bf16 twice: within 2 bf16 ulps of the largest value), and
    both times."""
    from ray_tpu_torch.models.llama_infer import lora_delta, lora_delta_plain
    gen = torch.Generator(device=dev).manual_seed(16)
    S, r, h, o = 9, LORA_RANK, cfg.hidden, cfg.q_dim
    bf = torch.bfloat16
    a = (torch.randn(S, h, r, generator=gen, device=dev) / 64).to(bf)
    b = (torch.randn(S, r, o, generator=gen, device=dev) * 0.05).to(bf)
    a[0] = 0
    b[0] = 0
    # the concatenated layout: slot s owns columns / rows s*r .. s*r+r-1
    stack = {"a": a.permute(1, 0, 2).reshape(h, S * r),
             "b": b.reshape(S * r, o), "r": r}
    out = {}
    for n in (512, 8):
        y = torch.randn(n, h, generator=gen, device=dev).to(bf)
        idx = torch.randint(0, S, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        got = lora_delta(y, stack, idx)
        want = lora_delta_plain(y, a, b, idx)
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        ms = time_ms(lambda: lora_delta(y, stack, idx))
        plain_ms = time_ms(lambda: lora_delta_plain(y, a, b, idx))
        log(f"[lora] lora_delta vs lora_delta_plain, T={n}, wq at 8b "
            f"widths, r {r}, {S} slots, bf16: max abs err {err:.3e} (max "
            f"|delta| {top:.3f}); {ms:.4f} ms against the plain "
            f"{plain_ms:.4f} ms")
        if not err <= 2 * 2.0 ** -8 * top:
            raise AssertionError(f"lora_delta T={n}: error {err}")
        out[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def lora_requests(tag, mix, sp, max_tokens=LORA_TOKENS, stops=None):
    from ray_tpu_torch import ByteTokenizer, Request, SamplingParams
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    stops = stops or {}
    # the pairs share a seed: only the adapter tells them apart
    return [Request(f"{tag}{i}", list(prompts[pi]), SamplingParams(
        max_tokens=max_tokens, seed=600 + i // 2,
        stop_token_ids=tuple(stops.get(i, ())), **sp), lora=lo)
        for i, (pi, lo) in enumerate(mix)]


def drive_lora(eng, reqs):
    """The prefix cache cleared, the first two requests (the base / zero
    pair) alone for one tick,
    so both prefill in one tick at one token bucket, then the other six;
    step() to the end. Returns (mixed ticks, decode ticks, rounds,
    launch counts)."""
    from ray_tpu_torch.ops import _kernels
    # every drive starts cold: a prefix hit would chunk the prompts at
    # other offsets than an engine that never saw them
    eng.allocator.clear_cache()
    _kernels.reset_launch_counts()
    r0, d0, m0 = eng.ragged_ticks, eng.decode_ticks, eng.multi_rounds
    for r in reqs[:2]:
        eng.add_request(r)
    eng.step()
    for r in reqs[2:]:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    for r in reqs:
        if not r.output_tokens or not all(0 <= t < 128256
                                          for t in r.output_tokens):
            raise AssertionError(f"{r.request_id}: bad output stream")
    return (eng.ragged_ticks - r0, eng.decode_ticks - d0,
            eng.multi_rounds - m0, _kernels.launch_counts())


def check_lora_counts(eng, kind, label, nr, nd, rounds, counts):
    """The kind's serving counters equal layers x ticks (a round counts
    K decode launches a layer), every other serving counter 0, and every
    decode launch on the pipelined route."""
    from ray_tpu_torch.ops import _kernels
    suffix = "" if kind == "f32" else f"_{kind}"
    L, K = eng.model_cfg.n_layers, eng.config.decode_steps_per_call
    want = {f"ragged_paged{suffix}": L * nr,
            f"paged_decode{suffix}": L * (nd + K * rounds)}
    for name, n in counts.items():
        if name != "row_gumbel" and n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    if min(want.values()) <= 0:
        raise AssertionError(f"{label}: a serving kernel never ran")
    check_decode_route(_kernels, f"paged_decode{suffix}",
                       want[f"paged_decode{suffix}"])
    log(f"[lora {label}] {nr} mixed ticks, {nd} decode ticks, {rounds} "
        f"rounds of {K}: launches "
        f"{ {k: n for k, n in counts.items() if n} }")


# this phase's launches of each kernel on its main path (the default
# engines' drives, K=1 and K=4), for the kernels line
LORA_LAUNCHES: dict = {}


def lora_streams(eng, kind, label, sp_mode, mix=LORA_MIX,
                 max_tokens=LORA_TOKENS, stops=None, check=True):
    """The requests of `mix` through drive_lora, greedy or SAMPLED; with
    `check`, the launch counters as check_lora_counts says, added to
    LORA_LAUNCHES."""
    sp = {} if sp_mode == "greedy" else SAMPLED
    reqs = lora_requests(f"{label}-{sp_mode}-", mix, sp, max_tokens, stops)
    nr, nd, rounds, counts = drive_lora(eng, reqs)
    if check:
        check_lora_counts(eng, kind, f"{label} {sp_mode}", nr, nd, rounds,
                          counts)
        if eng.config.cuda_graph:
            for k, n in counts.items():
                LORA_LAUNCHES[k] = LORA_LAUNCHES.get(k, 0) + n
    return reqs


def compare_lora(eng_a, eng_b, ra, rb, label, margin, mode,
                 names=("kernel", "gather")):
    """Two engines' streams of the same requests: greedy through
    compare_streams, sampled through compare_sampled, each with the
    requests' adapters in the teacher-forced logits."""
    if mode == "greedy":
        return compare_streams(eng_a, eng_b, [r.prompt_tokens for r in ra],
                               [r.output_tokens for r in ra],
                               [r.output_tokens for r in rb], label, margin,
                               names=names, loras=[r.lora for r in ra])
    return compare_sampled(eng_a, eng_b, ra, rb, label, margin)


def first_use(e):
    """A flagged tick's first-use evidence (the engine's tick_anomaly
    event): allocator reserve and segment deltas over the tick (eager
    ticks; a graph replay allocates nothing), whether its products ran
    at shapes new to the process, and whether allocator growth alone
    gave it its compile event."""
    return (f"allocator reserve {e.get('reserved_delta', 'not read')} B, "
            f"segments {e.get('segment_delta', 'not read')}, new product "
            f"shapes {e.get('new_gemm_shapes', 'not read')}, compile event "
            f"from allocator growth alone {e.get('growth_compile', False)}")


def log_flagged(eng, label):
    flagged = [e for e in eng.telemetry.recorder.events()
               if e["event"] == "tick_anomaly"]
    for e in flagged:
        log(f"[lora {label}] flagged tick: {e['anomaly_kind']}, wall "
            f"{e['wall_ms']} ms against {e['predicted_ms']} ms predicted, "
            f"compile events {e['compile_delta']}; {first_use(e)}")
    return [dict(kind=e["anomaly_kind"], wall_ms=e["wall_ms"],
                 compile_delta=e["compile_delta"],
                 reserved_delta=e.get("reserved_delta"),
                 segment_delta=e.get("segment_delta"),
                 new_gemm_shapes=e.get("new_gemm_shapes"),
                 growth_compile=e.get("growth_compile", False))
            for e in flagged]


def settle_engine(eng):
    for s in eng.slots:
        if s.request is not None:
            eng.abort(s.request.request_id)
    while eng.has_work():
        eng.step()


def steady_lora(eng, loras, label, guard=False):
    """8 greedy requests under `loras` in steady decode: the unprofiled
    step median over STEADY_TICKS (a decode tick, or a round of K), the
    kernels busy and launched a step over PROFILED_TICKS profiled steps,
    then (guard) a guarded window: GUARD_TICKS ticks, or
    MULTI_GUARD_ROUNDS rounds."""
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    K = eng.config.decode_steps_per_call
    gen = torch.Generator().manual_seed(78)
    n_tok = (STEADY_TICKS + PROFILED_TICKS * PROFILE_ATTEMPTS
             + GUARD_TICKS + 3) * K + 24
    for i, lo in enumerate(loras):
        eng.add_request(Request(
            f"steady-{label}-{i}", torch.randint(
                1000, 100000, (40 + 61 * i,), generator=gen).tolist(),
            SamplingParams(max_tokens=n_tok), lora=lo))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(3):                 # first steps: captures
        eng.step()
    walls = []
    for _ in range(STEADY_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof, _ = profiled(lambda: repeat(eng.step, PROFILED_TICKS),
                       f"lora {label} profile")
    evs = device_events(prof)
    busy = sum(dev_us(e) for e in evs) / 1e3 / PROFILED_TICKS
    launches = sum(e.count for e in evs) / PROFILED_TICKS
    wall = statistics.median(walls)
    res = dict(step_ms=wall, steps_ms=walls, busy_ms=busy,
               launches=launches, idle_share=max(0.0, 1 - busy / wall),
               ms_a_token=wall / K, steps_per_call=K)
    log(f"[lora {label}] steady {'round' if K > 1 else 'decode tick'} "
        f"median {wall:.3f} ms over {STEADY_TICKS} ({wall / K:.3f} ms a "
        f"token a slot); kernels busy {busy:.3f} ms and {launches:.1f} "
        f"launches a step over {PROFILED_TICKS} profiled: idle "
        f"{100 * res['idle_share']:.1f}%")
    if guard:
        res["guard"] = guarded_window(
            eng, f"lora {label}", dispatch_guard,
            n=GUARD_TICKS if K == 1 else MULTI_GUARD_ROUNDS)
    settle_engine(eng)
    return res


def mixed_lora(eng, loras, label):
    """Mixed ticks at the engine's budget: 7 short requests decoding
    under loras[:7], then a 1535-token prompt under loras[7] whose three
    chunks ride beside them (~520 tokens a tick): the unprofiled mixed
    ticks' median wall (each to a synchronise), then kernels busy a tick
    over a profile of the next prompt's three."""
    from ray_tpu_torch import ByteTokenizer, Request, SamplingParams
    tok = ByteTokenizer(128256)
    long_p = tok.encode(PROMPT_TEXTS[0])
    gen = torch.Generator().manual_seed(79)
    for i, lo in enumerate(loras[:7]):
        eng.add_request(Request(f"mix-{label}-{i}", torch.randint(
            1000, 100000, (30 + 7 * i,), generator=gen).tolist(),
            SamplingParams(max_tokens=200), lora=lo))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    n = [0]

    def long_prefill(walls=None):
        n[0] += 1
        eng.add_request(Request(f"mix-{label}-long{n[0]}",
                                [300 + n[0]] + long_p[1:],
                                SamplingParams(max_tokens=1),
                                lora=loras[7]))
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if walls is not None:
                walls.append((time.perf_counter() - t0) * 1e3)
        while eng.waiting or any(s.request is not None and not s.ready
                                 for s in eng.slots):
            eng.step()
    long_prefill()                      # the buckets' first use
    walls = []
    long_prefill(walls)
    prof, _ = profiled(long_prefill, f"lora {label} mixed profile")
    evs = device_events(prof)
    r0 = eng.ragged_ticks
    busy = sum(dev_us(e) for e in evs) / 1e3 / 3
    wall = statistics.median(walls)
    log(f"[lora {label}] mixed tick (~520 tokens) median {wall:.2f} ms "
        f"(all {[round(x, 2) for x in walls]}); kernels busy {busy:.2f} ms "
        f"a tick over a profile of 3 (ragged ticks so far {r0})")
    settle_engine(eng)
    return dict(tick_ms=wall, ticks_ms=walls, busy_ms=busy)


def registration_counts(eng, ads, label, first):
    """compiles and graph_captures across a registration: +1 and +0 at
    the first (the stacks' allocation; the graphs are released), +0 and
    +0 at a later one of the same ranks (written in place)."""
    c0, g0 = eng.compiles, eng.graph_captures
    t0 = time.perf_counter()
    eng.register_loras(ads)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dc, dg = eng.compiles - c0, eng.graph_captures - g0
    log(f"[lora {label}] {'first' if first else 'repeat'} registration of "
        f"{sorted(ads)} in {ms:.1f} ms: compiles +{dc}, graph captures "
        f"+{dg}; stacks {eng.stats()['lora_stack_bytes'] / 1e6:.1f} MB")
    if (dc, dg) != ((1, 0) if first else (0, 0)):
        raise AssertionError(f"{label}: registration moved compiles by {dc} "
                             f"and graph captures by {dg}")
    return dict(ms=ms, compiles=dc, graph_captures=dg)


def lora_kind(kind, params, ads):
    """One kind of pages: the default engine (graphs, lagged readback),
    the eager synchronous one and the gather one, adapters registered on
    each; greedy and sampled streams of the 8 requests: default against
    eager token-exact, against gather within the near-tie rules; the
    base / zero pair bit-equal; the base / strong pair different (greedy,
    bf16). Returns (the default engine, numbers)."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    kw = dict(LORA_KW, kv_dtype=kind)
    margin = NEAR_TIE_FP8 if kind == "fp8" else NEAR_TIE
    name = kind_label(kind)
    eng = InferenceEngine(EngineConfig(decode_impl="kernel", **kw),
                          params=params)
    res = {}
    if kind == "f32":
        # base only first, with no stacks: today's graph
        res["base_steady"] = steady_lora(eng, [None] * 8, f"{name} base")
        res["base_mixed"] = mixed_lora(eng, [None] * 8, f"{name} base")
        if eng._lora_stacks is not None or any(
                key[1] for key in eng._decode_graphs):
            raise AssertionError("an engine with no adapters ran LoRA work")
    res["registration"] = registration_counts(eng, ads, name, True)
    out = {}
    for mode in ("greedy", "sampled"):
        out["default", mode] = lora_streams(eng, kind, f"{name} default",
                                            mode)
    for which, extra in (("eager", dict(cuda_graph=False,
                                        async_readback=False)),
                         ("gather", dict(decode_impl="gather"))):
        other = InferenceEngine(EngineConfig(**dict(kw, **extra)),
                                params=params)
        other.register_loras(ads)
        for mode in ("greedy", "sampled"):
            out[which, mode] = lora_streams(
                other, kind, f"{name} {which}", mode,
                check=which == "eager")
        if which == "eager" and other.graph_captures:
            raise AssertionError(f"{name}: the eager engine captured")
        for mode in ("greedy", "sampled"):
            a, b = out["default", mode], out[which, mode]
            if which == "eager":
                if [r.output_tokens for r in a] != \
                        [r.output_tokens for r in b]:
                    raise AssertionError(f"{name} {mode}: default and "
                                         f"eager engines differ")
                log(f"[lora {name}] default vs eager, {mode}: token-exact")
            else:
                res[f"gather_{mode}_exact"] = compare_lora(
                    eng, other, a, b, f"lora {name} {mode}", margin, mode)
        other.release_graphs()
        del other
        gc.collect()
        torch.cuda.empty_cache()
    for mode in ("greedy", "sampled"):
        a = out["default", mode]
        if a[0].output_tokens != a[1].output_tokens:
            raise AssertionError(f"{name} {mode}: the zero adapter's tokens "
                                 f"differ from the base request's")
        if mode == "greedy" and a[2].output_tokens == a[3].output_tokens:
            raise AssertionError(f"{name}: the strong adapter's greedy "
                                 f"tokens equal the base model's")
    greedy = out["default", "greedy"]
    first = agreement([greedy[3].output_tokens],
                      [greedy[2].output_tokens])[1][0]
    log(f"[lora {name}] zero adapter bit-equal to base (greedy and sampled);"
        f" strong adapter's greedy tokens differ from base: first "
        f"divergence at output {first}")
    return eng, res


def prefix_bypass(eng):
    """Two requests with one 40-token prompt (2 full pages), the first on
    the strong adapter, the second on the base model, on a warm engine
    with the prefix cache on: the base request's tokens equal the same
    request's on a fresh engine (an adapter's pages are never shared)."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request, \
        SamplingParams
    gen = torch.Generator().manual_seed(4040)
    prompt = torch.randint(1000, 100000, (40,), generator=gen).tolist()
    sp = SamplingParams(max_tokens=16)
    eng.allocator.clear_cache()
    hits0 = eng.allocator.cache_hit_tokens
    first = eng.generate([list(prompt)], sp, loras=["strong"])[0]
    base = eng.generate([list(prompt)], sp)[0]
    fresh = InferenceEngine(EngineConfig(decode_impl="kernel", **LORA_KW),
                            params=eng.params)
    want = fresh.generate([list(prompt)], sp)[0]
    hits = eng.allocator.cache_hit_tokens - hits0
    log(f"[lora bf16] prefix bypass: adapter request then base request on "
        f"one 40-token prompt; base tokens equal a fresh engine's "
        f"{base.output_tokens == want.output_tokens}; cache hit tokens "
        f"{hits}; adapter tokens differ from base "
        f"{first.output_tokens != base.output_tokens}")
    if base.output_tokens != want.output_tokens or hits:
        raise AssertionError("a base request reused an adapter's KV pages")
    fresh.release_graphs()
    return dict(equal=True, hit_tokens=hits)


def multistep(params, ads, eng1, steady_k1):
    """decode_steps_per_call=4 on bf16 pages against `eng1` (K=1, the
    default bf16 engine, adapters registered): the 8 requests all base,
    then under LORA_MIX, greedy and sampled, MULTI_TOKENS tokens each
    and one stop token that cuts request 4 mid-round: step-exact. The
    first round of each K=4 graph (one a sampling mode, in the base
    drives) counts one capture and the others none; its capture time,
    its wall and its peak memory; steady rounds against K=1 ticks (ms a
    token, against `steady_k1`, eng1's ticks), and a guarded window of
    rounds."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    eng4 = InferenceEngine(EngineConfig(decode_impl="kernel",
                                        decode_steps_per_call=MULTI_K,
                                        **LORA_KW), params=params)
    eng4.register_loras(ads)
    first = first_round_probe(eng4)
    res = dict(exact={})
    for mix_name, mix in (("base", BASE_MIX), ("lora", LORA_MIX)):
        for mode in ("greedy", "sampled"):
            ref = lora_streams(eng1, "f32", f"bf16 K=1 {mix_name}", mode,
                               mix, MULTI_TOKENS)
            # a stop token from request 4's stream at output 9: a round
            # boundary is every 4 outputs after the first (prefill's)
            stops = {4: (ref[4].output_tokens[9],)}
            ref = lora_streams(eng1, "f32", f"bf16 K=1 {mix_name} stop",
                               mode, mix, MULTI_TOKENS, stops)
            g0 = eng4.graph_captures
            got = lora_streams(eng4, "f32", f"bf16 K=4 {mix_name}", mode,
                               mix, MULTI_TOKENS, stops)
            if [r.output_tokens for r in got] != \
                    [r.output_tokens for r in ref]:
                raise AssertionError(f"K=4 {mix_name} {mode}: not step-exact "
                                     f"against K=1")
            cut = got[4]
            if cut.finish_reason != "stop" or len(cut.output_tokens) > 10:
                raise AssertionError(f"K=4: request 4 did not stop mid-round "
                                     f"({cut.finish_reason}, "
                                     f"{len(cut.output_tokens)} tokens)")
            lens = sorted({len(r.output_tokens) for r in got})
            captures = eng4.graph_captures - g0
            log(f"[lora multistep] K=4 vs K=1, {mix_name} {mode}: step-exact;"
                f" output lengths {lens}, request 4 stopped after "
                f"{len(cut.output_tokens)}; graph captures +{captures}")
            if captures != (mix_name == "base"):
                raise AssertionError(f"K=4 {mix_name} {mode}: {captures} "
                                     f"graph captures")
            res["exact"][f"{mix_name}_{mode}"] = True
    del eng4._multi_decode             # the probe's synchronises end here
    graphs = {k: g for k, g in eng4._decode_graphs.items() if k[2] == MULTI_K}
    res["captures"] = {}
    for k, g in graphs.items():
        rnd = first[k[0]]
        res["captures"][str(k)] = dict(capture_ms=g.capture_s * 1e3, **rnd)
        log(f"[lora multistep] K=4 graph {k} (all_greedy, stacks, K): "
            f"capture {g.capture_s * 1e3:.1f} ms; its first round (K steps "
            f"eagerly, then the capture) {rnd['round_ms']:.1f} ms, peak "
            f"{rnd['peak_bytes'] / 2**20:.1f} MiB above the memory held "
            f"before it")
    if len(graphs) != 2 or eng4.graph_captures != len(eng4._decode_graphs):
        raise AssertionError(f"K=4 graphs {sorted(eng4._decode_graphs)}, "
                             f"captures {eng4.graph_captures}")
    res["steady_k1"] = steady_k1
    res["steady_k4"] = steady_lora(eng4, STEADY_MIX, "bf16 K=4 adapters",
                                   guard=True)
    k1, k4 = (res[k]["ms_a_token"] for k in ("steady_k1", "steady_k4"))
    log(f"[lora multistep] ms a token a slot: K=1 {k1:.3f}, K=4 {k4:.3f} "
        f"({k4 / k1:.3f}x)")
    res["flagged"] = log_flagged(eng4, "bf16 K=4")
    eng4.release_graphs()
    return res


def first_round_probe(eng):
    """Wrap eng._multi_decode: a round that captures a graph is timed to
    a synchronise, and its peak device memory above what was allocated
    before it is read. Returns {all_greedy: {round_ms, peak_bytes}},
    filled as rounds capture (delete the wrapper to end it)."""
    seen = {}
    own = eng._multi_decode

    def probe(touched):
        g0 = eng.graph_captures
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        own(touched)
        torch.cuda.synchronize()
        if eng.graph_captures > g0:
            seen[eng._all_greedy] = dict(
                round_ms=(time.perf_counter() - t0) * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated() - base)
    eng._multi_decode = probe
    return seen


def lora_server(ads):
    """LLMServerImpl with `lora_adapters` in its config (strong, mild):
    4 completions on them by `model` and 2 base ones at once; their
    tokens equal those of an engine driven directly (or differ at a near
    tie, as in phase 5); a live register_lora of "zero" then serves; an
    unknown model is an error."""
    import asyncio
    from ray_tpu_torch import (EngineConfig, InferenceEngine, LLMServerImpl,
                               Request, SamplingParams)
    srv = LLMServerImpl(dict(
        model_id="8b", model_source=SERVER_MODEL, engine_kwargs=SERVER_KW,
        lora_adapters={k: ads[k] for k in ("strong", "mild")}))
    eng = srv.engine
    submitted = []
    add = eng.add_request

    def recording(req):
        submitted.append(req)
        return add(req)
    eng.add_request = recording
    t = PROMPT_TEXTS
    bodies = [dict(prompt=t[1], model="strong"), dict(prompt=t[2],
                                                      model="strong"),
              dict(prompt=t[3], model="mild"), dict(prompt=t[5],
                                                    model="mild"),
              dict(prompt=t[3]), dict(prompt=t[5], model="8b")]
    for b in bodies:
        b.update(max_tokens=32, temperature=0.0)

    async def serve():
        outs = await asyncio.gather(*[srv.completions(dict(b))
                                      for b in bodies])
        names = await srv.register_lora("zero", ads["zero"])
        live = await srv.completions(dict(prompt=t[4], model="zero",
                                          max_tokens=32))
        info = await srv.model_info()
        return outs, names, live, info
    t0 = time.perf_counter()
    outs, names, live, info = asyncio.run(serve())
    wall = time.perf_counter() - t0
    del eng.add_request
    try:
        asyncio.run(srv.completions(dict(prompt="x", model="nope")))
        raise AssertionError("an unknown model was served")
    except ValueError as e:
        unknown = str(e)
    if names != ["mild", "strong", "zero"] or info["adapters"] != names:
        raise AssertionError(f"adapters {names}, listing {info['adapters']}")
    tok = srv.tokenizer
    by = {(tuple(r.prompt_tokens), r.lora): r for r in submitted}
    reqs = [by[(tuple(tok.encode(b["prompt"])),
                None if b.get("model") in (None, "8b") else b["model"])]
            for b in bodies] + [by[(tuple(tok.encode(t[4])), "zero")]]
    for r, o in zip(reqs, outs + [live]):
        if o["choices"][0]["text"] != tok.decode(r.output_tokens):
            raise AssertionError(f"{r.request_id}: response disagrees with "
                                 f"its tokens")
    ref = InferenceEngine(EngineConfig(model=SERVER_MODEL, **SERVER_KW),
                          params=eng.params)
    ref.register_loras(ads)
    rreqs = [Request(f"direct{i}", list(r.prompt_tokens), SamplingParams(
        max_tokens=32, stop_token_ids=r.params.stop_token_ids), lora=r.lora)
        for i, r in enumerate(reqs)]
    for r in rreqs:
        ref.add_request(r)
    while ref.has_work():
        ref.step()
    exact = compare_streams(eng, ref, [r.prompt_tokens for r in reqs],
                            [r.output_tokens for r in reqs],
                            [r.output_tokens for r in rreqs],
                            "lora server 8b", names=("server", "engine"),
                            loras=[r.lora for r in reqs])
    models = [b.get("model") for b in bodies]
    log(f"[lora server] {len(bodies)} completions at once ({models}) "
        f"in {wall:.2f} s, then a live register_lora -> {names} and a "
        f"'zero' completion; tokens vs a directly driven engine identical: "
        f"{exact}; unknown model: {unknown!r}")
    ref.release_graphs()
    eng.release_graphs()
    return dict(exact=exact, adapters=names, wall_s=wall)


def run_lora(dev, params):
    """Phase 5f: multi-LoRA serving and multi-step decode on the `8b`
    preset at full width and depth (the bf16 phase's weights, B 8, pages
    of 16, 1025 pages). Returns the numbers."""
    from ray_tpu_torch.models import llama
    cfg = llama.config("8b")
    ads = lora_adapters(cfg)
    out = dict(delta=check_lora_delta(dev, cfg))
    kinds = {}
    eng1 = None
    for kind in ("f32", "int8", "fp8"):
        eng, res = lora_kind(kind, params, ads)
        name = kind_label(kind)
        if kind == "f32":
            res["steady"] = steady_lora(eng, STEADY_MIX, f"{name} adapters",
                                        guard=True)
            res["mixed"] = mixed_lora(eng, STEADY_MIX, f"{name} adapters")
            base, lo = res["base_steady"], res["steady"]
            res["lora_launches_a_tick"] = lo["launches"] - base["launches"]
            res["stack_bytes"] = eng.stats()["lora_stack_bytes"]
            log(f"[lora {name}] steady decode tick base-only (no stacks) "
                f"{base['step_ms']:.3f} ms, kernels {base['busy_ms']:.3f} ms;"
                f" with 3 adapters active {lo['step_ms']:.3f} ms, kernels "
                f"{lo['busy_ms']:.3f} ms "
                f"(+{lo['step_ms'] - base['step_ms']:.3f} ms); LoRA "
                f"launches a tick "
                f"{res['lora_launches_a_tick']:.1f}; mixed tick "
                f"{res['base_mixed']['tick_ms']:.2f} -> "
                f"{res['mixed']['tick_ms']:.2f} ms, kernels "
                f"{res['base_mixed']['busy_ms']:.2f} -> "
                f"{res['mixed']['busy_ms']:.2f} ms; stacks "
                f"{res['stack_bytes'] / 1e6:.1f} MB")
            res["repeat_registration"] = registration_counts(
                eng, {"mild": ads["mild"]}, name, False)
            g0 = eng.graph_captures
            again = lora_streams(eng, kind, f"{name} after repeat",
                                 "greedy")
            if eng.graph_captures != g0:
                raise AssertionError("a registration of the same ranks "
                                     "forced a capture")
            res["prefix_bypass"] = prefix_bypass(eng)
            res["flagged"] = log_flagged(eng, name)
            eng1 = eng
            del again
        else:
            res["flagged"] = log_flagged(eng, name)
            eng.release_graphs()
            del eng
        kinds[name] = res
        gc.collect()
        torch.cuda.empty_cache()
    out["kinds"] = kinds
    out["multistep"] = multistep(params, ads, eng1, kinds["bf16"]["steady"])
    eng1.release_graphs()
    del eng1
    gc.collect()
    torch.cuda.empty_cache()
    out["server"] = lora_server(ads)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------ speculative decoding and legacy (5g)

SPEC_K = 4
SPEC_TOKENS = 64
LEGACY_TOKENS = 16
# the 8 requests of (a) and (b): PROMPT_TEXTS indices (14-1535 tokens)
SPEC_MIX = [4, 4, 5, 5, 0, 1, 2, 3]
# steady rounds skipped before the medians (first uses)
SPEC_WARM_ROUNDS = 2
SPEC_LAUNCHES: dict = {}


def spec_prompts():
    from ray_tpu_torch import ByteTokenizer
    tok = ByteTokenizer(128256)
    return [tok.encode(PROMPT_TEXTS[i]) for i in SPEC_MIX]


class RoundClock:
    """Around one engine's drive: the host ms of each speculative draft
    (`_spec_draft`), verify (the logits_all chunk forward) and catch-up
    sync (the hidden-emitting chunk forward outside a draft), each
    between two synchronises (a round reads back after its draft and
    after its verify anyway), and the draft dispatches."""

    def __init__(self, eng):
        from ray_tpu_torch.llm._internal import engine as em
        self.eng, self.em = eng, em
        self.ms = {"draft": [], "verify": [], "sync": []}
        self._own_draft = eng._spec_draft
        self._own_chunk = em.prefill_chunk
        self._in_draft = False

    def _timed(self, kind, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def __enter__(self):
        def draft(*a, **k):
            self._in_draft = True
            try:
                return self._timed("draft", self._own_draft, *a, **k)
            finally:
                self._in_draft = False

        def chunk(*a, **k):
            if self._in_draft:
                return self._own_chunk(*a, **k)
            kind = "verify" if k.get("emit") == "logits_all" else "sync"
            return self._timed(kind, self._own_chunk, *a, **k)

        self.eng._spec_draft = draft
        self.em.prefill_chunk = chunk
        return self

    def __exit__(self, *exc):
        del self.eng._spec_draft
        self.em.prefill_chunk = self._own_chunk

    def counts(self):
        return {k: len(v) for k, v in self.ms.items()}


def serve_at_once(eng, prompts, max_tokens, tag, clock=None, **sp):
    """All requests added at once, then steps to the end: each tick's
    wall (the step and a synchronise), whether it was a mixed tick, the
    dispatches it made, the speculative rounds it ran (slot rounds and
    emitted tokens) and, with a RoundClock, its draft/verify/sync ms."""
    from ray_tpu_torch import Request, SamplingParams
    reqs = [Request(f"{tag}{i}", list(p),
                    SamplingParams(max_tokens=max_tokens, **sp))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    sp_state = eng._spec
    ticks = []
    while eng.has_work():
        active = sum(1 for s in eng.slots if s.request is not None
                     and s.ready)
        r0, d0, dt0 = eng.ragged_ticks, eng.dispatches, eng.decode_ticks
        s0 = (sp_state["rounds"], sp_state["emitted"]) if sp_state else (0, 0)
        n0 = clock.counts() if clock else {}
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        t = dict(ms=(time.perf_counter() - t0) * 1e3,
                 mixed=eng.ragged_ticks > r0,
                 decode=eng.decode_ticks > dt0,
                 dispatches=eng.dispatches - d0, active=active)
        if sp_state:
            t["rounds"] = sp_state["rounds"] - s0[0]
            t["emitted"] = sp_state["emitted"] - s0[1]
        if clock:
            for k, n in clock.counts().items():
                t[k] = sum(clock.ms[k][n0[k]:n])
        ticks.append(t)
    return [r.output_tokens for r in reqs], ticks


def round_times(ticks, label):
    """Medians over the steady speculative rounds (ticks with a round and
    no mixed work, the first SPEC_WARM_ROUNDS left out): round ms, its
    draft / verify / sync / host parts, tokens a slot a round and ms a
    token a slot."""
    rounds = [t for t in ticks if t.get("rounds") and not t["mixed"]]
    rounds = rounds[SPEC_WARM_ROUNDS:] or rounds
    med = lambda key: statistics.median(key(t) for t in rounds)
    out = dict(
        n=len(rounds),
        round_ms=med(lambda t: t["ms"]),
        draft_ms=med(lambda t: t["draft"]),
        verify_ms=med(lambda t: t["verify"]),
        sync_ms=med(lambda t: t["sync"]),
        host_ms=med(lambda t: t["ms"] - t["draft"] - t["verify"]
                    - t["sync"]),
        tokens_a_slot=med(lambda t: t["emitted"] / max(t["active"], 1)),
        ms_a_token=med(lambda t: t["ms"] / max(t["emitted"] / max(
            t["active"], 1), 1e-9)))
    log(f"[spec {label}] {out['n']} steady rounds: round {out['round_ms']:.2f}"
        f" ms = draft {out['draft_ms']:.2f} + verify "
        f"{out['verify_ms']:.2f} + sync {out['sync_ms']:.2f} + host "
        f"{out['host_ms']:.2f} ms (medians); {out['tokens_a_slot']:.2f} "
        f"tokens a slot a round, {out['ms_a_token']:.2f} ms a token a slot")
    return out


def decode_tick_ms(ticks):
    """Median wall of the pure decode ticks of a default engine's drive."""
    dec = [t["ms"] for t in ticks if t["decode"] and not t["mixed"]]
    return statistics.median(dec[2:] or dec)


def spec_counts(eng, label, counts, n_draft, n_mixed, kernels):
    """A speculative drive's launches: the target's ragged kernel layers
    x mixed ticks, the draft's decode kernel draft layers x (k-2) x
    draft dispatches, all on the pipelined route, nothing else but the
    sampler's noise."""
    sp = eng._spec
    want = {"ragged_paged": eng.model_cfg.n_layers * n_mixed,
            "paged_decode": sp["cfg"].n_layers * (sp["k"] - 2) * n_draft}
    log(f"[spec {label}] launches {({k: n for k, n in counts.items() if n})}"
        f" ({n_draft} draft dispatches, {n_mixed} mixed ticks)")
    for name, n in counts.items():
        if name != "row_gumbel" and n != want.get(name, 0):
            raise AssertionError(f"spec {label}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    if min(want.values()) <= 0:
        raise AssertionError(f"spec {label}: a serving kernel never ran")
    check_decode_route(kernels, "paged_decode", want["paged_decode"])
    for k, n in counts.items():
        SPEC_LAUNCHES[k] = SPEC_LAUNCHES.get(k, 0) + n


def bf16_tie(logit):
    """The near-tie margin at a logit: NEAR_TIE, or two bf16 ulps at the
    logit's magnitude where that is wider (two bf16 paths' logits are
    not resolved finer: at logits in [4, 8) two ulps are 0.0625)."""
    ulp = 2.0 ** (math.floor(math.log2(max(abs(logit), 1e-30))) - 7)
    return max(NEAR_TIE, 2 * ulp)


def judge_streams(eng, teacher, prompts, out, ref_out, label,
                  names=("spec", "default")):
    """Phase 5's teacher-logits rule, with the engine under test judged
    against the plain teacher (the gather impl on the same weights, as
    phase 5's reference engine): where its greedy stream first leaves
    the reference engine's, its token must lie within a near tie
    (`bf16_tie` at the teacher's top logit) of the teacher-forced
    argmax. The reference engine's token is judged the same way and
    printed, not required: it is a bf16 path of its own. Returns
    whether the streams were identical."""
    nk, nr = names
    exact = out == ref_out
    log(f"[engine {label}] {nk} vs {nr} greedy streams identical: {exact}")
    beyond = []
    for i, (a, b) in enumerate(zip(out, ref_out)):
        if a == b:
            continue
        j = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        lg = teacher_logits(teacher, prompts[i] + a[:j])
        top = lg.topk(2)
        best = top.values[0].item()
        short_a = best - lg[a[j]].item()
        short_b = best - lg[b[j]].item()
        margin = bf16_tie(best)
        log(f"[engine {label}] request {i} diverges at output {j}: {nk} "
            f"token {a[j]} {short_a:.4f} below the {teacher.impl} "
            f"teacher's top, {nr} token {b[j]} {short_b:.4f} below it; "
            f"teacher top2 {top.indices.tolist()} "
            f"{[round(v, 4) for v in top.values.tolist()]} (near-tie "
            f"margin {margin:.4f})")
        if short_a > margin:
            beyond.append(i)
    if beyond:
        raise AssertionError(f"{label} requests {beyond}: the {nk} engine's "
                             f"token is beyond a near tie of the teacher's")
    return exact


def spec_drive(eng, prompts, label, ref_out, teacher):
    """One speculative engine's drive of the 8 greedy requests: tokens
    against the default engine's (`judge_streams`), its counters and
    launches, round times, peak memory."""
    from ray_tpu_torch.ops import _kernels
    eng.allocator.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    st0 = eng.stats()
    with RoundClock(eng) as clock:
        out, ticks = serve_at_once(eng, prompts, SPEC_TOKENS, f"sp{label}",
                                   clock=clock)
    counts = _kernels.launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    st = eng.stats()
    n_mixed = sum(t["mixed"] for t in ticks)
    spec_counts(eng, label, counts, len(clock.ms["draft"]), n_mixed,
                _kernels)
    exact = judge_streams(eng, teacher, prompts, out, ref_out,
                          f"spec {label}")
    for o in out:
        if len(o) != SPEC_TOKENS:
            raise AssertionError(f"spec {label}: a stream of {len(o)}")
    res = dict(exact=exact, spec_rounds=st["spec_rounds"],
               acceptance=st["spec_acceptance_rate"],
               tokens_per_round=st["spec_tokens_per_round"],
               dispatches=st["dispatches"] - st0["dispatches"],
               ticks=len(ticks), mixed_ticks=n_mixed,
               draft_dispatches=len(clock.ms["draft"]),
               syncs=len(clock.ms["sync"]), peak_bytes=peak,
               launches=counts, compile_cache=st["compile_cache"],
               rounds=round_times(ticks, label))
    log(f"[spec {label}] acceptance {res['acceptance']}, tokens a round "
        f"{res['tokens_per_round']} over {res['spec_rounds']} slot rounds; "
        f"{res['dispatches']} dispatches in {len(ticks)} ticks "
        f"({n_mixed} mixed, {res['syncs']} catch-up syncs); peak "
        f"{peak / 2**30:.3f} GiB above the engines as built; "
        f"compile cache {st['compile_cache']}")
    return res


def draft_decode_check(eng, gen, dev):
    """(c) The `1b` draft's decode step shape through kernel #2 (B 8, H
    32, KVH 8, D 64, pages of 16) on the draft's own layer-0 pools after
    its drive, at the 8 requests' final lengths, against
    paged_decode_with_new_token_plain: error, route, times, bound."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import paged_attention as pa
    sp = eng._spec
    dcfg = sp["cfg"]
    page = eng.config.page_size
    lens = [len(p) + SPEC_TOKENS for p in spec_prompts()]
    maxp = max(-(-n // page) for n in lens) + 1
    B, H, KVH, D = len(lens), dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    tables = torch.arange(B * maxp, dtype=torch.int32,
                          device=dev).reshape(B, maxp)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        dcfg.dtype)
    q, k_new, v_new = rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
    args = (q, sp["dk"][0], sp["dv"][0], tables, seq, k_new, v_new)
    kern = _kernels.PAGED_DECODE_BY_KIND[0]
    before = dict(kern.routes)
    out = pa.paged_decode_with_new_token(*args)
    ref = pa.paged_decode_with_new_token_plain(*args)
    torch.cuda.synchronize()
    route = [r for r, n in kern.routes.items() if n != before.get(r, 0)]
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= DECODE_TOL or route != ["pipelined"]:
        raise AssertionError(f"draft decode (D {D}): error {err} (tol "
                             f"{DECODE_TOL}), routes {route}")
    ms = time_ms(lambda: pa.paged_decode_with_new_token(*args))
    plain_ms = time_ms(lambda: pa.paged_decode_with_new_token_plain(*args),
                       iters=5)
    item = q.element_size()
    keys = sum(lens)
    nbytes = (2 * keys * KVH * D * item + 2 * B * H * D * item
              + 2 * B * KVH * D * item + B * 4)
    b_ms, b_by = bound(nbytes, 4 * H * D * (keys + B), q.dtype)
    log(f"[spec draft decode] 1b shape B {B}, H {H}, KVH {KVH}, D {D}, "
        f"lens {lens}: max_abs_err {err:.3e} (tol {DECODE_TOL}), route "
        f"{route[0]}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, route=route[0])


def spec_fallback(eng, ref_out, prompts, teacher):
    """(d) On the perfect-draft engine: a greedy request runs rounds, a
    sampled one joins (regular decode ticks) and leaves, the greedy one
    ends on rounds again after a catch-up sync; its stream against the
    default engine's for its prompt, by phase 5's rule."""
    from ray_tpu_torch import Request, SamplingParams
    eng.allocator.clear_cache()
    sp = eng._spec
    greedy = Request("fb-g", list(prompts[2]),
                     SamplingParams(max_tokens=SPEC_TOKENS))
    eng.add_request(greedy)
    for _ in range(4):
        eng.step()
    r0 = sp["rounds"]
    if r0 == 0:
        raise AssertionError("spec fallback: no round before the join")
    dt0 = eng.decode_ticks
    sampler = Request("fb-s", list(prompts[6]),
                      SamplingParams(max_tokens=16, **SAMPLED))
    eng.add_request(sampler)
    while not sampler.finished:
        eng.step()
    r1, fallback = sp["rounds"], eng.decode_ticks - dt0
    with RoundClock(eng) as clock:
        while not greedy.finished:
            eng.step()
    resumed = sp["rounds"] - r1
    synced = len(clock.ms["sync"])
    log(f"[spec fallback] {fallback} decode ticks while the sampled "
        f"request ran, rounds {r0} before, {r1 - r0} during, {resumed} "
        f"after; catch-up syncs after it left: {synced}")
    if fallback <= 0 or resumed <= 0 or not synced:
        raise AssertionError("spec fallback: no decode tick, no resumed "
                             "round or no catch-up sync")
    exact = judge_streams(eng, teacher, [prompts[2]],
                          [greedy.output_tokens], [ref_out[2]],
                          "spec fallback")
    return dict(exact=exact, fallback_ticks=fallback, rounds_after=resumed,
                sampled_tokens=len(sampler.output_tokens))


def drive_ticks(eng, prompts, max_tokens, tag):
    """`drive`'s arrivals (3 requests, then one a step), with a record a
    tick: its wall (the step and a synchronise), its dispatches, and
    whether it prefilled (a request waited or a slot was prefilling
    when it began)."""
    from ray_tpu_torch import Request, SamplingParams
    reqs = [Request(f"{tag}{i}", list(p), SamplingParams(
        max_tokens=max_tokens)) for i, p in enumerate(prompts)]
    for r in reqs[:3]:
        eng.add_request(r)
    pending = reqs[3:]
    ticks = []
    while eng.has_work() or pending:
        pre = bool(eng.waiting) or any(s.request is not None and not s.ready
                                       for s in eng.slots)
        d0 = eng.dispatches
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ticks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          dispatches=eng.dispatches - d0, prefill=pre))
        if pending:
            eng.add_request(pending.pop(0))
    return [r.output_tokens for r in reqs], ticks


def legacy_counts(eng, counts, routes, decode_ticks):
    """The legacy drive's launches (and `routes`, the decode launches by
    route, read right after it): no ragged kernel, the decode kernel
    layers x decode ticks on the pipelined route, nothing else."""
    want = {"paged_decode": eng.model_cfg.n_layers * decode_ticks}
    log(f"[legacy] launches {({k: n for k, n in counts.items() if n})} "
        f"({decode_ticks} decode ticks), decode routes {routes}")
    if not decode_ticks or any(n != want.get(k, 0)
                               for k, n in counts.items()):
        raise AssertionError(f"legacy launches {counts}, expected {want}")
    if routes != {"pipelined": want["paged_decode"]}:
        raise AssertionError(f"legacy decode routes {routes}: the "
                             f"pipelined kernel must take all of them")
    for k, n in counts.items():
        SPEC_LAUNCHES[k] = SPEC_LAUNCHES.get(k, 0) + n


def legacy_vs_unified(params, eng_u, teacher):
    """(e) The legacy step on phase 5's six prompts (16 tokens, 3 at
    once then one a step) against the default unified engine: tokens by
    phase 5's rule, launches (no ragged kernel; the decode kernel layers
    x decode ticks), dispatches a tick, and the wall of the ticks with a
    prefill (legacy) against the mixed ticks (unified)."""
    from ray_tpu_torch import ByteTokenizer, EngineConfig, InferenceEngine
    from ray_tpu_torch.ops import _kernels
    prompts = [ByteTokenizer(128256).encode(t) for t in PROMPT_TEXTS]

    def run(eng, tag):
        eng.allocator.clear_cache()
        _kernels.reset_launch_counts()
        d0, k0, dt0 = eng.dispatches, eng.ticks, eng.decode_ticks
        out, ticks = drive_ticks(eng, prompts, LEGACY_TOKENS, tag)
        return dict(out=out, ticks=ticks, counts=_kernels.launch_counts(),
                    routes=_kernels.route_counts().get("paged_decode", {}),
                    dispatches=eng.dispatches - d0, ticks_n=eng.ticks - k0,
                    decode_ticks=eng.decode_ticks - dt0)

    eng_l = InferenceEngine(EngineConfig(decode_impl="kernel",
                                         unified_step=False, **ENGINE_KW),
                            params=params)
    # each engine's drive twice: the first warms its forwards' shapes
    run(eng_l, "lw")
    leg = run(eng_l, "l")
    run(eng_u, "uw")
    uni = run(eng_u, "u")
    legacy_counts(eng_l, leg["counts"], leg["routes"], leg["decode_ticks"])
    exact = judge_streams(eng_l, teacher, prompts, leg["out"], uni["out"],
                          "legacy", names=("legacy", "unified"))
    med = lambda ts: statistics.median(t["ms"] for t in ts)
    pre_l = [t for t in leg["ticks"] if t["prefill"]]
    pre_u = [t for t in uni["ticks"] if t["prefill"]]
    res = dict(exact=exact, legacy_dispatches_per_tick=(
        leg["dispatches"] / leg["ticks_n"]),
        unified_dispatches_per_tick=uni["dispatches"] / uni["ticks_n"],
        legacy_ticks=leg["ticks_n"], unified_ticks=uni["ticks_n"],
        legacy_prefill_ticks=len(pre_l), unified_mixed_ticks=len(pre_u),
        legacy_prefill_tick_dispatches=sum(
            t["dispatches"] for t in pre_l) / len(pre_l),
        legacy_prefill_tick_ms=med(pre_l), unified_mixed_tick_ms=med(pre_u),
        legacy_decode_tick_ms=med([t for t in leg["ticks"]
                                   if not t["prefill"]]),
        legacy_wall_ms=sum(t["ms"] for t in leg["ticks"]),
        unified_wall_ms=sum(t["ms"] for t in uni["ticks"]),
        legacy_launches=leg["counts"])
    log(f"[legacy] dispatches a tick {res['legacy_dispatches_per_tick']:.3f}"
        f" ({leg['dispatches']} in {leg['ticks_n']} ticks; "
        f"{res['legacy_prefill_tick_dispatches']:.2f} in each of the "
        f"{len(pre_l)} ticks with a prefill) against unified "
        f"{res['unified_dispatches_per_tick']:.3f} ({uni['dispatches']} in "
        f"{uni['ticks_n']}); ticks with a prefill: legacy median "
        f"{res['legacy_prefill_tick_ms']:.2f} ms, unified mixed "
        f"{res['unified_mixed_tick_ms']:.2f} ms; legacy decode tick "
        f"{res['legacy_decode_tick_ms']:.2f} ms; drive wall "
        f"{res['legacy_wall_ms']:.1f} against {res['unified_wall_ms']:.1f}"
        f" ms; legacy ticks "
        f"{[(round(t['ms'], 1), t['dispatches']) for t in leg['ticks']]}")
    eng_l.release_graphs()
    del eng_l
    return res


def strict_small(prompts):
    """Exact parity at a small size, through the kernels: the `tiny`
    preset in float32 (4 layers, head_dim 64), 4 slots, prompts cut to
    200 tokens, 24 greedy tokens. The default engine's streams must be
    reproduced token for token by a speculative engine with a perfect
    draft (the target's own tensors), by one with a bf16 draft of the
    same widths and its own random weights (its decode steps on the
    pipelined kernel), and by the legacy step."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _kernels
    cfg = llama.config("tiny", dtype=torch.float32)
    kw = dict(model=cfg, max_batch_size=4, page_size=16,
              max_prefill_tokens=64, num_pages=129, seed=1,
              decode_impl="kernel")
    sp = [p[:200] for p in prompts]
    base = InferenceEngine(EngineConfig(**kw))
    want, _ = drive(base, sp, 24, "ss")
    draft16 = llama.config("tiny", dtype=torch.bfloat16)
    res = {}
    for name, over in (
            ("perfect draft", dict(speculative=dict(
                draft_model=cfg, draft_params=base.params,
                num_speculative_tokens=SPEC_K))),
            ("bf16 draft", dict(speculative=dict(
                draft_model=draft16, num_speculative_tokens=SPEC_K))),
            ("legacy", dict(unified_step=False))):
        eng = InferenceEngine(EngineConfig(**over, **kw), params=base.params)
        _kernels.reset_launch_counts()
        got, _ = drive(eng, sp, 24, "ss")
        counts = {k: n for k, n in _kernels.launch_counts().items() if n}
        st = eng.stats()
        log(f"[spec strict] tiny f32 {name}: identical to the default "
            f"engine: {got == want}; launches {counts}; routes "
            f"{_kernels.route_counts()}; spec rounds "
            f"{st.get('spec_rounds')}, acceptance "
            f"{st.get('spec_acceptance_rate')}")
        if got != want:
            raise AssertionError(f"spec strict {name}: {got} != {want}")
        if not counts.get("paged_decode"):
            raise AssertionError(f"spec strict {name}: no decode launch")
        if name == "bf16 draft" and "pipelined" not in \
                _kernels.route_counts().get("paged_decode", {}):
            raise AssertionError("spec strict: the bf16 draft's decode "
                                 "steps did not take the pipelined kernel")
        res[name] = dict(rounds=st.get("spec_rounds"),
                         acceptance=st.get("spec_acceptance_rate"),
                         launches=counts)
        eng.release_graphs()
    base.release_graphs()
    return res


def run_spec(dev, params):
    """Phase 5g: speculative decoding and the legacy step on the `8b`
    preset at full width and depth (the bf16 phase's weights, B 8, pages
    of 16, 1025 pages). Returns the numbers."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, SamplingParams
    prompts = spec_prompts()
    log(f"[spec] prompt lengths {[len(p) for p in prompts]}, "
        f"{SPEC_TOKENS} tokens each, k {SPEC_K}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5757)
    out = dict(strict=strict_small(prompts))
    eng_u = InferenceEngine(EngineConfig(decode_impl="kernel", **ENGINE_KW),
                            params=params)
    # phase 5's teacher: the gather impl on the same weights (its pools
    # unused: teacher_logits builds its own)
    teacher = InferenceEngine(EngineConfig(decode_impl="gather", **dict(
        ENGINE_KW, num_pages=2)), params=params)
    eng_u.generate([prompts[0]], SamplingParams(max_tokens=2))   # warm-up
    eng_u.allocator.clear_cache()
    ref, uticks = serve_at_once(eng_u, prompts, SPEC_TOKENS, "su")
    out["default_decode_tick_ms"] = decode_tick_ms(uticks)
    log(f"[spec] default engine: decode tick median "
        f"{out['default_decode_tick_ms']:.3f} ms over the same requests")

    def spec_engine(draft):
        eng = InferenceEngine(EngineConfig(
            decode_impl="kernel", speculative=dict(
                num_speculative_tokens=SPEC_K, **draft), **ENGINE_KW),
            params=params)
        eng.generate([prompts[0]], SamplingParams(max_tokens=2))
        return eng

    eng = spec_engine(dict(draft_model="8b", draft_params=params))
    if eng._spec["params"]["layers"]["wq"] is not params["layers"]["wq"]:
        raise AssertionError("the perfect draft copied the target's weights")
    out["perfect"] = spec_drive(eng, prompts, "perfect 8b draft", ref,
                                teacher)
    out["fallback"] = spec_fallback(eng, ref, prompts, teacher)
    eng.release_graphs()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = spec_engine(dict(draft_model="1b"))
    out["small"] = spec_drive(eng, prompts, "1b draft", ref, teacher)
    out["draft_decode"] = draft_decode_check(eng, gen, dev)
    eng.release_graphs()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["legacy"] = legacy_vs_unified(params, eng_u, teacher)
    tick = out["default_decode_tick_ms"]
    for name in ("perfect", "small"):
        r = out[name]["rounds"]
        log(f"[spec {name}] {r['ms_a_token']:.2f} ms a token a slot against "
            f"the default decode tick's {tick:.2f} ms "
            f"({r['ms_a_token'] / tick:.2f}x)")
    eng_u.release_graphs()
    del eng_u, teacher
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- train

TRAIN_LAYERS = 4        # full 8b width; depth cut so AdamW state fits 80 GB
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 8         # timed, after one warm-up step


def _sync_metrics(m):
    torch.cuda.synchronize()
    return {k: v.item() for k, v in m.items()}


def profile_step(bundle, state, tokens):
    """torch.profiler over one train step: the kernels with the most
    device time, and device busy time against wall time."""
    out = []

    def step():
        out.append(bundle.step(out[-1][0] if out else state, tokens))
    prof, wall = profiled(step, "profile train step")
    state, m = out[-1]
    evs = device_events(prof)
    busy = sum(dev_us(e) for e in evs) / 1e3
    log(f"[profile train step] kernels busy {busy:.2f} ms on the device; "
        f"wall under the profiler {wall:.2f} ms")
    groups = {g: r["ms"] for g, r in kernel_groups(evs).items()}
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile train step] {g:17s} {ms:9.3f} ms "
            f"({100 * ms / busy:.1f}%)")
    rows = []
    for e in sorted(evs, key=dev_us, reverse=True)[:12]:
        rows.append(dict(name=e.key[:90], device_ms=dev_us(e) / 1e3,
                         calls=e.count))
        log(f"[profile train step]   {dev_us(e) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return state, m, dict(profiled_wall_ms=wall, device_ms=busy, top=rows,
                          groups=groups)


def time_head(cfg, lm_head, dev):
    """The loss head on one chunk (B x loss_chunk tokens): the bf16-
    operand, float32-output product the port uses, forward and forward +
    backward, and the float32 product of upcast operands it avoids."""
    from ray_tpu_torch.models.llama import _head_logits
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((TRAIN_BATCH, cfg.loss_chunk, cfg.hidden), device=dev,
                    generator=gen).to(cfg.dtype)
    w = lm_head.detach().to(cfg.dtype)
    with torch.no_grad():
        fwd = time_ms(lambda: _head_logits(cfg, x, w), iters=10)
        upcast = time_ms(lambda: x.float() @ w.float(), iters=5)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    g = torch.randn((TRAIN_BATCH, cfg.loss_chunk, cfg.vocab_size),
                    device=dev, generator=gen)

    def fwd_bwd():
        torch.autograd.grad(_head_logits(cfg, xg, wg), (xg, wg), g)
    both = time_ms(fwd_bwd, iters=10)
    flops = 2 * TRAIN_BATCH * cfg.loss_chunk * cfg.hidden * cfg.vocab_size
    n = TRAIN_SEQ // cfg.loss_chunk
    log(f"[train head] one {TRAIN_BATCH}x{cfg.loss_chunk}-token chunk "
        f"({flops / 1e12:.2f} TFLOP a product): bf16 operands, float32 out "
        f"(torch.mm out_dtype) forward {fwd:.3f} ms "
        f"({flops / fwd / 1e9:.0f} TFLOP/s), forward+backward "
        f"{both:.3f} ms; float32 product of upcast operands {upcast:.3f} "
        f"ms; a step runs {n} chunks, each forward twice (chunk remat): "
        f"~{n * (fwd + both):.1f} ms")
    return dict(chunk_fwd_ms=fwd, chunk_fwd_bwd_ms=both,
                upcast_fwd_ms=upcast, step_ms=n * (fwd + both))


def run_train(dev):
    """The main path of this slice: TrainStepBundle on the 8b preset."""
    import numpy as np
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (TrainStepBundle,
                                               default_optimizer)
    from ray_tpu_torch.ops import _kernels
    cfg = llama.config("8b", n_layers=TRAIN_LAYERS, max_seq=TRAIN_SEQ)
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                            total_steps=100)
    bundle = TrainStepBundle(cfg, optimizer=opt)
    t0 = time.perf_counter()
    state = bundle.init_state(0)
    rng = np.random.default_rng(0)
    tokens = bundle.shard_batch(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32))
    torch.cuda.synchronize()
    log(f"[train] 8b widths, {cfg.n_layers} layers, "
        f"{cfg.num_params() / 1e9:.3f}B params (f32; bf16 compute; remat "
        f"{cfg.remat}; loss chunk {cfg.loss_chunk}; attention "
        f"{cfg.attention_impl!r}), batch {TRAIN_BATCH}x{TRAIN_SEQ}; init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps = []
    for i in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = bundle.step(state, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = _sync_metrics(m)
        steps.append(dict(ms=ms, **m))
        log(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{m['loss']:.5f} grad_norm {m['grad_norm']:.5f} "
            f"{ms:.1f} ms")
    counts = _kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(steps)
    # remat=True: each layer's checkpoint re-runs its forward (flash
    # forward included) in the backward, so the forward kernel runs twice
    # per layer per step and each backward kernel once; the loss-chunk
    # checkpoints hold no attention
    want = dict(flash_fwd=2 * cfg.n_layers * n, flash_dq=cfg.n_layers * n,
                flash_dkv=cfg.n_layers * n)
    log(f"[train] launches {counts} (expected {want})")
    for name, w in want.items():
        if counts[name] != w:
            raise AssertionError(f"train: {name} launched {counts[name]} "
                                 f"times, expected {w}")
    if any(n for name, n in counts.items() if not name.startswith("flash")):
        raise AssertionError("train: a serving kernel ran")
    for st in steps:
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
            raise AssertionError(f"train: non-finite metrics {st}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"train: loss did not fall "
                             f"({steps[0]['loss']} -> {steps[-1]['loss']})")
    timed = [st["ms"] for st in steps[1:]]
    step_ms = statistics.median(timed)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    fpt = llama.flops_per_token(cfg, TRAIN_SEQ)
    mfu = fpt * tok_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[train] step median {step_ms:.1f} ms (timed steps "
        f"{[round(x, 1) for x in timed]}); {tok_s:.0f} tokens/s; "
        f"{fpt * TRAIN_BATCH * TRAIN_SEQ / 1e12:.2f} TFLOP a step; MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    ev = _sync_metrics(bundle.eval_loss(state, tokens))
    log(f"[train] eval_loss after the run: {ev['loss']:.5f}")
    if not math.isfinite(ev["loss"]):
        raise AssertionError("train: eval loss not finite")
    head = time_head(cfg, state[0]["lm_head"], dev)
    # the same parameters through the kernel step (profiled) and an
    # attention_impl="xla" step: loss and grad norm must agree
    snap = _clone_tree(state[0])
    state, mk, prof = profile_step(bundle, state, tokens)
    mk = _sync_metrics(mk)
    del state
    torch.cuda.empty_cache()
    xb = TrainStepBundle(llama.config(cfg, attention_impl="xla"),
                         optimizer=opt)
    _, mx = xb.step((snap, opt.init(snap)), tokens)
    mx = _sync_metrics(mx)
    dl = abs(mk["loss"] - mx["loss"]) / abs(mx["loss"])
    dg = abs(mk["grad_norm"] - mx["grad_norm"]) / abs(mx["grad_norm"])
    log(f"[train] same parameters, kernel vs xla step: loss "
        f"{mk['loss']:.6f} vs {mx['loss']:.6f} (rel {dl:.2e}, tol "
        f"{TRAIN_LOSS_RTOL}); grad_norm {mk['grad_norm']:.6f} vs "
        f"{mx['grad_norm']:.6f} (rel {dg:.2e}, tol {TRAIN_GNORM_RTOL})")
    if not (dl <= TRAIN_LOSS_RTOL and dg <= TRAIN_GNORM_RTOL):
        raise AssertionError("train: kernel and xla steps disagree")
    return counts, dict(
        layers=cfg.n_layers, params=cfg.num_params(), batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=steps, step_ms_median=step_ms,
        tokens_per_s=tok_s, flops_per_step=fpt * TRAIN_BATCH * TRAIN_SEQ,
        mfu=mfu, peak_memory_bytes=peak, eval_loss=ev["loss"], head=head,
        kernel_vs_xla=dict(kernel=mk, xla=mx, loss_rel=dl, gnorm_rel=dg),
        profile=dict(prof, step_wall_ms=step_ms,
                     idle_share=max(0.0, 1 - prof["device_ms"] / step_ms)))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON to this file")
    ap.add_argument("--only", choices=["decode", "profiler"], default=None,
                    help="development: build, then only the decode "
                         "kernel's phase, or only the profiler-loss "
                         "check; prints their rows, not the result line "
                         "(the default run drives every path)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if args.only == "profiler":
        print(json.dumps(profiler_check()), flush=True)
        return
    from ray_tpu_torch.ops import _kernels   # fails outside the repo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(f"[card] {name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    info = _kernels.build(verbose=True)
    log(f"[build] {info['compiled']} in {time.perf_counter() - t0:.1f} s "
        f"into {info['dir']}")
    decode_isa = decode_ptxas(info)
    if len(decode_isa) != 6:
        raise AssertionError(f"expected 6 instances of the pipelined "
                             f"decode kernel (bf16, int8, fp8 pages x D "
                             f"64, 128), ptxas showed {len(decode_isa)}")
    t_kernels = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    decode = {}
    for kind in (None, "int8", "fp8"):
        decode[kind or "bf16"] = dict(
            wide=check_decode(gen, dev, "512-page table",
                              [0, 17, 256, 1000, 2049, 3000, 4095, 4096],
                              512, kind),
            narrow=check_decode(gen, dev, "8-page table",
                                [1, 3, 16, 17, 64, 100, 127, 128], 8, kind))
    if args.only == "decode":
        print(json.dumps(dict(decode=decode, ptxas=decode_isa, card=card)),
              flush=True)
        return
    wide, narrow = decode["bf16"]["wide"], decode["bf16"]["narrow"]
    tensor_cores = check_tensor_cores(info)
    ragged, ragged_ticks = check_ragged(gen, dev)
    quant, quant_ticks = {}, {}
    for kind in ("int8", "fp8"):
        quant[kind] = dict(decode[kind])
        quant[kind]["ragged"], quant_ticks[kind] = check_ragged(gen, dev,
                                                                kind)
    noise = check_noise(dev)
    flash = check_flash(gen, dev)
    ticks = dict(bf16=ragged_ticks, **quant_ticks)
    phase_s = {"3-4": time.perf_counter() - t_kernels}
    t0 = time.perf_counter()
    counts, engine, params, out_bf16, graph_f32 = run_engine(dev)
    graph_sides = dict(f32=graph_f32)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5"] = time.perf_counter() - t0
    quant_counts, quant_engine = {}, {}
    for kind in ("int8", "fp8"):
        t0 = time.perf_counter()
        quant_counts[kind], quant_engine[kind], graph_sides[kind] = \
            run_quant_engine(dev, kind, params, out_bf16)
        gc.collect()
        torch.cuda.empty_cache()
        phase_s[f"5b {kind}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tick_mechanics = run_tick_mechanics(dev, params, graph_sides)
    noise_launches = graph_f32[2]["sampled"]["launches"]["row_gumbel"]
    phase_s["5c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kv_hierarchy = run_kv_hierarchy(params)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lora = run_lora(dev, params)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = run_spec(dev, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = run_server()
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_counts, train = run_train(dev)
    phase_s["6"] = time.perf_counter() - t0
    log(f"[phases] seconds: {({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"[profiler] {PROFILES['windows']} profile windows, "
        f"{PROFILES['lost']} of them lost records and were taken again")
    src = "ray_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="ragged_paged", route="cuda", source=src + "ragged_paged.cu",
             replaces="ray_tpu/ops/ragged_paged_attention.py:183",
             launches=counts["ragged_paged"], **ragged),
        dict(name="paged_decode", route="cuda", source=src + "paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:225",
             launches=counts["paged_decode"], **wide),
        dict(name="paged_decode_narrow_table", route="cuda",
             source=src + "paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:158",
             launches=counts["paged_decode"], **narrow),
    ]
    # the quantized branches of the same three Pallas kernels
    for kind in ("int8", "fp8"):
        q, n = quant[kind], quant_counts[kind]
        kernels += [
            dict(name=f"ragged_paged_{kind}", route="cuda",
                 source=src + "ragged_paged.cu",
                 replaces="ray_tpu/ops/ragged_paged_attention.py:183",
                 launches=n[f"ragged_paged_{kind}"], **q["ragged"]),
            dict(name=f"paged_decode_{kind}", route="cuda",
                 source=src + "paged_decode.cu",
                 replaces="ray_tpu/ops/paged_attention.py:225",
                 launches=n[f"paged_decode_{kind}"], **q["wide"]),
            dict(name=f"paged_decode_narrow_table_{kind}", route="cuda",
                 source=src + "paged_decode.cu",
                 replaces="ray_tpu/ops/paged_attention.py:158",
                 launches=n[f"paged_decode_{kind}"], **q["narrow"]),
        ]
    for kname, line in (("flash_fwd", 81), ("flash_dq", 202),
                        ("flash_dkv", 230)):
        kernels.append(dict(name=kname, route="cuda",
                            source=src + "flash_attention.cu",
                            replaces=f"ray_tpu/ops/attention.py:{line}",
                            launches=train_counts[kname], **flash[kname]))
    # not a Pallas kernel: the sampler's threefry noise, which the
    # reference leaves to XLA (jax.random.categorical at this line)
    kernels.append(dict(name="row_gumbel", route="cuda",
                        source=src + "threefry.cu",
                        replaces="ray_tpu/llm/_internal/engine.py:464",
                        launches=noise_launches, **noise))
    # phase 5f's main path (multi-LoRA and multi-step drives) launches
    for k in kernels:
        base = k["name"].replace("_narrow_table", "")
        if base in LORA_LAUNCHES:
            k["launches_lora_multistep"] = LORA_LAUNCHES[base]
    # phase 5g's main paths (speculative and legacy drives) launches
    for k in kernels:
        base = k["name"].replace("_narrow_table", "")
        if base in SPEC_LAUNCHES:
            k["launches_spec_legacy"] = SPEC_LAUNCHES[base]
    summary = {"kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(summary, card=card, ragged_ticks=ticks,
                           engine=engine,
                           quant_engine=quant_engine, train=train,
                           tick_mechanics=tick_mechanics,
                           kv_hierarchy=kv_hierarchy, server=server,
                           lora=lora, spec=spec,
                           profiles=PROFILES,
                           tensor_cores=tensor_cores,
                           decode_ptxas=decode_isa), f, indent=1)
    print(json.dumps(summary), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
