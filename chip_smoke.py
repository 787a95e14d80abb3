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
  5b. quantized engine: the same on int8 and then fp8 KV pages, on the
     first QUANT_LAYERS (4) of the same weights' 32 layers (the int8
     and fp8 drives of 5b, 5c, 5d and 5f all run that depth; bf16 keeps
     32): the kind's launch counters equal layers x ticks and every
     other counter stays 0; kernel vs gather as in 5 (fp8 with its own
     near-tie margin); a small f32 engine on int8 pages token-exact;
     decode tick, kernel device time a tick and pool bytes printed;
  5c. decode tick mechanics: on bf16, int8 and fp8 pages (same weights;
     int8 and fp8 at QUANT_LAYERS layers), the default engines of
     phases 5 and 5b (one CUDA graph
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
     default engines; bf16 at full depth, int8 and fp8 on the first
     QUANT_LAYERS, 4, of the 32 layers): 16 seeded prompts of 240-720
     tokens,
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
     adapter, prompts of 14-1535 tokens, 32 tokens), greedy and sampled,
     on bf16 pages at full depth and on int8 and fp8 pages at
     QUANT_LAYERS (4) layers (the adapters cut alike): the default
     engine against
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
  5h. the serving fleet: two LLMServerImpl replicas r0 and r1 on the
     `8b` preset at full width and depth, both engines on the bf16
     phase's weight tensors (shared; B 8, pages of 16, 1025 pages, the
     host tier on), behind FleetManager over LocalReplicaClients, one
     tick at a time on the card (the engines share the device's lock):
     (a) 12 greedy requests of 64 tokens in flight together, two groups
     of 3 sharing a 1024-character prefix (RouterConfig prefix_depth
     1024) and phase 5's 6 prompts, half through dispatch and half
     through dispatch_stream, a cold pass then the timed one: each group
     on one replica, its followers hitting that replica's prefix cache;
     the same 12 on r0 alone and round-robin over both; (b) a chaos
     client severs a greedy and a sampled stream on r0 after 16 tokens:
     both continue on r1, r0 evicted; (c) _apply_target(1) while each
     replica serves 2 streams: the victim's sessions ship over the RTKV
     wire; (d) roles prefill/decode: the 1535-token prompt prefills on
     r0 and decodes on r1, a short prompt takes no handoff; (e) the
     prefix store under round-robin routing: a prefix published by r0
     seeded into r1 and hit there; (f) status rows (chips 1 each,
     active chips 2), the merged exposition with the JAX fleet family
     names, 16 guarded decode ticks on r0 while r1 serves 4 streams
     (no upload, no capture, one readback and one cudaGraphLaunch a
     tick), graph captures per replica and no engine crash. Every
     stream's tokens against an engine driven directly on the same
     weights (phase 5's near-tie rule; phase 5d's pickable rule for the
     sampled one); launches of #1/#2 = layers x mixed / decode ticks
     summed over both replicas in each drive; fleet tokens/s, TTFT,
     TPOT, peak memory, the ships' ms split by stage and their GB/s;
  5i. the thread sanitizer on the main path: the `8b` engine (phase 5's
     bf16 weights, full depth) serves phase 5's six prompts greedily,
     240 tokens each, disarmed and then built and driven with the
     sanitizer armed (its step lock the device's traced re-entrant lock,
     engine._step_lock[cuda:N], over the device's RLock); in each, 16
     timed steady decode ticks, then 200 graph-replayed decode ticks in
     dispatch_guard windows of 8 (armed: while 3 threads call stats,
     lane_counts, session_ids, fleet_counters, has_work, and abort,
     preempt and export_session of unknown ids): 1 dispatch a tick, no
     compile, upload or capture, 1 readback a tick, paged_decode layers x
     200 launches, all pipelined; armed: no violation, tokens equal to
     the disarmed engine's; the decode tick ms armed against disarmed
     and the lock's re-entries by the function that made them;
  6. train: TrainStepBundle on the `8b` preset at full width, 4 layers
     (random f32 parameters from a seeded generator, bf16 compute,
     remat, loss chunk 512), batch 4 x 2048 tokens: a warm-up step and
     8 timed steps through init_state/step; losses finite and falling;
     the three flash kernels' launch counters as remat implies; step
     time, tokens/s, MFU, peak memory and a profiler breakdown; one
     step on attention_impl="xla" from the same parameters must agree;
     one step each under remat_policy "dots_no_batch" (the default:
     the outputs of products with no batch dimension kept) and
     "nothing" from the same parameters, ms and peak memory above the
     state beside each other: the same loss, grad norms within
     TRAIN_GNORM_RTOL;
  6b. MoE training: TrainStepBundle on the `8x7b` preset (Mixtral-8x7B
     widths: 8 experts, top-2, capacity factor 1.25) at full width, 2
     layers (seeded random f32 parameters, bf16 compute, remat
     "dots_no_batch", loss chunk 512), batch 4 x 2048: a warm-up step
     and 8 timed steps; losses finite and falling, moe_aux finite and
     positive; the flash launch counters as remat implies; step ms,
     tokens/s, MFU (active experts), peak memory, a profile by group
     (the float32 one-hot dispatch and combine products apart from the
     bf16 expert products); then, through llama.loss_fn and
     torch.autograd.grad on the trained parameters with no optimizer
     state: attention_impl="xla" against the kernels, and the dropless
     path against the capacity path at capacity factor E / top_k (no
     drops) at batch 1 x 2048, each within phase 6's tolerances; the
     grouped expert product of torch._grouped_mm against the port's
     per-expert loop at these widths (two bf16 ulps), with both times;
  6c. checkpoints: an `8b`-width tree of 2 layers in bf16 from a seeded
     generator written by save_llama_checkpoint (with config.json) into
     a temporary directory (removed after), write and read GB/s; an
     engine with checkpoint= and model=None (the architecture from
     config.json) decodes phase 5's six prompts greedily token-exact
     against an engine on the source tensors; init_state_from_checkpoint
     at float32: parameters bit-equal to the upcast source, and one step
     the same loss as a bundle from state_from_numpy on those values;
  6d. RLlib's single-learner path (ray_tpu_torch.rllib), runner and
     learner on the card: (a) PPO on CartPole-v1 at the CPU tests'
     learning gate's configuration (16 envs x 128, minibatch 256, 4
     epochs, seed 0): best return > 120 within 25 iterations, and its
     first fragment against a CPU runner's of the same seed and weights
     by the runner test's near-tie rule; (b) PPO at 4096 envs x 128
     (524 288 env steps an iteration, minibatch 16384, 4 epochs): a warm
     iteration, then 3 timed: sample, update and iteration ms, env
     steps/s, kernel launches a rollout step (profiler), the step loop
     run under set_sync_debug_mode("error") (0 host syncs), an
     iteration's device idle share, peak memory; (c) 5 iterations each
     of IMPALA, APPO and DQN on CartPole and 3 of CNN PPO on the pixel
     catch env at their tests' configurations: finite losses, returns;
     (d) the kernels' launch counters unchanged (the path launches
     none of them);
  6e. the rest of RLlib on the card: (a) SAC on Pendulum-v1 at
     test_sac_learns_pendulum's configuration (16 envs x 64, batch 256,
     32 updates, seed 0) from the JAX learner's initial weights
     (chip_smoke_data/, as the CPU test starts): best of the returns
     after the fifth > the first + 150 within 25 iterations; (b) SAC at
     1024 envs x 64 steps, train batch 4096, 32 updates: sample, update
     and iteration ms, kernel launches an update step (profiler), 0 host
     syncs in it (set_sync_debug_mode("error")), an iteration's device
     idle share; (c) BC (loss falls over 2 iterations) and MARWIL (value
     loss falls, mean weight != 1, 5 iterations) from CartPole shards
     fresh PPO runners record on the card at the tests' configurations; (d) CQL (penalty falls over 7
     iterations) from Pendulum transitions the trained SAC records on the
     card; (e) DreamerV3 on CartPole at its test's configuration and the
     default widths (deter 256, stoch 8 x 8, units 128): best > 120
     within 120 iterations after the first, then one update's observe,
     imagine and whole ms and kernel launches; (f) multi-agent PPO on
     DualCartPole, two policies, 16 envs x 128: both agents' best > 60
     within 24 iterations after the first; (g) the kernels' launch
     counters unchanged across 6e;
  6f. the actor runtime with the GPU as a pinned resource: (a)
     ray_tpu_torch.init() with no resource arguments detects GPU 1 and
     the GPU-<type> resource; (b) a num_gpus=1 task returns its
     CUDA_VISIBLE_DEVICES, the card's name (equal to this process's) and
     a CUDA tensor that arrives on the CPU bit-equal to the same
     elementwise computation here on the card; (c) a num_gpus=1
     actor builds the `8b` engine at full width and depth (phase 5's
     configuration: the same seeded bf16 weights) from the kernels
     phase 2 built (no compile, its cwd outside the checkout) and
     serves phase 5's warm-up and six prompts greedily through actor
     method calls: tokens equal phase 5's (near-tie rule, the actor's
     teacher logits), its own launch counters #1 = layers x mixed
     ticks and #2/#3 = layers x decode ticks; actor creation to engine
     ready, first request to first token and the tick median against
     phase 5's, peak memory of both processes; (d) while it holds the
     card a second num_gpus=1 actor stays pending, and after kill of
     the first it starts in a fresh fork of the zygote with no CUDA
     context and initializes CUDA; (e) host numbers of the runtime
     beside this card: tasks/s of 2 000 empty tasks, the round trip of
     1 000 empty actor calls (p50, p99 us), put and get GB/s of a 1 GiB
     bf16 CPU tensor, and the ms of a 256 MiB CUDA tensor returned
     from a GPU task; (f) this process's launch counters unchanged
     across 6f; the runtime stays up for 6g;
  6g. the libraries on 6f's runtime: (a)
     TorchTrainer with ScalingConfig(num_workers=1, use_gpu=True) runs
     phase 6's configuration (the `8b` preset at full width,
     TRAIN_LAYERS layers, seed 0, the same tokens, a warm-up and
     TRAIN_STEPS timed steps) in a TrainWorker pinned to the card, each
     step reported through train.report: losses equal phase 6's step
     for step within TRAIN_LOSS_RTOL (bit-equality printed); the
     worker's launch counters flash_fwd 2 x layers x steps, flash_dq
     and flash_dkv layers x steps, no other kernel; this process's
     counters unchanged; the step median against phase 6's here and PR
     14's 337.85 ms, tokens/s, fit() to the first report, the worker's
     peak memory; (b) a resume drill at LIB_DRILL's configuration (the
     `tiny` preset, 2 layers, no remat; FailureConfig(max_failures=1),
     CheckpointConfig(num_to_keep=2)): every step saves parameters and
     AdamW's state with Checkpoint.save_pytree and reports them, the
     first attempt raises once after step LIB_DRILL_FAIL_AFTER, the
     second resumes from train.get_checkpoint(): every loss bit-equal to
     an uninterrupted run of the same loop on the card, two checkpoint
     directories kept; parameter count, checkpoint bytes and the ms to
     pack one in an actor and fetch it; (c) PPO on CartPole-v1 at 6d(a)'s
     configuration with num_env_runners=2 and num_learners=2 (runner and
     learner actors on the card, their device and CUDA_VISIBLE_DEVICES
     printed): best return > 120 within 25 iterations; sample, update
     and iteration ms against 6d(a)'s local path, timed here; IMPALA
     with 2 async remote runners, LIB_IMPALA_ITERS iterations, finite
     losses; (d) Tuner over a GPU TorchTrainer at (b)'s configuration,
     lr grid_search over LIB_TUNE_LRS, LIB_TUNE_STEPS steps a trial,
     max_concurrent_trials 1: 2 results, no errors, the larger lr best,
     each trial's wall; the runtime stays up for 6h;
  6h. the Serve plane on the runtime: (a) build_openai_app over phase
     5e's configuration (the `8b` preset at full width and depth, seed
     0, SERVER_KW) with accelerator_type the card's GPU-<type>, so its
     LLMServer replica is a num_gpus=1 actor (working directory outside
     the checkout), deployed by serve.run(route_prefix="/") behind the
     HTTP proxy: the replica alone joins this process on the card (its
     device nodes open, read from /proc), its engine on CUDA pinned
     with CUDA_VISIBLE_DEVICES=0; GET /v1/models; a warm-up stream for
     the first request's first token; a cold pass of the 12 bodies
     shifted by two characters (the fresh process's first use of its
     shapes and the anomaly detector's warm-up, no page shared with what
     follows); 5e's 12 bodies at once over HTTP
     (8 completions, 2 chats, 2 SSE streams): 200s of the reference's
     shape, completion_tokens as 5e's, streams ending in [DONE], each
     text the decode of 5e's tokens or of (b)'s for the body; an
     unknown model 404; /metrics with the JAX family names; /stats's
     launch counters #1 = layers x mixed ticks and #2/#3 = layers x
     decode ticks, all pipelined; serve.run to RUNNING, TTFT/TPOT
     p50/p99 from the replica's lifecycles and over HTTP against 5e's,
     tokens/s; delete, and the card released; (b) build_llm_fleet_app
     on one such replica behind HTTP: the 12 bodies as SSE streams
     whose token_ids equal 5e's tokens (a first difference within
     phase 5's near tie by the teacher logits of a num_gpus=1 task on
     the gather impl, run after the apps are gone), two unary calls
     equal to their streams, /fleet one ACTIVE replica of 1 chip,
     /fleet/debug/events, /metrics with the JAX fleet families, the
     launches as in (a); (c) the LLMServer replica's actor killed: the
     controller starts a new one, which pins the released card and
     serves SERVE_PROBE (a greedy body (b) served alone after its 12)
     with (b)'s tokens; kill to the next token;
     then delete, serve.shutdown() and the runtime's shutdown, with no
     rtpu_* segment left and this process's counters unchanged;
  7. summary: one {"kernels": [...], "phase_seconds": {...}} line (each
     row with the actor's launches of phase 6f, the TrainWorker's of 6g
     and the serve replicas' of 6h), the card line, then the
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


T_START = time.perf_counter()


def log(*a):
    """A line of the run's log, after the seconds since the script's
    start (where the run's time goes)."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


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
    A profile that holds no such kernel, or whose launches are not a
    whole number a call, lost records (profiled takes it again); where
    every window lost records, the time is CUDA events' over `calls`
    calls enqueued back to back (kernels queued behind each other, so
    the wrapper's host work hides behind the device's), and by_kernel
    gives that time under one row."""
    fn()

    def short(evs):
        mine = [e for e in evs if any(k in e.key for k in keys)]
        return [(e.key[:40], e.count) for e in mine
                if e.count % calls] or (not mine and "no launch")
    try:
        prof, _ = profiled(lambda: repeat(fn, calls), f"device_ms {keys}",
                           check=short)
    except ProfileLost:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        repeat(fn, calls)
        e.record()
        e.synchronize()
        total = s.elapsed_time(e) / calls
        PROFILES["event_timed"].append(str(keys))
        log(f"[profiler] device_ms {keys}: CUDA events over {calls} calls "
            f"back to back instead: {total:.4f} ms a call")
        row = {f"{'/'.join(keys)} (CUDA events, a whole call)": total}
        return (total, row) if by_kernel else total
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


def run_quant_engine(dev, kind, params):
    """The 8b engine on `kind` (int8/fp8) KV pages at QUANT_LAYERS layers
    of the bf16 phase's weights (`kind_model`): the kind's kernels on the
    main path (counters equal layers x ticks, the bf16 counters
    untouched), kernel vs gather greedy streams (near ties allowed, as in
    the bf16 phase), and a small f32 engine on the same pages token-exact
    between the impls. The engine is the default one, and so also phase
    5c's graph side."""
    from ray_tpu_torch import ByteTokenizer, EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    model, params = kind_model(kind, params)
    kw = dict(ENGINE_KW, kv_dtype=kind, model=model)
    eng = InferenceEngine(EngineConfig(decode_impl="kernel", **kw),
                          params=params)
    out_k, out_s, graph = serve_streams(eng, kind, prompts, f"graph {kind}")
    counts = graph["greedy"]["launches"]
    ticks_k = graph["greedy"]["ticks_ms"]
    nbytes = pool_bytes(eng)
    log(f"[engine {kind}] {eng.model_cfg.n_layers} layers; pools "
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
                        layers=eng.model_cfg.n_layers, pool_bytes=nbytes,
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


# profile windows this run, those that lost a record, the report-only
# windows that kept a short profile, and the device_ms calls timed with
# CUDA events instead
PROFILES = dict(windows=0, lost=0, short_kept=[], event_timed=[])
PROFILE_ATTEMPTS = 3
PROFILE_PAUSE_S = 0.5   # idle time before a profile is taken again


class ProfileLost(AssertionError):
    """Every window of a profiled() call lost records."""


def profiled(window, label, host=False, check=None, report=False):
    """traced(window) with a check of the records: by default every
    hand-written kernel's launches against the launch counters
    (lost_records); `check(evs)` returns what is missing instead. A
    profile that lost records is taken again, after PROFILE_PAUSE_S of
    idle time, over the next call of `window` (equivalent work: more
    steady ticks, another train step, the same kernel calls), at most
    PROFILE_ATTEMPTS windows; then ProfileLost fails the run. With
    `report` (a window whose profile only gives printed numbers: busy
    time, idle share, launches), the last profile is kept instead, named
    in PROFILES["short_kept"]: its device times are lower bounds. Every
    loss is printed (ROADMAP §C: the profiler at times loses records,
    and on one card lost a short window's in several sessions in a
    row)."""
    from ray_tpu_torch.ops import _kernels
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            time.sleep(PROFILE_PAUSE_S)
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
    if report:
        PROFILES["short_kept"].append(label)
        log(f"[profiler] {label}: every window lost records; the last "
            f"profile is kept and its device times are lower bounds")
        return prof, wall
    raise ProfileLost(f"{label}: {PROFILE_ATTEMPTS} profiles lost records")


def kernel_groups(evs):
    """The profiler's kernel rows by group: {group: {ms, launches}}."""
    groups = {}
    for e in evs:
        key = e.key.lower()
        g = ("flash kernels" if "flash_" in key else
             "serving attention" if ("ragged" in key
                                     or "paged_decode" in key) else
             "noise kernel" if "row_gumbel" in key else
             "float32 matmuls" if ("sgemm" in key
                                   or "f32f32_f32f32" in key) else
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
    kernels' launches in the profile are held to the launch counters'
    (profiled's records check; a report window)."""
    prof, wall = profiled(lambda: repeat(eng.step, n_ticks),
                          f"profile {label}", report=True)
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
                               f"ticks {label} profile", report=True)
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
    model, params = kind_model(kind, params)
    eng = InferenceEngine(EngineConfig(
        decode_impl="kernel", kv_dtype=kind, cuda_graph=False,
        async_readback=False, **dict(ENGINE_KW, model=model)),
        params=params)
    label = f"eager {kind}"
    greedy, sampled, res = serve_streams(eng, kind, prompts, label)
    res["steady"] = steady_decode(eng, label, guard=False)
    if eng.stats()["graph_captures"]:
        raise AssertionError(f"{label}: the eager engine captured a graph")
    del eng
    return greedy, sampled, res


def run_tick_mechanics(dev, params, graph_sides):
    """Phase 5c: the decode tick's mechanics at 8b on bf16 pages (full
    depth) and int8 and fp8 pages (QUANT_LAYERS layers) with the bf16
    phase's weights: the default
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


# the int8 and fp8 drives of 5b, 5c, 5d and 5f run the first
# QUANT_LAYERS layers of the 8b tree (bf16 pages keep the full 32): the
# quantized pages' path is the same at every layer, and the depth is
# what the card's time went to
QUANT_LAYERS = 4


def kind_model(kind, params):
    """(model, params) of `kind`'s engines in 5b-5d and 5f: the `8b`
    preset on bf16 pages; on int8/fp8 pages its first QUANT_LAYERS
    layers (views of the same tensors)."""
    if kind == "f32":
        return "8b", params
    from ray_tpu_torch.models import llama
    cut = dict(params, layers={k: v[:QUANT_LAYERS]
                               for k, v in params["layers"].items()})
    return llama.config("8b", n_layers=QUANT_LAYERS), cut


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
        KV_KW, num_pages=257, kv_dtype=kind, enable_kv_offload=True,
        model=eng.model_cfg)), params=params)
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
        model, kparams = kind_model(kind, params)
        eng = InferenceEngine(EngineConfig(
            decode_impl="kernel", **dict(OVERSUB_KW, kv_dtype=kind,
                                         model=model)), params=kparams)
        ample = InferenceEngine(EngineConfig(
            decode_impl="kernel", **dict(KV_KW, kv_dtype=kind,
                                         model=model)), params=kparams)
        res = dict(runs=oversubscribe(eng, ample, kind, modes))
        ample.release_graphs()
        del ample
        res["guard"] = steady_guard(eng, kind)
        res["manual"] = manual_preempt(eng, kind)
        res["moves"] = time_moves(eng, kind)
        res["transport"] = transport(eng, kparams, kind, frames)
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
                body_tokens=[list(r.output_tokens) for r in reqs],
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
LORA_TOKENS = 32        # output tokens a request in the 8-request drives
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
                       f"lora {label} profile", report=True)
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
    prof, _ = profiled(long_prefill, f"lora {label} mixed profile",
                       report=True)
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
    model, params = kind_model(kind, params)
    kw = dict(LORA_KW, kv_dtype=kind, model=model)
    if kind != "f32":
        ads = {n: {p: (a[:QUANT_LAYERS], b[:QUANT_LAYERS])
                   for p, (a, b) in ad.items()} for n, ad in ads.items()}
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


# ------------------------------------------------------------ the fleet (5h)

FLEET_KW = dict(ENGINE_KW, enable_kv_offload=True)
FLEET_TOKENS = 64
FLEET_DEPTH = 1024      # router prefix depth, and the groups' shared chars
FLEET_SEVER = 16        # token chunks a chaos-severed stream delivers
FLEET_SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=50, seed=4242)
# families of the fleet plane the merged exposition must carry
FLEET_FAMILIES = ("ray_tpu_llm_breaker_state", "ray_tpu_llm_failovers_total",
                  "ray_tpu_llm_replica_evictions_total",
                  "ray_tpu_llm_kv_sessions_shipped_total",
                  "ray_tpu_llm_kv_ship_bytes_total",
                  "ray_tpu_llm_slo_burn_rate", "ray_tpu_llm_fleet_mfu",
                  "ray_tpu_llm_fleet_queue_wait_seconds")
FLEET_LAUNCHES: dict = {}


class CallTimer:
    """While armed: the host (start, end) of every call to the named
    attributes (engine methods, kv_transport functions, server
    coroutines), by label."""

    def __init__(self, targets):
        self.targets = targets          # (object, attribute, label)
        self.calls = {label: [] for _, _, label in targets}
        self._saved = []

    def _wrap(self, fn, label):
        import inspect
        calls = self.calls[label]
        if inspect.iscoroutinefunction(fn):
            async def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return await fn(*a, **k)
                finally:
                    calls.append((t0, time.perf_counter()))
        else:
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    calls.append((t0, time.perf_counter()))
        return timed

    def __enter__(self):
        for obj, attr, label in self.targets:
            own = attr in vars(obj)
            self._saved.append((obj, attr, own, getattr(obj, attr)))
            setattr(obj, attr, self._wrap(getattr(obj, attr), label))
        return self

    def __exit__(self, *exc):
        for obj, attr, own, fn in reversed(self._saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
        self._saved = []

    def ms(self, label):
        return sum(b - a for a, b in self.calls[label]) * 1e3


class FleetRig:
    """Phase 5h's replicas: r0 and r1, LLMServerImpl over two engines
    on the bf16 phase's weight tensors (shared), every request their
    engines take recorded; an engine driven directly on the same
    weights (the reference) and phase 5's gather teacher."""

    def __init__(self, params):
        from ray_tpu_torch import EngineConfig, InferenceEngine, LLMServerImpl
        self.engines = {rid: InferenceEngine(EngineConfig(
            decode_impl="kernel", metrics_model_id="8b",
            metrics_replica_id=rid, **FLEET_KW), params=params)
            for rid in ("r0", "r1")}
        for eng in self.engines.values():
            if eng.params["layers"]["wq"] is not params["layers"]["wq"]:
                raise AssertionError("a replica copied the shared weights")
        self.servers = {rid: LLMServerImpl(dict(model_id="8b"), engine=eng)
                        for rid, eng in self.engines.items()}
        self.submitted = []             # (replica, Request)
        self.since = 0
        for rid, eng in self.engines.items():
            add = eng.add_request

            def recording(req, rid=rid, add=add):
                self.submitted.append((rid, req))
                return add(req)
            eng.add_request = recording
        self.ref = InferenceEngine(EngineConfig(
            decode_impl="kernel", metrics_model_id="8b-ref", **ENGINE_KW),
            params=params)
        self.teacher = InferenceEngine(EngineConfig(
            decode_impl="gather", **dict(ENGINE_KW, num_pages=2)),
            params=params)
        self.tok = self.servers["r0"].tokenizer

    def clients(self, ids=("r0", "r1")):
        from ray_tpu_torch.serve.llm import LocalReplicaClient
        return [LocalReplicaClient(rid, self.servers[rid]) for rid in ids]

    def fleet(self, clients=None, **kw):
        from ray_tpu_torch.serve.llm import (AdmissionConfig,
                                             AutoscaleConfig, FleetManager,
                                             RouterConfig)
        clients = clients or self.clients()
        n = len(clients)
        opts = dict(router=RouterConfig(prefix_depth=FLEET_DEPTH,
                                        spill_waiting=64),
                    admission=AdmissionConfig(max_concurrent=64,
                                              max_queue=64,
                                              queue_wait_slo_s=120.0),
                    autoscale=AutoscaleConfig(min_replicas=n,
                                              max_replicas=n),
                    model_id="8b", drain_timeout_s=60.0)
        opts.update(kw)
        return FleetManager(clients, **opts)

    def mark(self):
        """Start a drive: first_request looks at what follows."""
        self.since = len(self.submitted)

    def first_request(self, text):
        """The first request a replica's engine took for `text` since
        the drive's mark."""
        toks = self.tok.encode(text)
        for rid, r in self.submitted[self.since:]:
            if r.prompt_tokens == toks:
                return rid, r
        raise AssertionError(f"no replica took the prompt {text[:40]!r}")

    def reference(self, reqs, tag):
        """The recorded requests' prompts and parameters through the
        reference engine, all at once: its token lists."""
        from ray_tpu_torch import Request
        refs = [Request(f"{tag}{i}", list(r.prompt_tokens), r.params)
                for i, r in enumerate(reqs)]
        for r in refs:
            self.ref.add_request(r)
        while self.ref.has_work():
            self.ref.step()
        return refs

    def clear_caches(self):
        for eng in self.engines.values():
            eng.allocator.clear_cache()

    def cancel_pumps(self):
        for srv in self.servers.values():
            if srv._pump is not None:
                srv._pump.cancel()

    def ticks(self):
        """A drive's start: each replica's mixed and decode ticks and
        its flight recorder's high water."""
        return {rid: (e.ragged_ticks, e.decode_ticks,
                      e.telemetry.recorder.stats()["total"])
                for rid, e in self.engines.items()}


def fleet_counts(rig, ticks0, label):
    """A fleet drive's launches (counters set to 0 just before it): the
    ragged kernel layers x mixed ticks and the decode kernel layers x
    decode ticks, summed over both replicas, every decode launch on the
    pipelined route. Added to FLEET_LAUNCHES."""
    from ray_tpu_torch.ops import _kernels
    counts = _kernels.launch_counts()
    n_layers = rig.engines["r0"].model_cfg.n_layers
    mixed = sum(e.ragged_ticks - ticks0[rid][0]
                for rid, e in rig.engines.items())
    dec = sum(e.decode_ticks - ticks0[rid][1]
              for rid, e in rig.engines.items())
    want = {"ragged_paged": n_layers * mixed, "paged_decode": n_layers * dec}
    flagged = {}
    for rid, e in rig.engines.items():
        for ev in e.telemetry.recorder.events(since=ticks0[rid][2]):
            if ev["event"] in ("tick_anomaly", "profile_armed",
                               "blackbox_dump"):
                key = f"{rid} {ev['event']}"
                flagged[key] = flagged.get(key, 0) + 1
    log(f"[fleet {label}] launches {({k: n for k, n in counts.items() if n})}"
        f" ({mixed} mixed and {dec} decode ticks over both replicas); "
        f"engine events {flagged}")
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"fleet {label}: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n}")
    if want["ragged_paged"] <= 0:
        raise AssertionError(f"fleet {label}: the ragged kernel never ran")
    check_decode_route(_kernels, "paged_decode", want["paged_decode"])
    for k, n in counts.items():
        if n:
            FLEET_LAUNCHES[k] = FLEET_LAUNCHES.get(k, 0) + n
    return counts


def sse_tokens(chunk):
    """Token ids of one fleet SSE chunk ([] for [DONE])."""
    if not chunk.startswith("data: {"):
        return []
    return json.loads(chunk[len("data: "):])["choices"][0]["token_ids"]


async def fleet_request(fleet, text, stream, gate=None, first=None, **sp):
    """One request through the fleet's entry point: dispatch (unary) or
    dispatch_stream (token ids and chunk arrival times)."""
    import asyncio
    if gate is not None:
        await gate
    body = dict(prompt=text, max_tokens=FLEET_TOKENS, **sp)
    t0 = time.perf_counter()
    if not stream:
        out = await fleet.dispatch("completions", body)
        return dict(text=text, stream=False, t0=t0,
                    t1=time.perf_counter(),
                    out=out["choices"][0]["text"])
    toks, times = [], []
    async for c in fleet.dispatch_stream("completions_stream", body):
        got = sse_tokens(c)
        if got:
            toks += got
            times.append(time.perf_counter())
            if first is not None and not first.done():
                first.set_result(None)
    await asyncio.sleep(0)
    return dict(text=text, stream=True, t0=t0, t1=time.perf_counter(),
                tokens=toks, times=times)


def fleet_texts():
    """(a)'s prompts: two groups of 3 sharing a 1024-character prefix
    (64 full pages of 16 tokens), and phase 5's 6 prompts (14-1535
    tokens)."""
    groups = []
    for g in ("A", "B"):
        prefix = (f"Tenant {g} shares this system prompt across all of its "
                  f"requests. " * 20)[:FLEET_DEPTH]
        groups.append([prefix + f" Question {i} from tenant {g}?"
                       for i in range(3)])
    return groups, list(PROMPT_TEXTS)


def fleet_drive(rig, fleet, label):
    """(a) on `fleet`: the group leaders and the 6 distinct prompts at
    once, each group's two followers as soon as its leader streamed its
    first token (12 in flight together); half through dispatch, half
    through dispatch_stream, greedy, 64 tokens. Checks each response
    against its engine request; returns the results, the wall and the
    token lists by text."""
    import asyncio
    groups, distinct = fleet_texts()

    async def main():
        loop = asyncio.get_running_loop()
        lead = [loop.create_future() for _ in groups]
        coros = []
        for g, texts in enumerate(groups):
            coros.append(fleet_request(fleet, texts[0], True,
                                       first=lead[g]))
            coros.append(fleet_request(fleet, texts[1], False, lead[g]))
            coros.append(fleet_request(fleet, texts[2], True, lead[g]))
        for i, t in enumerate(distinct):
            coros.append(fleet_request(fleet, t, i % 3 == 0))
        t0 = time.perf_counter()
        res = await asyncio.gather(*coros)
        wall = time.perf_counter() - t0
        rig.cancel_pumps()
        return res, wall

    res, wall = asyncio.run(main())
    tokens = {}
    for r in res:
        rid, req = rig.first_request(r["text"])
        r["replica"], r["request"] = rid, req
        if r["stream"]:
            if r["tokens"] != req.output_tokens:
                raise AssertionError(f"fleet {label}: streamed tokens differ "
                                     f"from the engine request's")
        elif r["out"] != rig.tok.decode(req.output_tokens):
            raise AssertionError(f"fleet {label}: a response disagrees with "
                                 f"its tokens")
        tokens[r["text"]] = req.output_tokens
    n_out = sum(len(t) for t in tokens.values())
    log(f"[fleet {label}] {len(res)} requests ({sum(r['stream'] for r in res)}"
        f" streams): {n_out} output tokens in {wall:.3f} s, "
        f"{n_out / wall:.1f} tokens/s")
    return res, wall, n_out


def fleet_times(rig, res):
    """TTFT, TPOT and e2e (ms) of the drive's requests from their
    replicas' lifecycles (/debug/trace): p50 and p99."""
    import asyncio
    by_engine = {}
    for r in res:
        by_engine.setdefault(r["replica"], set()).add(r["request"].request_id)
    lc = {}
    for rid, wanted in by_engine.items():
        doc = asyncio.run(rig.servers[rid].debug_trace())
        evs = [e for e in doc["traceEvents"]
               if (e.get("args") or {}).get("request_id") in wanted]
        lc.update(lifecycles({"traceEvents": evs}))
    if len(lc) != len(res):
        raise AssertionError(f"{len(res) - len(lc)} requests without a "
                             f"lifecycle")
    return {k: dict(p50=pctl([v[k] for v in lc.values()], 0.5),
                    p99=pctl([v[k] for v in lc.values()], 0.99))
            for k in ("ttft", "tpot", "e2e")}


def fleet_judge(rig, pairs, label):
    """(engine request, the fleet's token list) pairs against the
    reference engine on the same prompts and parameters: greedy by
    phase 5's rule (`judge_streams`), sampled by phase 5d's pickable
    rule (`compare_sampled`). Returns whether all were identical."""
    from ray_tpu_torch import Request
    refs = rig.reference([r for r, _ in pairs], f"ref{label}")
    greedy = [i for i, (r, _) in enumerate(pairs)
              if r.params.temperature == 0]
    sampled = [i for i in range(len(pairs)) if i not in greedy]
    exact = True
    if greedy:
        exact &= judge_streams(
            None, rig.teacher, [pairs[i][0].prompt_tokens for i in greedy],
            [pairs[i][1] for i in greedy],
            [refs[i].output_tokens for i in greedy], f"fleet {label}",
            names=("fleet", "engine"))
    if sampled:
        got = [Request(f"fleet{i}", list(pairs[i][0].prompt_tokens),
                       pairs[i][0].params, output_tokens=list(pairs[i][1]))
               for i in sampled]
        exact &= compare_sampled(rig.ref, rig.engines["r0"],
                                 [refs[i] for i in sampled], got,
                                 f"fleet {label}", NEAR_TIE)
    return exact


def fleet_routing(rig):
    """(a) and (g): the 12 requests over both replicas, a cold pass and
    the timed warm one, then the same 12 on r0 alone and round-robin
    over both (6 a replica)."""
    from ray_tpu_torch.ops import _kernels
    # a first pass meets every shape of the drive cold (first ragged
    # ticks, graph captures, flagged ticks and the profiles they arm);
    # the timed pass repeats it warm
    rig.clear_caches()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()
    rig.mark()
    cold, cold_wall, cold_n = fleet_drive(rig, rig.fleet(), "cold pass")
    fleet_counts(rig, ticks0, "cold pass")
    cold_times = fleet_times(rig, cold)
    # a profile a flagged tick armed runs on the next ticks, each tick
    # holding the card: let it finish before the timed pass
    t0 = time.perf_counter()
    armed = [rid for rid, e in rig.engines.items() if e._profile is not None]
    for eng in rig.engines.values():
        while eng._profile is not None:
            eng.step()
    profile_s = time.perf_counter() - t0
    rig.clear_caches()
    fleet = rig.fleet()
    hits0 = {rid: e.allocator.cache_hit_tokens
             for rid, e in rig.engines.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()
    rig.mark()
    res, wall, n_out = fleet_drive(rig, fleet, "2 replicas")
    counts = fleet_counts(rig, ticks0, "2 replicas")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    groups, _ = fleet_texts()
    placed = [{rig.first_request(t)[0] for t in g} for g in groups]
    rstats = fleet.router.stats()
    hits = {rid: e.allocator.cache_hit_tokens - hits0[rid]
            for rid, e in rig.engines.items()}
    rates = {rid: round(e.allocator.cache_hit_rate, 4)
             for rid, e in rig.engines.items()}
    log(f"[fleet 2 replicas] groups on {placed}; router {rstats}; prefix "
        f"cache hit tokens {hits}, hit rates {rates}")
    if any(len(p) != 1 for p in placed) or rstats["affinity_hits"] < 6:
        raise AssertionError(f"a group was not kept on one replica: "
                             f"{placed}, {rstats}")
    for p in placed:
        if hits[next(iter(p))] < 2 * (FLEET_DEPTH - 16):
            raise AssertionError(f"the followers missed their replica's "
                                 f"prefix cache: {hits}")
    times = fleet_times(rig, res)
    exact = fleet_judge(rig, [(r["request"], r["request"].output_tokens)
                              for r in res], "2 replicas")
    # the same 12 requests on one replica
    rig.clear_caches()
    one = rig.fleet(clients=rig.clients(("r0",)))
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()
    rig.mark()
    res1, wall1, n1 = fleet_drive(rig, one, "1 replica")
    fleet_counts(rig, ticks0, "1 replica")
    times1 = fleet_times(rig, res1)
    # the same 12 over both replicas, 6 each (round-robin routing)
    from ray_tpu_torch.serve.llm import RouterConfig
    rig.clear_caches()
    rr = rig.fleet(router=RouterConfig(policy="round_robin",
                                       prefix_depth=FLEET_DEPTH))
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()
    rig.mark()
    res_rr, wall_rr, n_rr = fleet_drive(rig, rr, "round robin")
    fleet_counts(rig, ticks0, "round robin")
    times_rr = fleet_times(rig, res_rr)
    log("[fleet] ms p50 / p99, 2 replicas | 1 replica: " + "; ".join(
        f"{k} {times[k]['p50']:.1f} / {times[k]['p99']:.1f} | "
        f"{times1[k]['p50']:.1f} / {times1[k]['p99']:.1f}" for k in times))
    log(f"[fleet] output tokens/s: 2 replicas {n_out / wall:.1f}, 1 replica "
        f"{n1 / wall1:.1f} ({n_out / wall / (n1 / wall1):.3f}x); peak "
        f"{peak / 2**30:.3f} GiB above the replicas as built")
    for label, tps, tm in (
            ("the cold pass", cold_n / cold_wall, cold_times),
            ("round robin (6 a replica)", n_rr / wall_rr, times_rr)):
        log(f"[fleet] {label}: {tps:.1f} output tokens/s; ms p50 / p99 "
            + "; ".join(f"{k} {v['p50']:.1f} / {v['p99']:.1f}"
                        for k, v in tm.items()))
    log(f"[fleet] profiles armed in the cold pass on {armed} finished in "
        f"{profile_s:.2f} s of ticks holding the card")
    return dict(requests=len(res), output_tokens=n_out, wall_s=wall,
                tokens_per_s=n_out / wall, times=times, exact=exact,
                cold=dict(wall_s=cold_wall, tokens_per_s=cold_n / cold_wall,
                          times=cold_times, profiles_armed=armed,
                          profile_s=profile_s),
                round_robin=dict(wall_s=wall_rr, tokens_per_s=n_rr / wall_rr,
                                 times=times_rr),
                router=rstats, prefix_hit_tokens=hits, peak_bytes=peak,
                launches=counts,
                one_replica=dict(output_tokens=n1, wall_s=wall1,
                                 tokens_per_s=n1 / wall1, times=times1))


def routed_prompt(fleet, rid, salt):
    """A prompt of ~300 tokens whose prefix the ring puts on `rid`."""
    from ray_tpu_torch.serve.llm import prefix_fingerprint
    i = 0
    while True:
        text = f"{PROMPT_TEXTS[2]} {salt} probe {i}."
        if fleet.router.ring.preferred(prefix_fingerprint(
                {"prompt": text}, FLEET_DEPTH))[0] == rid:
            return text
        i += 1


def fleet_failover(rig):
    """(b): a chaos client severs a greedy and a sampled stream on r0
    after 16 token chunks; both continue on r1."""
    import asyncio
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve.llm import (ChaosReplicaClient, ChaosSchedule,
                                         HealthConfig)
    sched = ChaosSchedule(seed=11).sever_stream(
        after_chunks=FLEET_SEVER, method="completions_stream_tokens",
        count=2)
    clients = rig.clients()
    clients[0] = ChaosReplicaClient(clients[0], sched)
    fleet = rig.fleet(clients=clients,
                      health=HealthConfig(open_cooldown_s=300.0))
    texts = [routed_prompt(fleet, "r0", s) for s in ("greedy", "sampled")]
    fo0 = sum(v for _, v in fleet.metrics["failovers"]._samples())
    rig.mark()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()

    async def main():
        out = await asyncio.gather(
            fleet_request(fleet, texts[0], True),
            fleet_request(fleet, texts[1], True, **FLEET_SAMPLED))
        rig.cancel_pumps()
        return out
    res = asyncio.run(main())
    fleet_counts(rig, ticks0, "failover")
    fired = [f["kind"] for f in sched.fired]
    failovers = sum(v for _, v in fleet.metrics["failovers"]._samples()) - fo0
    if fired != ["stream_sever"] * 2 or failovers != 2 \
            or fleet.replicas["r0"].status != "UNHEALTHY":
        raise AssertionError(f"fleet failover: fired {fired}, failovers "
                             f"{failovers}, r0 {fleet.replicas['r0'].status}")
    added = []
    for r in res:
        # the longest gap after the first half of the severed stream
        gaps = [b - a for a, b in zip(r["times"], r["times"][1:])]
        added.append((max(gaps[FLEET_SEVER // 2:])
                      - statistics.median(gaps)) * 1e3)
    exact = fleet_judge(rig, [(rig.first_request(r["text"])[1], r["tokens"])
                              for r in res], "failover")
    log(f"[fleet failover] {failovers} failovers (r0 evicted); the "
        f"continuations' added latency {[round(a, 2) for a in added]} ms "
        f"(greedy, sampled: the gap at the cut less the median gap)")
    return dict(failovers=failovers, added_latency_ms=added, exact=exact,
                tokens=[len(r["tokens"]) for r in res])


def fleet_transport_timer(rig, extra=()):
    from ray_tpu_torch.serve.llm import kv_transport as kvt
    targets = [(kvt, n, n) for n in (
        "encode_session", "decode_session", "encode_prefix",
        "decode_prefix", "to_b64", "from_b64")]
    for rid, eng in rig.engines.items():
        targets += [(eng, n, f"{rid}.{n}") for n in (
            "export_session", "import_session", "export_prefix",
            "import_prefix")]
    return CallTimer(targets + list(extra))


def fleet_drain(rig):
    """(c): 4 greedy streams, 2 on each replica; _apply_target(1) once
    each has its first token: the victim's sessions ship to the
    survivor over the RTKV wire."""
    import asyncio
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve.llm import TransportConfig
    fleet = rig.fleet(transport=TransportConfig(enable_disagg=False,
                                                enable_prefix_store=False))
    texts = [routed_prompt(fleet, rid, f"drain {rid} {i}")
             for rid in ("r0", "r1") for i in range(2)]
    rig.mark()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()

    async def main():
        loop = asyncio.get_running_loop()
        first = [loop.create_future() for _ in texts]
        tasks = [asyncio.ensure_future(fleet_request(fleet, t, True,
                                                     first=f))
                 for t, f in zip(texts, first)]
        await asyncio.gather(*first)
        fleet._apply_target(1)
        victim = next(rid for rid, st in fleet.replicas.items()
                      if st.status == "DRAINING")
        res = await asyncio.gather(*tasks)
        await asyncio.wait_for(fleet.replicas[victim].drain_task, 120)
        rig.cancel_pumps()
        return victim, res
    with fleet_transport_timer(rig) as timer:
        victim, res = asyncio.run(main())
    fleet_counts(rig, ticks0, "drain")
    moved = [e for e in fleet.recorder.events()
             if e["event"] == "session_migrated"]
    spans = [e for e in fleet.trace.events()
             if e.get("name") == "session_migration"]
    if not moved or fleet.replicas[victim].status != "STANDBY":
        raise AssertionError(f"fleet drain: {len(moved)} sessions shipped, "
                             f"victim {fleet.replicas[victim].status}")
    nbytes = sum(int(e["bytes"]) for e in moved)
    pages = sum(int(e["pages"]) for e in moved)
    survivor = "r1" if victim == "r0" else "r0"
    parts = dict(
        export=timer.ms(f"{victim}.export_session"),
        encode=timer.ms("encode_session"),
        decode=timer.ms("decode_session"),
        imports=timer.ms(f"{survivor}.import_session"),
        b64=timer.ms("to_b64") + timer.ms("from_b64"))
    ship_ms = sum(parts.values())
    exact = fleet_judge(rig, [(rig.first_request(r["text"])[1], r["tokens"])
                              for r in res], "drain")
    log(f"[fleet drain] victim {victim}: {len(moved)} sessions, {pages} "
        f"pages, {nbytes / 1e6:.1f} MB shipped; ms "
        f"{({k: round(v, 2) for k, v in parts.items()})} = {ship_ms:.1f} ms,"
        f" {nbytes / ship_ms / 1e6:.3f} GB/s; export spans "
        f"{[round(e['dur'] / 1e3, 2) for e in spans]} ms")
    return dict(victim=victim, sessions=len(moved), pages=pages,
                bytes=nbytes, ms=parts, ship_ms=ship_ms,
                gb_per_s=nbytes / ship_ms / 1e6, exact=exact)


def fleet_disagg(rig):
    """(d): roles prefill (r0) / decode (r1): the 1535-token prompt
    prefills on r0 and decodes on r1; a short prompt skips the
    handoff."""
    import asyncio
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve.llm import TransportConfig
    rig.clear_caches()
    fleet = rig.fleet(roles=["prefill", "decode"],
                      transport=TransportConfig(enable_prefix_store=False,
                                                disagg_prompt_chars=1024))
    e0, e1 = rig.engines["r0"], rig.engines["r1"]
    ex0, rs0 = e0.host_tier.exports_total, e1.host_tier.restores_total
    rig.mark()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()
    timer = fleet_transport_timer(rig, [(rig.servers["r0"], "prefill_export",
                                         "prefill_export")])

    async def main():
        long = await fleet_request(fleet, PROMPT_TEXTS[0], True)
        short = await fleet_request(fleet, PROMPT_TEXTS[4], True)
        rig.cancel_pumps()
        return long, short
    with timer:
        long, short = asyncio.run(main())
    fleet_counts(rig, ticks0, "disagg")
    if e0.host_tier.exports_total != ex0 + 1 \
            or e1.host_tier.restores_total != rs0 + 1 \
            or [e["event"] for e in fleet.recorder.events()].count(
                "disagg_handoff") != 1:
        raise AssertionError("fleet disagg: not one handoff r0 -> r1")
    pe = timer.calls["prefill_export"][0]
    imp = timer.calls["r1.import_session"][0]
    export = timer.ms("r0.export_session")
    encode = timer.ms("encode_session") + timer.ms("to_b64")
    parts = dict(prefill=(pe[1] - pe[0]) * 1e3 - export - encode,
                 export=export, encode=encode,
                 decode=timer.ms("from_b64") + timer.ms("decode_session"),
                 imports=(imp[1] - imp[0]) * 1e3,
                 first_decode=(long["times"][1] - imp[1]) * 1e3)
    total = (long["times"][0] - long["t0"]) * 1e3
    exact = fleet_judge(rig, [
        (rig.first_request(PROMPT_TEXTS[0])[1], long["tokens"]),
        (rig.first_request(PROMPT_TEXTS[4])[1], short["tokens"])], "disagg")
    log(f"[fleet disagg] 1535-token prompt: first token after {total:.1f} "
        f"ms; handoff ms {({k: round(v, 2) for k, v in parts.items()})}; "
        f"the short prompt took no handoff")
    return dict(first_token_ms=total, ms=parts, exact=exact)


def fleet_prefix_store(rig):
    """(e): round-robin routing with the prefix store: a 1024-character
    prefix served on r0 is published, seeded into r1 and hits there."""
    import asyncio
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve.llm import RouterConfig, TransportConfig
    rig.clear_caches()
    fleet = rig.fleet(
        router=RouterConfig(policy="round_robin", prefix_depth=FLEET_DEPTH),
        transport=TransportConfig(enable_disagg=False,
                                  enable_migration=False,
                                  prefix_min_chars=FLEET_DEPTH))
    prefix = ("The fleet prefix store holds this shared system prompt. "
              * 20)[:FLEET_DEPTH]
    texts = [prefix + f" Turn {i}." for i in range(2)]
    hit0 = {rid: e.allocator.cache_hit_tokens
            for rid, e in rig.engines.items()}
    rig.mark()
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()

    async def main():
        out = [await fleet_request(fleet, t, True) for t in texts]
        rig.cancel_pumps()
        return out
    with fleet_transport_timer(rig) as timer:
        res = asyncio.run(main())
    fleet_counts(rig, ticks0, "prefix store")
    st = fleet.prefix_store.stats()
    hits = {rid: e.allocator.cache_hit_tokens - hit0[rid]
            for rid, e in rig.engines.items()}
    placed = [rig.first_request(t)[0] for t in texts]
    if st["publishes"] != 1 or st["hits"] != 1 or placed != ["r0", "r1"] \
            or hits["r1"] < FLEET_DEPTH - 16:
        raise AssertionError(f"fleet prefix store: {st}, placed {placed}, "
                             f"hit tokens {hits}")
    parts = dict(export=timer.ms("r0.export_prefix"),
                 encode=timer.ms("encode_prefix") + timer.ms("to_b64"),
                 decode=timer.ms("from_b64") + timer.ms("decode_prefix"),
                 imports=timer.ms("r1.import_prefix"))
    exact = fleet_judge(rig, [(rig.first_request(r["text"])[1], r["tokens"])
                              for r in res], "prefix store")
    log(f"[fleet prefix store] published on r0 ({st['bytes_used'] / 1e6:.1f}"
        f" MB of base64), seeded into r1: r1 hit {hits['r1']} tokens; ms "
        f"{({k: round(v, 2) for k, v in parts.items()})}")
    return dict(store=st, hit_tokens=hits, ms=parts, exact=exact)


def fleet_surfaces(rig):
    """(f): status rows and active chips, the merged exposition, graph
    captures per replica; 16 guarded decode ticks on r0 (driven
    directly) while r1 serves 4 streams through the fleet."""
    import asyncio
    from ray_tpu_torch import Request, SamplingParams
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    fleet = rig.fleet()

    async def surfaces():
        await fleet.refresh()
        return await fleet.status(), await fleet.metrics_text()
    status, text = asyncio.run(surfaces())
    rows = {rid: (r["status"], r.get("chips"))
            for rid, r in status["replicas"].items()}
    if rows != {"r0": ("ACTIVE", 1), "r1": ("ACTIVE", 1)} \
            or status["autoscale"]["active_chips"] != 2:
        raise AssertionError(f"fleet status rows {rows}, active chips "
                             f"{status['autoscale']['active_chips']}")
    n_samples = check_exposition(text)
    missing = [f for f in FLEET_FAMILIES if text.count(f"# TYPE {f} ") != 1]
    if missing:
        raise AssertionError(f"merged exposition: families {missing} not "
                             f"declared exactly once")
    e0 = rig.engines["r0"]
    reqs = [Request(f"guard{i}", rig.tok.encode(PROMPT_TEXTS[i % 6])[:200],
                    SamplingParams(max_tokens=GUARD_TICKS * PROFILE_ATTEMPTS
                                   + 16))
            for i in range(8)]
    for r in reqs:
        e0.add_request(r)
    page = e0.allocator.page_size
    # steady: every slot decoding with the pages of its final need (no
    # growth upload), the decode graph replaying
    while not all(s.request is not None and s.ready
                  and len(s.pages) * page >= s.position + 1
                  + s.request.params.max_tokens
                  - len(s.request.output_tokens) for s in e0.slots):
        e0.step()
    for _ in range(3):
        e0.step()
    r1_only = rig.fleet(clients=rig.clients(("r1",)))
    ticks0 = rig.ticks()
    _kernels.reset_launch_counts()

    def window():
        with e0._step_lock:
            return guarded_window(e0, "fleet r0", dispatch_guard)

    async def main():
        loop = asyncio.get_running_loop()
        first = [loop.create_future() for _ in range(4)]
        tasks = [asyncio.ensure_future(fleet_request(
            r1_only, f"{PROMPT_TEXTS[1]} Served on r1, stream {i}.", True,
            first=first[i])) for i in range(4)]
        await asyncio.gather(*first)
        guard = await loop.run_in_executor(None, window)
        res = await asyncio.gather(*tasks)
        rig.cancel_pumps()
        return guard, res
    guard, res = asyncio.run(main())
    for r in reqs:
        e0.abort(r.request_id)
    while e0.has_work():
        e0.step()
    fleet_counts(rig, ticks0, "guarded window")
    captures = {rid: e.graph_captures for rid, e in rig.engines.items()}
    crashes = {rid: [e["event"] for e in eng.telemetry.recorder.events()
                     if e["event"] == "engine_crash"]
               for rid, eng in rig.engines.items()}
    if any(crashes.values()) or any(len(r["tokens"]) != FLEET_TOKENS
                                    for r in res):
        raise AssertionError(f"fleet surfaces: crashes {crashes}, r1 streams "
                             f"{[len(r['tokens']) for r in res]}")
    log(f"[fleet surfaces] status rows {rows}, active chips 2; exposition "
        f"{n_samples} samples, fleet families {FLEET_FAMILIES} once each; "
        f"graph captures {captures}, none invalidated")
    return dict(rows=rows, samples=n_samples, guard=guard,
                graph_captures=captures)


def run_fleet(dev, params):
    """Phase 5h: the serving fleet over two LLMServerImpl replicas on
    one card, the `8b` preset at full width and depth (the bf16 phase's
    weights, shared; B 8, pages of 16, 1025 pages). Returns the
    numbers."""
    import asyncio
    t0 = time.perf_counter()
    rig = FleetRig(params)

    async def warm():
        for srv in rig.servers.values():
            await srv.completions(dict(prompt=PROMPT_TEXTS[3],
                                       max_tokens=4))
        rig.cancel_pumps()
    asyncio.run(warm())
    log(f"[fleet] 2 replicas, the reference and the teacher built and warm "
        f"in {time.perf_counter() - t0:.1f} s")
    out = dict(routing=fleet_routing(rig))
    out["failover"] = fleet_failover(rig)
    out["drain"] = fleet_drain(rig)
    out["disagg"] = fleet_disagg(rig)
    out["prefix_store"] = fleet_prefix_store(rig)
    out["surfaces"] = fleet_surfaces(rig)
    out["launches"] = dict(FLEET_LAUNCHES)
    for eng in list(rig.engines.values()) + [rig.ref]:
        eng.release_graphs()
    del rig
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
    prof, wall = profiled(step, "profile train step", report=True)
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
    policies = policy_ab(cfg, opt, snap, tokens)
    if policies["dots_no_batch"]["loss"] != mk["loss"]:
        raise AssertionError("train: the policy A/B's default step and the "
                             "profiled step disagree on the loss")
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
        remat_policies=policies,
        profile=dict(prof, step_wall_ms=step_ms,
                     idle_share=max(0.0, 1 - prof["device_ms"] / step_ms)))


POLICY_STEPS = 2        # timed steps a leg of the remat policy A/B


def policy_leg(cfg, opt, params, tokens):
    """A fresh TrainStepBundle state from `params`: one warm-up and
    POLICY_STEPS timed steps; their ms and the peak memory above the
    state."""
    from ray_tpu_torch.models.training import TrainStepBundle
    bundle = TrainStepBundle(cfg, optimizer=opt)
    state = (params, opt.init(params))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(1 + POLICY_STEPS):
        t0 = time.perf_counter()
        state, _ = bundle.step(state, tokens)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[1:], torch.cuda.max_memory_allocated() - base


def policy_ab(cfg, opt, snap, tokens):
    """The remat policy A/B from copies of the same parameters: a
    forward and backward alone under each policy (the loss equal, grad
    norms within TRAIN_GNORM_RTOL; the peak above the parameters is the
    activations the policy keeps), then train steps in turns (A, B, B,
    A: a warm-up and POLICY_STEPS timed steps a leg), their median ms
    and peak above the state."""
    from ray_tpu_torch.models import llama
    cfgs = {p: llama.config(cfg, remat_policy=p)
            for p in ("dots_no_batch", "nothing")}
    out = {p: dict(step_ms=[]) for p in cfgs}
    for policy, pcfg in cfgs.items():
        params = _clone_tree(snap)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[policy].update(grad_metrics(pcfg, params, tokens))
        out[policy]["fwd_bwd_peak_above_params"] = \
            torch.cuda.max_memory_allocated() - base
        del params
    for policy in ("dots_no_batch", "nothing", "nothing", "dots_no_batch"):
        ms, peak = policy_leg(cfgs[policy], opt, _clone_tree(snap), tokens)
        out[policy]["step_ms"] += ms
        out[policy]["step_peak_above_state"] = peak
        gc.collect()
        torch.cuda.empty_cache()
    for policy, r in out.items():
        r["step_ms_median"] = statistics.median(r["step_ms"])
        log(f"[train remat] {policy!r}: forward+backward peak "
            f"{r['fwd_bwd_peak_above_params'] / 2**30:.2f} GiB above the "
            f"parameters; train step median {r['step_ms_median']:.1f} ms "
            f"({[round(x, 1) for x in r['step_ms']]}), peak "
            f"{r['step_peak_above_state'] / 2**30:.2f} GiB above the "
            f"state; loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}")
    a, b = out["dots_no_batch"], out["nothing"]
    dg = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    log(f"[train remat] \"nothing\" against \"dots_no_batch\": step "
        f"{b['step_ms_median'] / a['step_ms_median']:.3f}x, "
        f"forward+backward peak "
        f"{b['fwd_bwd_peak_above_params'] / a['fwd_bwd_peak_above_params']:.3f}x;"
        f" grad_norm rel {dg:.2e} (tol {TRAIN_GNORM_RTOL})")
    if a["loss"] != b["loss"] or not dg <= TRAIN_GNORM_RTOL:
        raise AssertionError("train: the remat policies disagree")
    return out


# ------------------------------------------------------------ MoE training

MOE_LAYERS = 2          # 8x7b widths; 3.165B params: p, g, m, v 50.6 GB
MOE_BATCH, MOE_SEQ = 4, 2048
MOE_STEPS = 8           # timed, after one warm-up step
MOE_LAUNCHES = {}       # phase 6b's main path launches, for the summary


def grad_metrics(cfg, params, tokens):
    """llama.loss_fn and torch.autograd.grad on `params` (no optimizer
    state): the metrics, the global norm of the gradients and the host
    syncs the two calls made (torch's sync debug mode)."""
    import warnings
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import _leaves as leaves, global_norm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loss, m = llama.loss_fn(cfg, params, tokens)
            grads = torch.autograd.grad(loss, leaves(params))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    out = dict(_sync_metrics(m), grad_norm=global_norm(grads).item(),
               host_syncs=syncs)
    del grads, loss
    return out


def agree(label, a, b, keys=("loss", "grad_norm")):
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in keys}
    tol = dict(loss=TRAIN_LOSS_RTOL, grad_norm=TRAIN_GNORM_RTOL,
               moe_aux=TRAIN_LOSS_RTOL)
    log(f"[train moe] {label}: " + "; ".join(
        f"{k} {a[k]:.6f} vs {b[k]:.6f} (rel {rel[k]:.2e}, tol {tol[k]})"
        for k in keys))
    if any(rel[k] > tol[k] for k in keys):
        raise AssertionError(f"train moe: {label} disagree")
    return rel


def grouped_probe(cfg, params, tokens):
    """The dropless path's grouped expert product at these widths: the
    port's per-expert loop (ops/moe.py) against torch._grouped_mm (one
    library call, used nowhere in the port) on the same sorted rows of
    layer 0, forward within two bf16 ulps, with both times."""
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.models import llama
    with torch.no_grad():
        x = params["embed"].to(cfg.dtype)[tokens.long()].reshape(
            -1, cfg.hidden)
        lay = {k: v[0] for k, v in params["layers"].items()}
        probs = moe.router_probs(llama.rms_norm(x, lay["ln2"], cfg.norm_eps),
                                 lay["router"])
        _, idx = moe.top_k_routing(probs, cfg.moe_top_k)
        eid = idx.reshape(-1)
        order = torch.sort(eid, stable=True).indices
        rows = x[torch.arange(x.shape[0], device=x.device)
                 .repeat_interleave(cfg.moe_top_k)[order]]
        counts = torch.bincount(eid, minlength=cfg.n_experts)
        w = lay["wg"].to(cfg.dtype)
        sizes = counts.tolist()

        def loop():
            return torch.cat([r @ w[e] for e, r in
                              enumerate(rows.split(sizes))])
        offs = torch.cumsum(counts, 0).to(torch.int32)

        def grouped():
            return torch._grouped_mm(rows, w, offs=offs)
        ref, got = loop(), grouped()
        err = ((got.float() - ref.float()).abs()
               / ref.float().abs().clamp(min=1e-3 * ref.float().abs().max())
               ).max().item()
        loop_ms, grouped_ms = time_ms(loop, iters=10), time_ms(grouped,
                                                               iters=10)
    flops = 2 * rows.shape[0] * cfg.hidden * cfg.ffn
    log(f"[train moe] grouped product {tuple(rows.shape)} x "
        f"{tuple(w.shape)} (groups {sizes}): per-expert loop "
        f"{loop_ms:.3f} ms ({flops / loop_ms / 1e9:.0f} TFLOP/s), "
        f"torch._grouped_mm {grouped_ms:.3f} ms; max rel diff {err:.2e} "
        f"(tol {FLASH_REL}: two bf16 ulps)")
    if not err <= FLASH_REL:
        raise AssertionError("train moe: torch._grouped_mm and the "
                             "per-expert loop disagree")
    return dict(rows=rows.shape[0], groups=sizes, loop_ms=loop_ms,
                grouped_mm_ms=grouped_ms, max_rel_diff=err)


def run_train_moe(dev):
    """Phase 6b: TrainStepBundle on the 8x7b preset, 2 layers."""
    import dataclasses
    import numpy as np
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (TrainStepBundle,
                                               default_optimizer)
    from ray_tpu_torch.ops import _kernels
    cfg = llama.config("8x7b", n_layers=MOE_LAYERS, max_seq=MOE_SEQ)
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                            total_steps=100)
    bundle = TrainStepBundle(cfg, optimizer=opt)
    t0 = time.perf_counter()
    state = bundle.init_state(0)
    rng = np.random.default_rng(1)
    tokens = bundle.shard_batch(rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)).astype(np.int32))
    torch.cuda.synchronize()
    t_cap = MOE_BATCH * MOE_SEQ * cfg.moe_top_k / cfg.n_experts \
        * cfg.moe_capacity_factor
    log(f"[train moe] 8x7b widths, {cfg.n_layers} layers, "
        f"{cfg.num_params() / 1e9:.3f}B params (f32; bf16 compute; remat "
        f"{cfg.remat_policy!r}; {cfg.n_experts} experts, top-"
        f"{cfg.moe_top_k}, capacity {int(t_cap)} a expert), batch "
        f"{MOE_BATCH}x{MOE_SEQ}; init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps = []
    for i in range(1 + MOE_STEPS):
        t0 = time.perf_counter()
        state, m = bundle.step(state, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = _sync_metrics(m)
        steps.append(dict(ms=ms, **m))
        log(f"[train moe] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{m['loss']:.5f} moe_aux {m['moe_aux']:.5f} grad_norm "
            f"{m['grad_norm']:.5f} {ms:.1f} ms")
    counts = _kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(steps)
    want = dict(flash_fwd=2 * cfg.n_layers * n, flash_dq=cfg.n_layers * n,
                flash_dkv=cfg.n_layers * n)
    log(f"[train moe] launches {counts} (expected {want})")
    for name, w in want.items():
        if counts[name] != w:
            raise AssertionError(f"train moe: {name} launched "
                                 f"{counts[name]} times, expected {w}")
    if any(c for name, c in counts.items() if not name.startswith("flash")):
        raise AssertionError("train moe: a serving kernel ran")
    MOE_LAUNCHES.update(want)
    for st in steps:
        if not all(math.isfinite(st[k]) for k in ("loss", "grad_norm",
                                                   "moe_aux")):
            raise AssertionError(f"train moe: non-finite metrics {st}")
        if not st["moe_aux"] > 0:
            raise AssertionError(f"train moe: moe_aux {st['moe_aux']}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"train moe: loss did not fall "
                             f"({steps[0]['loss']} -> {steps[-1]['loss']})")
    timed = [st["ms"] for st in steps[1:]]
    step_ms = statistics.median(timed)
    tok_s = MOE_BATCH * MOE_SEQ / (step_ms / 1e3)
    fpt = llama.flops_per_token(cfg, MOE_SEQ)
    mfu = fpt * tok_s / PEAK_FLOPS[torch.bfloat16]
    # the float32 one-hot products: 2 forward (dispatch, combine; kept by
    # the policy, not recomputed) and 3 backward a layer, 2*T*E*C*H each
    onehot_flops = 5 * cfg.n_layers * 2 * MOE_BATCH * MOE_SEQ \
        * cfg.n_experts * int(t_cap) * cfg.hidden
    log(f"[train moe] step median {step_ms:.1f} ms (timed steps "
        f"{[round(x, 1) for x in timed]}); {tok_s:.0f} tokens/s; "
        f"{fpt * MOE_BATCH * MOE_SEQ / 1e12:.2f} TFLOP a step of the model "
        f"(active experts) and {onehot_flops / 1e12:.2f} TFLOP of float32 "
        f"one-hot products (>= {onehot_flops / 67e12 * 1e3:.0f} ms at 67 "
        f"TFLOP/s); MFU {100 * mfu:.2f}% of 989 TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    state, _, prof = profile_step(bundle, state, tokens)
    # comparisons on the trained parameters, no optimizer state
    params = state[0]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    kern = grad_metrics(cfg, params, tokens)
    xla = grad_metrics(llama.config(cfg, attention_impl="xla"), params,
                       tokens)
    kvx = agree("kernels vs xla attention", kern, xla,
                keys=("loss", "moe_aux", "grad_norm"))
    one = tokens[:1]
    free = dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts
                               / cfg.moe_top_k)
    cap = grad_metrics(free, params, one)
    drop = grad_metrics(dataclasses.replace(cfg, moe_dropless=True),
                        params, one)
    dvc = agree(f"dropless vs capacity factor {free.moe_capacity_factor} "
                f"(batch 1x{MOE_SEQ})", drop, cap,
                keys=("loss", "moe_aux", "grad_norm"))
    log(f"[train moe] host syncs in a forward and backward: capacity "
        f"{kern['host_syncs']} (batch {MOE_BATCH}), {cap['host_syncs']} "
        f"(batch 1); dropless {drop['host_syncs']} (the group sizes, read "
        f"once a layer call: forward and recompute)")
    grouped = grouped_probe(cfg, params, one)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        layers=cfg.n_layers, params=cfg.num_params(), batch=MOE_BATCH,
        seq=MOE_SEQ, capacity=int(t_cap), steps=steps,
        step_ms_median=step_ms, tokens_per_s=tok_s,
        flops_per_step=fpt * MOE_BATCH * MOE_SEQ,
        onehot_flops_per_step=onehot_flops, mfu=mfu,
        peak_memory_bytes=peak, launches=counts,
        kernel_vs_xla=dict(kernel=kern, xla=xla, rel=kvx),
        dropless_vs_capacity=dict(dropless=drop, capacity=cap, rel=dvc),
        grouped=grouped,
        profile=dict(prof, step_wall_ms=step_ms,
                     idle_share=max(0.0, 1 - prof["device_ms"] / step_ms)))


# ------------------------------------------------------------- checkpoints

CKPT_LAYERS = 2
CKPT_TOKENS = 16


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def run_checkpoint(dev):
    """Phase 6c: an 8b-width bf16 checkpoint of 2 layers written, served
    and trained from."""
    import dataclasses
    import numpy as np
    from ray_tpu_torch import ByteTokenizer, EngineConfig, InferenceEngine
    from ray_tpu_torch.models import checkpoint_io, llama
    from ray_tpu_torch.models.training import (TrainStepBundle,
                                               default_optimizer)
    from ray_tpu_torch.models.weights import serving_dtypes
    cfg = llama.config("8b", n_layers=CKPT_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(11)
    tree = llama.init_params(
        dataclasses.replace(cfg, param_dtype=torch.bfloat16), gen, dev)
    nbytes = tree_bytes(tree)
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint_io.save_llama_checkpoint(cfg, tree, tmp)
        checkpoint_io.save_config(cfg, tmp)
        write_s = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
        disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in files)
        t0 = time.perf_counter()
        srv = checkpoint_io.load_llama_params(cfg, tmp, dev,
                                              serving_dtypes(cfg))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        log(f"[checkpoint] 8b widths, {cfg.n_layers} layers, bf16: "
            f"{nbytes / 1e9:.3f} GB of tensors, files {files} "
            f"({disk / 1e9:.3f} GB); write {write_s:.2f} s "
            f"({nbytes / write_s / 1e9:.2f} GB/s, into the page cache); "
            f"read into the serving layout {read_s:.2f} s "
            f"({nbytes / read_s / 1e9:.2f} GB/s, from the page cache)")
        del srv
        tok = ByteTokenizer(cfg.vocab_size)
        prompts = [tok.encode(t) for t in PROMPT_TEXTS]
        kw = {k: v for k, v in ENGINE_KW.items() if k != "model"}
        outs = {}
        for label, ecfg, params in (
                ("tensors", EngineConfig(model=cfg, **kw), tree),
                ("checkpoint", EngineConfig(model=None, checkpoint=tmp,
                                            **kw), None)):
            t0 = time.perf_counter()
            eng = InferenceEngine(ecfg, params=params)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            if eng.model_cfg != cfg:
                raise AssertionError(f"checkpoint: config.json gave "
                                     f"{eng.model_cfg}, not {cfg}")
            outs[label], _ = drive(eng, prompts, CKPT_TOKENS, label[0])
            log(f"[checkpoint] engine from {label}: init {init_s:.2f} s; "
                f"first tokens {[o[:4] for o in outs[label]]}")
            eng.release_graphs()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        if outs["checkpoint"] != outs["tensors"]:
            raise AssertionError("checkpoint: the engine from the "
                                 "checkpoint decoded other tokens")
        log(f"[checkpoint] {len(prompts)} prompts x {CKPT_TOKENS} greedy "
            f"tokens: the checkpoint engine token-exact")
        opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                                total_steps=100)
        rng = np.random.default_rng(2)
        bundle = TrainStepBundle(cfg, optimizer=opt)
        tokens = bundle.shard_batch(rng.integers(
            0, cfg.vocab_size, (1, TRAIN_SEQ)).astype(np.int32))
        t0 = time.perf_counter()
        state = bundle.init_state_from_checkpoint(tmp)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        source = dict(_named(tree))
        for path, a in _named(state[0]):
            if a.dtype != torch.float32 or not torch.equal(
                    a, source[path].float()):
                raise AssertionError(f"checkpoint: {path} is not the "
                                     f"upcast source")
        _, m_ck = bundle.step(state, tokens)
        m_ck = _sync_metrics(m_ck)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        _, m_np = bundle.step(bundle.state_from_numpy(tree), tokens)
        m_np = _sync_metrics(m_np)
        log(f"[checkpoint] init_state_from_checkpoint at float32 "
            f"{train_s:.2f} s ({nbytes / train_s / 1e9:.2f} GB/s of the "
            f"file): parameters bit-equal to the upcast source; one step's "
            f"loss {m_ck['loss']:.6f} vs {m_np['loss']:.6f} from "
            f"state_from_numpy")
        if m_ck["loss"] != m_np["loss"]:
            raise AssertionError("checkpoint: the step from the checkpoint "
                                 "gave another loss")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, bytes=nbytes, disk_bytes=disk,
                write_s=write_s, write_gb_s=nbytes / write_s / 1e9,
                read_serving_s=read_s, read_serving_gb_s=nbytes / read_s / 1e9,
                read_train_s=train_s, read_train_gb_s=nbytes / train_s / 1e9,
                tokens=outs["checkpoint"], loss=m_ck["loss"])


RL_GATE_ITERS = 25      # tests' test_ppo_learns_cartpole: best > 120 within
RL_GATE = 120.0         # 25 iterations (the first and 24 more)
RL_WIDE_ENVS = 4096     # 6d(b): 4096 envs x 128 steps, minibatch 16384,
RL_WIDE_T = 128         # 4 epochs: 524 288 env steps an iteration
RL_WIDE_MB = 16384
RL_TIMED = 3            # timed iterations after a warm one
RL_OBS_TOL = 1e-4       # card vs CPU obs: float32 physics, other libm
RL_NEAR_TIE = 1e-4      # top-two Gumbel-perturbed score gap of a near tie


def rl_fragment(runner):
    """A runner's next fragment through its stages, and each step's gap
    between the two best Gumbel-perturbed scores [T, B] (host)."""
    draws = runner._draw()
    out = runner._finish(runner._steps(draws))
    with torch.no_grad():
        logits = runner.module(torch.as_tensor(
            out["batch"]["obs"], device=runner.device))["action_dist_inputs"]
    top = (logits + draws["act"][0]).topk(2, dim=-1).values
    return out, (top[..., 0] - top[..., 1]).cpu().numpy()


def rl_near_tie(out, ref, gaps, label):
    """The card's fragment against the CPU's by the runner test's rule:
    each env up to its first step whose gap is <= RL_NEAR_TIE, actions and
    dones equal, obs within RL_OBS_TOL; the stats equal when no env met a
    near tie. Returns the envs that met one."""
    b, rb = out["batch"], ref["batch"]
    T, B = gaps.shape
    tied = 0
    for e in range(B):
        for t in range(T):
            where = f"{label}: step {t}, env {e}, gap {gaps[t, e]:.3g}"
            d = float(abs(b["obs"][t, e] - rb["obs"][t, e]).max())
            if d > RL_OBS_TOL:
                raise AssertionError(f"{where}: obs {d:.3g} apart")
            if gaps[t, e] <= RL_NEAR_TIE:
                tied += 1
                break
            if (b["actions"][t, e] != rb["actions"][t, e]
                    or b["dones"][t, e] != rb["dones"][t, e]):
                raise AssertionError(f"{where}: another action or done")
    if not tied and out["stats"] != ref["stats"]:
        raise AssertionError(f"{label}: stats {out['stats']} against "
                             f"{ref['stats']}")
    return tied


def rl_gate(dev):
    """6d(a): PPO on CartPole at the gate's configuration on the card."""
    from ray_tpu_torch.rllib import PPOConfig, SingleAgentEnvRunner
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(lr=3e-4, minibatch_size=256, num_epochs=4)
            .debugging(seed=0).build())
    group = algo.env_runner_group
    runner = group._local
    if {runner.device.type, algo.learner_group.device.type} != {dev.type}:
        raise AssertionError(f"6d(a): runner on {runner.device}, learner "
                             f"on {algo.learner_group.device}, not {dev}")
    cpu = SingleAgentEnvRunner("CartPole-v1", num_envs=16, rollout_length=128,
                               seed=0, device="cpu")
    cpu.set_weights({k: v.cpu() for k, v in runner.get_weights().items()})
    ref, gaps = rl_fragment(cpu)
    first = {}

    def first_sample():
        # the algorithm's first fragment, through the runner's stages
        first["out"], _ = rl_fragment(runner)
        del group.sample
        return first["out"]
    group.sample = first_sample
    t0 = time.perf_counter()
    rets = []
    for _ in range(RL_GATE_ITERS):
        rets.append(algo.train()["episode_return_mean"])
        if max(rets) > RL_GATE:
            break
    wall = time.perf_counter() - t0
    tied = rl_near_tie(first["out"], ref, gaps, "6d(a) first fragment")
    log(f"[rllib] (a) PPO CartPole-v1, 16 envs x 128, minibatch 256, 4 "
        f"epochs, seed 0, on {runner.device}: returns "
        f"{[round(r, 1) for r in rets]} in {wall:.2f} s; first fragment "
        f"against the CPU's: {16 - tied} of 16 envs step-exact for 128 "
        f"steps, {tied} cut at a near tie")
    if not max(rets) > RL_GATE:
        raise AssertionError(f"6d(a): PPO best {max(rets):.1f} within "
                             f"{RL_GATE_ITERS} iterations, not > {RL_GATE}")
    return dict(returns=rets, iterations=len(rets), wall_s=wall,
                near_tie_envs=tied)


def rl_wide(dev):
    """6d(b): PPO on CartPole, 4096 envs x 128 steps: sample and update
    ms, env steps/s, launches a rollout step, host syncs in the step
    loop, the iteration's device idle share, peak memory."""
    from ray_tpu_torch.rllib import PPOConfig
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=RL_WIDE_ENVS,
                         rollout_fragment_length=RL_WIDE_T)
            .training(minibatch_size=RL_WIDE_MB, num_epochs=4)
            .debugging(seed=0).build())
    group, learners = algo.env_runner_group, algo.learner_group
    runner = group._local
    times = dict(sample=[], update=[])

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)            # both end in a readback
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    group.sample = timed("sample", group.sample)
    learners.update = timed("update", learners.update)
    algo.train()                                    # warm
    for v in times.values():
        v.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(RL_TIMED):
        t0 = time.perf_counter()
        m = algo.train()
        iters.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(m["learner/total_loss"]):
            raise AssertionError(f"6d(b): loss {m['learner/total_loss']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del group.sample, learners.update
    steps = RL_WIDE_ENVS * RL_WIDE_T
    # the step loop under the sync guard: any host sync raises
    draws = runner._draw()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = runner._steps(draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    runner._finish(batch)
    draws = runner._draw()

    def nonempty(evs):
        return None if evs else "no device kernel"
    prof, loop_wall = profiled(lambda: runner._steps(draws),
                               "rllib rollout steps", check=nonempty,
                               report=True)
    evs = device_events(prof)
    launches = sum(e.count for e in evs) / RL_WIDE_T
    loop_busy = sum(dev_us(e) for e in evs) / 1e3
    prof, it_wall = profiled(algo.train, "rllib iteration", check=nonempty,
                             report=True)
    evs = device_events(prof)
    it_busy = sum(dev_us(e) for e in evs) / 1e3
    it_launches = sum(e.count for e in evs)
    n_opt = 4 * (steps // RL_WIDE_MB)
    opt_launches = (it_launches - launches * RL_WIDE_T) / n_opt
    groups = {g: round(r["ms"], 3) for g, r in kernel_groups(evs).items()}
    res = dict(envs=RL_WIDE_ENVS, T=RL_WIDE_T, minibatch=RL_WIDE_MB,
               env_steps=steps, sample_ms=statistics.median(times["sample"]),
               update_ms=statistics.median(times["update"]),
               iteration_ms=statistics.median(iters), iterations_ms=iters,
               samples_ms=times["sample"], updates_ms=times["update"],
               launches_a_step=launches, loop_wall_ms=loop_wall,
               loop_busy_ms=loop_busy, host_syncs_in_loop=0,
               iteration_wall_ms=it_wall, iteration_busy_ms=it_busy,
               iteration_launches=it_launches,
               launches_an_optimizer_step=opt_launches,
               idle_share=max(0.0, 1 - it_busy / it_wall),
               groups=groups, peak_gib=peak)
    res["env_steps_per_s"] = steps / res["iteration_ms"] * 1e3
    res["sample_env_steps_per_s"] = steps / res["sample_ms"] * 1e3
    log(f"[rllib] (b) PPO CartPole-v1, {RL_WIDE_ENVS} envs x {RL_WIDE_T} "
        f"steps ({steps} env steps), minibatch {RL_WIDE_MB}, 4 epochs: "
        f"sample {res['sample_ms']:.2f} ms, update {res['update_ms']:.2f} "
        f"ms, iteration {res['iteration_ms']:.2f} ms (medians of "
        f"{RL_TIMED}; {[round(x, 2) for x in iters]}); "
        f"{res['env_steps_per_s']:.0f} env steps/s an iteration, "
        f"{res['sample_env_steps_per_s']:.0f} sampling")
    log(f"[rllib] (b) rollout step loop: {launches:.1f} kernel launches a "
        f"step (profiler), 0 host syncs (set_sync_debug_mode('error')); "
        f"{RL_WIDE_T} steps {loop_wall:.2f} ms under the profiler, kernels "
        f"{loop_busy:.2f} ms")
    log(f"[rllib] (b) one iteration under the profiler: wall {it_wall:.2f} "
        f"ms, {it_launches} kernel launches (~{opt_launches:.0f} an "
        f"optimizer step of {n_opt}, beside the rollout's), kernels "
        f"{it_busy:.2f} ms, device idle "
        f"{100 * res['idle_share']:.1f}%; kernel ms by group {groups}; "
        f"peak memory {peak:.3f} GiB")
    return res


def rl_others(dev):
    """6d(c): IMPALA, APPO and DQN on CartPole at their tests'
    configurations (5 iterations each) and CNN PPO on the pixel catch env
    (3): finite losses, the return metric."""
    from ray_tpu_torch.rllib import (APPOConfig, CNNRLModule, DQNConfig,
                                     IMPALAConfig, PPOConfig)
    runs = {
        "IMPALA": (IMPALAConfig().environment("CartPole-v1")
                   .env_runners(num_envs_per_env_runner=16,
                                rollout_fragment_length=64)
                   .training(lr=2e-3, entropy_coeff=0.005), 5),
        "APPO": (APPOConfig().environment("CartPole-v1")
                 .env_runners(num_envs_per_env_runner=16,
                              rollout_fragment_length=64)
                 .training(lr=2e-3, entropy_coeff=0.005, num_epochs=2,
                           minibatch_size=512), 5),
        "DQN": (DQNConfig().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(lr=1e-3, buffer_size=20_000, train_batch_size=128,
                          num_updates_per_iter=16,
                          num_steps_before_learning=500,
                          target_network_update_freq=50, epsilon=0.15), 5),
        "PPO CNN CatchPixels": (
            PPOConfig().environment("CatchPixels-v0")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=80)
            .training(lr=1e-3, minibatch_size=320, num_epochs=4,
                      entropy_coeff=0.01)
            .rl_module(module_class=CNNRLModule), 3),
    }
    res = {}
    for name, (cfg, n) in runs.items():
        algo = cfg.debugging(seed=0).build()
        t0 = time.perf_counter()
        ms = [algo.train() for _ in range(n)]
        wall = time.perf_counter() - t0
        losses = [m["learner/total_loss"] for m in ms
                  if "learner/total_loss" in m]
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"6d(c) {name}: losses {losses}")
        rets = [round(m["episode_return_mean"], 2) for m in ms]
        res[name] = dict(iterations=n, returns=rets, losses=losses,
                         wall_s=wall)
        log(f"[rllib] (c) {name}: {n} iterations {wall:.2f} s, "
            f"episode_return_mean {rets}, total_loss "
            f"{[round(x, 4) for x in losses]}")
        del algo
    return res


def run_rllib(dev):
    """Phase 6d: RLlib's single-learner path on the card."""
    from ray_tpu_torch.ops import _kernels
    before = _kernels.launch_counts()
    res = dict(gate=rl_gate(dev), wide=rl_wide(dev), others=rl_others(dev))
    after = _kernels.launch_counts()
    if after != before:
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        raise AssertionError(f"6d: kernel launch counters moved: {moved}")
    log(f"[rllib] (d) the launch counters of the {len(after)} kernels "
        f"unchanged across 6d")
    gc.collect()
    torch.cuda.empty_cache()
    return res


SAN_TOKENS = 240        # output tokens a request: live through the window
SAN_TIMED = 16          # steady decode ticks timed, armed and disarmed
SAN_TICKS = 200         # graph-replayed decode ticks hammered and guarded
SAN_WINDOW = 8          # ticks a dispatch_guard window (it holds the lock)


def san_engine(params, prompts, label, hammer=None):
    """An `8b` engine on `params` (built now: armed, if the sanitizer is)
    serving phase 5's prompts greedily, SAN_TOKENS each, all admitted at
    once: prefill, 3 decode ticks (the capture), SAN_TIMED timed steady
    ticks, then SAN_TICKS ticks in dispatch_guard windows of SAN_WINDOW
    (with `hammer` threads running, if given), then to the end. Returns
    (tokens, tick ms, the window's numbers)."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request
    from ray_tpu_torch import SamplingParams
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    eng = InferenceEngine(EngineConfig(decode_impl="kernel", **ENGINE_KW),
                          params=params)
    reqs = [Request(f"san{i}", list(p), SamplingParams(max_tokens=SAN_TOKENS))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(3):
        eng.step()
    walls = []
    for _ in range(SAN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    threads, stop = [], threading.Event()
    if hammer is not None:
        threads = [threading.Thread(target=hammer, args=(eng, stop),
                                    daemon=True) for _ in range(3)]
        for t in threads:
            t.start()
    _kernels.reset_launch_counts()
    d0, c0 = eng.dispatches, eng.compiles
    reports = []
    t0 = time.perf_counter()
    try:
        for _ in range(SAN_TICKS // SAN_WINDOW):
            with dispatch_guard(engine=eng) as rep:
                for _ in range(SAN_WINDOW):
                    eng.step()
            reports.append(rep)
            time.sleep(0.001)       # the hammers take the lock here
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    counts = _kernels.launch_counts()
    n = eng.model_cfg.n_layers * SAN_TICKS
    if eng.dispatches - d0 != SAN_TICKS or eng.compiles != c0:
        raise AssertionError(f"5i {label}: {eng.dispatches - d0} dispatches "
                             f"and {eng.compiles - c0} compiles over "
                             f"{SAN_TICKS} ticks")
    for rep in reports:
        if rep.uploads or rep.captures or rep.readbacks != SAN_WINDOW:
            raise AssertionError(f"5i {label}: a guarded window saw uploads "
                                 f"{rep.uploads}, captures {rep.captures}, "
                                 f"{rep.readbacks} readbacks")
    if counts["paged_decode"] != n or counts["ragged_paged"]:
        raise AssertionError(f"5i {label}: launches {counts} over "
                             f"{SAN_TICKS} decode ticks, expected "
                             f"paged_decode {n}")
    check_decode_route(_kernels, "paged_decode", n)
    while eng.has_work():
        eng.step()
    out = [list(r.output_tokens) for r in reqs]
    if any(len(o) != SAN_TOKENS for o in out):
        raise AssertionError(f"5i {label}: stream lengths "
                             f"{[len(o) for o in out]}")
    res = dict(tick_ms=statistics.median(walls), ticks_ms=walls,
               window_s=window_s, paged_decode=counts["paged_decode"])
    lock = eng._step_lock
    eng.release_graphs()
    return out, res, lock


def run_sanitizer(dev, params):
    """Phase 5i: the 8b engine with the thread sanitizer armed, its
    lock-taking host entry points hammered from three threads while it
    steps 200 guarded graph-replayed decode ticks."""
    from ray_tpu_torch import ByteTokenizer
    from ray_tpu_torch.util import thread_sanitizer as ts
    tok = ByteTokenizer(128256)
    prompts = [tok.encode(t) for t in PROMPT_TEXTS]
    want, plain, plain_lock = san_engine(params, prompts, "disarmed")
    if not isinstance(plain_lock, type(threading.RLock())):
        raise AssertionError(f"5i: a disarmed engine's lock is "
                             f"{type(plain_lock)}, not the device's RLock")
    calls = dict(n=0)
    errors = []

    def hammer(eng, stop):
        try:
            while not stop.is_set():
                eng.stats()
                eng.lane_counts()
                eng.session_ids()
                eng.fleet_counters()
                eng.has_work()
                if eng.abort("no-such-id") is not False \
                        or eng.preempt("no-such-id") is not False \
                        or eng.export_session("no-such-id") is not None:
                    raise AssertionError("an unknown id was found")
                calls["n"] += 1
        except BaseException as e:      # reported by the main thread
            errors.append(e)

    with ts.sanitized():
        got, armed, lock = san_engine(params, prompts, "armed", hammer)
    if errors:
        raise AssertionError(f"5i: a hammer thread failed: {errors[0]!r}")
    ts.assert_clean()
    if not isinstance(lock, ts._TracedRLock) or lock._lock is not plain_lock:
        raise AssertionError(f"5i: the armed engine's lock {lock!r} is not "
                             f"the device's traced lock")
    if calls["n"] < 1:
        raise AssertionError("5i: the hammer threads never got the lock")
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"5i: armed tokens differ from the disarmed "
                             f"engine's in requests {bad}")
    sites = dict(lock.reentry_sites)
    log(f"[sanitizer] 5i: 8b bf16 engine, 6 prompts x {SAN_TOKENS} tokens; "
        f"{SAN_TICKS} graph-replayed decode ticks in guarded windows of "
        f"{SAN_WINDOW}, 3 threads hammering stats/lane_counts/session_ids/"
        f"fleet_counters/has_work/abort/preempt/export_session "
        f"({calls['n']} rounds): 1 dispatch a tick, 0 compiles, 0 uploads, "
        f"0 captures, 1 readback a tick, paged_decode "
        f"{armed['paged_decode']} launches (pipelined), 0 violations, "
        f"tokens equal to the disarmed engine's")
    log(f"[sanitizer] 5i: decode tick median armed "
        f"{armed['tick_ms']:.3f} ms against disarmed {plain['tick_ms']:.3f} "
        f"ms over {SAN_TIMED} ticks (armed "
        f"{[round(x, 3) for x in armed['ticks_ms']]}; disarmed "
        f"{[round(x, 3) for x in plain['ticks_ms']]}); the hammered "
        f"window {armed['window_s']:.2f} s against {plain['window_s']:.2f} "
        f"s; lock {lock.name}, re-entries by site {sites}, order edges "
        f"{ts.order_edges()}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(armed=armed, disarmed=plain, hammer_rounds=calls["n"],
                reentry_sites=sites, lock=lock.name,
                order_edges=[list(e) for e in ts.order_edges()])


SAC_GATE_ITERS = 25     # test_sac_learns_pendulum: best of returns[5:] >
SAC_GATE = 150.0        # returns[0] + 150 within 25 iterations
SAC_WIDE_ENVS = 1024    # 6e(b): 1024 envs x 64 steps, train batch 4096,
SAC_WIDE_T = 64         # 32 updates an iteration
SAC_WIDE_BATCH = 4096
SAC_WIDE_UPDATES = 32
DREAMER_GATE_ITERS = 120    # test_dreamer_learns_cartpole_in_imagination:
DREAMER_GATE = 120.0        # best > 120 within the first and 120 more
MA_GATE_ITERS = 24      # test_multi_agent_ppo_two_policies_learn: both
MA_GATE = 60.0          # agents' best > 60 within the first and 24 more
SAC_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chip_smoke_data",
                           "sac_pendulum_jax_init_seed0.npz")


def load_fixture_tree(path):
    """An .npz of "layer/leaf" arrays as a flax-shaped tree."""
    import numpy as np
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            layer, leaf = k.split("/")
            tree.setdefault(layer, {})[leaf] = z[k]
    return tree


def sac_gate(dev):
    """6e(a): SAC on Pendulum at test_sac_learns_pendulum's configuration
    from the JAX learner's initial weights (the committed fixture, as
    the CPU test starts); returns the trained algorithm too."""
    import numpy as np
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.core.rl_module import params_from_flax
    algo = (SACConfig().environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=64)
            .training(lr=3e-3, buffer_size=50_000, train_batch_size=256,
                      num_updates_per_iter=32,
                      num_steps_before_learning=1_000, action_scale=2.0)
            .debugging(seed=0).build())
    learner = algo.learner_group._local
    if learner.device.type != dev.type:
        raise AssertionError(f"6e(a): learner on {learner.device}")
    init = load_fixture_tree(SAC_FIXTURE)
    params_from_flax(learner.module, init)
    params_from_flax(learner.target, init)
    algo.env_runner_group.sync_weights(learner.get_weights())
    rets = []
    t0 = time.perf_counter()
    for _ in range(SAC_GATE_ITERS):
        m = algo.train()
        if not np.isnan(m["episode_return_mean"]):
            rets.append(m["episode_return_mean"])
    wall = time.perf_counter() - t0
    log(f"[rllib] 6e(a) SAC Pendulum-v1, 16 envs x 64, batch 256, 32 "
        f"updates an iteration, from the JAX init: returns "
        f"{[round(r, 1) for r in rets]} in {wall:.2f} s; alpha "
        f"{m['learner/alpha']:.4f}")
    if not rets or not max(rets[5:]) > rets[0] + SAC_GATE:
        raise AssertionError(f"6e(a): SAC best of returns[5:] "
                             f"{max(rets[5:] or [float('nan')]):.1f} not > "
                             f"first {rets[:1]} + {SAC_GATE}")
    return algo, dict(returns=rets, wall_s=wall)


def sac_wide(dev):
    """6e(b): SAC at 1024 envs x 64 steps, train batch 4096, 32 updates:
    sample and update ms, launches an update, host syncs in the update
    step, the iteration's device idle share."""
    from ray_tpu_torch.rllib import SACConfig
    algo = (SACConfig().environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=SAC_WIDE_ENVS,
                         rollout_fragment_length=SAC_WIDE_T)
            .training(train_batch_size=SAC_WIDE_BATCH,
                      num_updates_per_iter=SAC_WIDE_UPDATES,
                      action_scale=2.0)
            .debugging(seed=0).build())
    group, learners = algo.env_runner_group, algo.learner_group
    learner = learners._local
    times = dict(sample=[], update=[])

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)            # both end in a readback
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    group.sample = timed("sample", group.sample)
    learners.update = timed("update", learners.update)
    algo.train()                                    # warm
    for v in times.values():
        v.clear()
    iters = []
    for _ in range(RL_TIMED):
        t0 = time.perf_counter()
        algo.train()
        iters.append((time.perf_counter() - t0) * 1e3)
    del group.sample, learners.update
    # one update's step under the sync guard: any host sync raises
    batch = learner._to_device(algo.replay.sample(SAC_WIDE_BATCH))
    key = learner._next_key()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        learner._sac_step(batch, key)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def nonempty(evs):
        return None if evs else "no device kernel"
    prof, _ = profiled(lambda: learner._sac_step(batch, learner._next_key()),
                       "sac update step", check=nonempty, report=True)
    launches = sum(e.count for e in device_events(prof))
    prof, it_wall = profiled(algo.train, "sac iteration", check=nonempty,
                             report=True)
    it_busy = sum(dev_us(e) for e in device_events(prof)) / 1e3
    steps = SAC_WIDE_ENVS * SAC_WIDE_T
    res = dict(envs=SAC_WIDE_ENVS, T=SAC_WIDE_T, batch=SAC_WIDE_BATCH,
               updates=SAC_WIDE_UPDATES,
               sample_ms=statistics.median(times["sample"]),
               update_ms=statistics.median(times["update"]),
               iteration_ms=statistics.median(iters), iterations_ms=iters,
               launches_an_update=launches, host_syncs_in_step=0,
               readbacks_an_update=1, iteration_wall_ms=it_wall,
               iteration_busy_ms=it_busy,
               idle_share=max(0.0, 1 - it_busy / it_wall))
    res["env_steps_per_s"] = steps / res["iteration_ms"] * 1e3
    log(f"[rllib] 6e(b) SAC Pendulum-v1, {SAC_WIDE_ENVS} envs x "
        f"{SAC_WIDE_T} ({steps} env steps), batch {SAC_WIDE_BATCH}, "
        f"{SAC_WIDE_UPDATES} updates: sample {res['sample_ms']:.2f} ms, "
        f"update {res['update_ms']:.3f} ms each, iteration "
        f"{res['iteration_ms']:.2f} ms (medians of {RL_TIMED}; "
        f"{[round(x, 2) for x in iters]}), {res['env_steps_per_s']:.0f} env "
        f"steps/s; {launches} kernel launches an update step, 0 host syncs "
        f"in it (set_sync_debug_mode('error')) and 1 metrics readback an "
        f"update; one iteration under the profiler: wall {it_wall:.2f} ms, "
        f"kernels {it_busy:.2f} ms, device idle "
        f"{100 * res['idle_share']:.1f}%")
    return res


def offline_phase(dev, sac_algo):
    """6e(c, d): BC and MARWIL from CartPole shards recorded on the card
    by a PPO runner (reward-to-go at gamma 0.99), the reference's gates;
    CQL from Pendulum transitions the trained SAC records on the card."""
    import numpy as np
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, MARWILConfig,
                                     PPOConfig, record_samples)
    from ray_tpu_torch.rllib.algorithms.dqn import _to_transitions
    root = tempfile.mkdtemp(prefix="rllib_offline_")
    try:
        # each test's recording: 3 fragments of a fresh PPO runner, BC's
        # 8 envs x 32 as they are, MARWIL's 8 x 64 with reward-to-go
        for name, T, gamma in (("bc", 32, None), ("marwil", 64, 0.99)):
            ppo = (PPOConfig().environment("CartPole-v1")
                   .env_runners(num_envs_per_env_runner=8,
                                rollout_fragment_length=T).build())
            for i in range(3):
                record_samples(ppo.env_runner_group.sample()["batch"],
                               os.path.join(root, name), shard_index=i,
                               gamma=gamma)
            del ppo
        res = {}
        bc = (BCConfig().environment("CartPole-v1")
              .env_runners(num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .offline_data(input_path=os.path.join(root, "bc"))
              .training(lr=1e-3, num_updates_per_iter=8).build())
        m1, m2 = bc.step(), bc.step()
        res["bc"] = [m1["learner/total_loss"], m2["learner/total_loss"]]
        if not m2["learner/total_loss"] < m1["learner/total_loss"]:
            raise AssertionError(f"6e(c) BC: loss {res['bc']} did not drop")
        marwil = (MARWILConfig().environment("CartPole-v1")
                  .env_runners(num_envs_per_env_runner=4,
                               rollout_fragment_length=32)
                  .offline_data(input_path=os.path.join(root, "marwil"))
                  .training(lr=1e-3, num_updates_per_iter=8)
                  .debugging(seed=0).build())
        ms = [marwil.step() for _ in range(5)]
        res["marwil"] = dict(
            vf_loss=[m["learner/vf_loss"] for m in ms],
            mean_weight=ms[-1]["learner/mean_weight"])
        if not (np.isfinite(ms[-1]["learner/total_loss"])
                and ms[-1]["learner/vf_loss"] < ms[0]["learner/vf_loss"]
                and abs(ms[-1]["learner/mean_weight"] - 1.0) > 1e-3):
            raise AssertionError(f"6e(c) MARWIL: {res['marwil']}")
        for i in range(4):
            sac_algo.step()
            batch = sac_algo.env_runner_group.sample()["batch"]
            os.makedirs(os.path.join(root, "pendulum"), exist_ok=True)
            np.savez(os.path.join(root, "pendulum", f"shard-{i:05d}.npz"),
                     **_to_transitions(batch))
        cfg = (CQLConfig().environment("Pendulum-v1")
               .env_runners(num_envs_per_env_runner=4,
                            rollout_fragment_length=64)
               .offline_data(input_path=os.path.join(root, "pendulum"))
               .training(lr=1e-3, num_updates_per_iter=16,
                         train_batch_size=256, action_scale=2.0)
               .debugging(seed=0))
        cfg.cql_alpha = 2.0
        cql = cfg.build()
        pens = [cql.step()["learner/cql_penalty"] for _ in range(7)]
        res["cql_penalty"] = pens
        if not (np.isfinite(pens).all() and pens[-1] < pens[0]):
            raise AssertionError(f"6e(d) CQL: penalty {pens}")
        log(f"[rllib] 6e(c) BC total_loss {[round(x, 4) for x in res['bc']]};"
            f" MARWIL vf_loss {[round(x, 3) for x in res['marwil']['vf_loss']]}"
            f", mean_weight {res['marwil']['mean_weight']:.4f} (shards "
            f"recorded on the card); 6e(d) CQL penalty "
            f"{[round(x, 3) for x in pens]} (Pendulum transitions recorded "
            f"on the card)")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dreamer_phase(dev):
    """6e(e): DreamerV3 on CartPole at test_rllib_dreamer.py's
    configuration and the module's default widths: best return > 120
    within its 120 iterations; world-model, imagine and update ms and
    launches an update."""
    from ray_tpu_torch.rllib import DreamerV3Config
    from ray_tpu_torch.rllib.algorithms.dreamer_v3 import symlog
    algo = (DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .debugging(seed=0).build())
    learner = algo.learner_group._local
    t0 = time.perf_counter()
    first = algo.train()["episode_return_mean"]
    rets = [first]
    for _ in range(DREAMER_GATE_ITERS):
        rets.append(algo.train()["episode_return_mean"])
        if max(rets) > DREAMER_GATE:
            break
    wall = time.perf_counter() - t0
    # one update's parts, timed with a synchronise around each
    batch = learner._to_device(algo.replay.sample(algo._config.batch_seqs))
    scale = torch.ones((), device=dev)
    B, L = batch["actions"].shape

    def part(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3
    noise = learner._draw(learner._next_key(), B, L)
    (hs, zs, _, _), wm_ms = part(lambda: learner._observe(
        symlog(batch["obs"]), batch["actions"], batch["is_first"],
        noise[0]))
    _, img_ms = part(lambda: learner._imagine(
        hs.detach().reshape(B * L, -1), zs.detach().reshape(B * L, -1),
        noise[1]))
    ups = [part(lambda: learner._dreamer_step(batch, learner._next_key(),
                                              scale))[1] for _ in range(3)]

    def nonempty(evs):
        return None if evs else "no device kernel"
    prof, _ = profiled(lambda: learner._dreamer_step(
        batch, learner._next_key(), scale), "dreamer update",
        check=nonempty, report=True)
    launches = sum(e.count for e in device_events(prof))
    res = dict(returns=rets, iterations=len(rets) - 1, wall_s=wall,
               observe_ms=wm_ms, imagine_ms=img_ms,
               update_ms=statistics.median(ups), updates_ms=ups,
               launches_an_update=launches)
    log(f"[rllib] 6e(e) DreamerV3 CartPole-v1, 8 envs x 64, deter 256, "
        f"stoch 8 x 8, units 128: returns {[round(r, 1) for r in rets]} in "
        f"{wall:.2f} s ({len(rets) - 1} iterations after the first); an "
        f"update of {B} x {L}: observe {wm_ms:.2f} ms, imagine "
        f"{img_ms:.2f} ms, the whole update {res['update_ms']:.2f} ms "
        f"({[round(x, 2) for x in ups]}), {launches} kernel launches")
    if not max(rets) > DREAMER_GATE:
        raise AssertionError(f"6e(e): DreamerV3 best {max(rets):.1f} not > "
                             f"{DREAMER_GATE} within {DREAMER_GATE_ITERS} "
                             f"iterations")
    return res


def multi_agent_phase(dev):
    """6e(f): multi-agent PPO on DualCartPole at
    test_multi_agent_ppo_two_policies_learn's configuration."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig
    algo = (MultiAgentPPOConfig().environment("DualCartPole")
            .multi_agent(policies={"p0": None, "p1": None},
                         policy_mapping_fn=lambda aid: {
                             "cart_0": "p0", "cart_1": "p1"}[aid])
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(lr=3e-4, num_epochs=4, minibatch_size=256)
            .debugging(seed=0).build())
    t0 = time.perf_counter()
    first = algo.train()["agent_episode_returns"]
    best = {aid: -math.inf for aid in ("cart_0", "cart_1")}
    n = 0
    for _ in range(MA_GATE_ITERS):
        rets = algo.train()["agent_episode_returns"]
        n += 1
        for aid in best:
            best[aid] = max(best[aid], rets.get(aid, -math.inf))
        if all(v > MA_GATE for v in best.values()):
            break
    wall = time.perf_counter() - t0
    log(f"[rllib] 6e(f) multi-agent PPO DualCartPole, two policies, 16 envs "
        f"x 128: first {first}, best {best} after {n} iterations, "
        f"{wall:.2f} s")
    if not (all(v > MA_GATE for v in best.values())
            and all(best[a] > first.get(a, 0) for a in best)):
        raise AssertionError(f"6e(f): multi-agent PPO first {first} best "
                             f"{best}")
    return dict(first=first, best=best, iterations=n, wall_s=wall)


def run_rllib_more(dev):
    """Phase 6e: SAC, offline BC/MARWIL, CQL, DreamerV3 and multi-agent
    PPO on the card; the kernels' launch counters unchanged."""
    from ray_tpu_torch.ops import _kernels
    before = _kernels.launch_counts()
    phase_s = {}
    t0 = time.perf_counter()
    sac_algo, gate = sac_gate(dev)
    phase_s["sac_gate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = sac_wide(dev)
    phase_s["sac_wide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    offline = offline_phase(dev, sac_algo)
    del sac_algo
    phase_s["offline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dreamer = dreamer_phase(dev)
    phase_s["dreamer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multi = multi_agent_phase(dev)
    phase_s["multi_agent"] = time.perf_counter() - t0
    after = _kernels.launch_counts()
    if after != before:
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        raise AssertionError(f"6e: kernel launch counters moved: {moved}")
    log(f"[rllib] 6e(g) the launch counters of the {len(after)} kernels "
        f"unchanged across 6e; seconds by part "
        f"{({k: round(v, 1) for k, v in phase_s.items()})}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(sac_gate=gate, sac_wide=wide, offline=offline,
                dreamer=dreamer, multi_agent=multi, seconds=phase_s)


# ------------------------------------------------- the actor runtime (6f)

RT_TASKS = 2000           # empty tasks timed for tasks/s
RT_CALLS = 1000           # empty actor calls timed one at a time
RT_PUT_BYTES = 1 << 30    # the bf16 CPU tensor put and got
RT_GPU_RETURN_BYTES = 256 << 20


def expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rt_probe(seed, n):
    """A num_gpus=1 task's view: its pin, the card's name, and a CUDA
    tensor from seeded elementwise work (the main process repeats it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, device="cuda", generator=g)
    y = (x.sin() * 3 + x.cos()).to(torch.bfloat16)
    return dict(visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                name=torch.cuda.get_device_name(), pid=os.getpid(),
                tensor=y)


class EngineActor:
    """Phase 6f's GPU actor: the `8b` engine served through method
    calls. Facts only: the main process checks them."""

    def __init__(self, engine_kw, cwd):
        self.cuda_at_start = torch.cuda.is_initialized()
        os.chdir(cwd)                 # kernels load by absolute path
        from ray_tpu_torch import EngineConfig, InferenceEngine
        from ray_tpu_torch.ops import _kernels
        self.kernels = _kernels
        self.build = dict(_kernels.build())
        self.build.pop("ptxas", None)
        self.eng = InferenceEngine(EngineConfig(decode_impl="kernel",
                                                **engine_kw))
        torch.cuda.synchronize()

    def facts(self):
        return dict(pid=os.getpid(), ppid=os.getppid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    cuda_at_start=self.cuda_at_start,
                    cuda_now=torch.cuda.is_initialized(),
                    name=torch.cuda.get_device_name(), build=self.build,
                    n_layers=self.eng.model_cfg.n_layers)

    def first_token(self, prompt):
        """Phase 5's warm-up request (prompt 4, 2 tokens): the first
        request of this engine."""
        from ray_tpu_torch import SamplingParams
        return self.eng.generate([prompt],
                                 SamplingParams(max_tokens=2))[0].output_tokens

    def serve(self, prompts, max_tokens):
        """Phase 5's greedy drive: 3 requests, then one more a tick."""
        from ray_tpu_torch import Request, SamplingParams
        self.kernels.reset_launch_counts()
        r0, d0 = self.eng.ragged_ticks, self.eng.decode_ticks
        reqs = [Request(f"a{i}", list(p), SamplingParams(max_tokens=max_tokens))
                for i, p in enumerate(prompts)]
        for r in reqs[:3]:
            self.eng.add_request(r)
        pending, ticks, mixed = reqs[3:], [], []
        while self.eng.has_work() or pending:
            r1 = self.eng.ragged_ticks
            t0 = time.perf_counter()
            self.eng.step()
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)
            mixed.append(self.eng.ragged_ticks > r1)
            if pending:
                self.eng.add_request(pending.pop(0))
        return dict(out=[r.output_tokens for r in reqs], ticks_ms=ticks,
                    tick_is_mixed=mixed,
                    launches={k: n for k, n in
                              self.kernels.launch_counts().items() if n},
                    routes=self.kernels.route_counts(),
                    mixed_ticks=self.eng.ragged_ticks - r0,
                    decode_ticks=self.eng.decode_ticks - d0)

    def teacher(self, tokens):
        return teacher_logits(self.eng, tokens).float().cpu()

    def memory(self):
        from ray_tpu_torch.util.profiling import memory_summary
        return memory_summary()


class FreshActor:
    """Phase 6f (d): what a fresh fork of the zygote finds and does."""

    def __init__(self):
        self.cuda_at_start = torch.cuda.is_initialized()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def facts(self):
        return dict(pid=os.getpid(), ppid=os.getppid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    cuda_at_start=self.cuda_at_start,
                    cuda_now=torch.cuda.is_initialized())


def rt_serve(rt, tok_prompts, out5, ticks5):
    """6f (c) and (d). Returns the numbers and the actor's launches.
    `ticks5`: phase 5's greedy tick times, the same tick sequence."""
    res = {}
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(EngineActor).remote(
        ENGINE_KW, tempfile.gettempdir())
    facts = rt.get(actor.facts.remote(), timeout=600)
    res["create_to_ready_s"] = time.perf_counter() - t0
    log(f"[runtime] engine actor pid {facts['pid']} (parent "
        f"{facts['ppid']}), CUDA_VISIBLE_DEVICES={facts['visible']}, "
        f"CUDA at start {facts['cuda_at_start']}; kernels from "
        f"{facts['build']['dir']}, compiled {facts['build']['compiled']}; "
        f"creation to engine ready {res['create_to_ready_s']:.2f} s")
    expect(not facts["cuda_at_start"], "the actor's worker forked with CUDA")
    expect(facts["build"]["compiled"] == [],
           f"the actor compiled {facts['build']['compiled']}: it must load "
           f"phase 2's build")
    expect(facts["visible"] == "0", f"pin {facts['visible']!r}")
    t0 = time.perf_counter()
    rt.get(actor.first_token.remote(tok_prompts[4]), timeout=600)
    res["first_request_to_first_token_ms"] = (time.perf_counter() - t0) * 1e3
    served = rt.get(actor.serve.remote(tok_prompts, 16), timeout=600)
    L = facts["n_layers"]
    want = {"ragged_paged": L * served["mixed_ticks"],
            "paged_decode": L * served["decode_ticks"]}
    expect(len(ticks5) == len(served["ticks_ms"]),
           f"{len(served['ticks_ms'])} ticks in the actor, phase 5 "
           f"{len(ticks5)}")
    decode = [i for i, m in enumerate(served["tick_is_mixed"]) if not m]
    res["decode_tick_ms"] = statistics.median(
        served["ticks_ms"][i] for i in decode)
    res["decode_tick_ms_phase5"] = statistics.median(ticks5[i]
                                                     for i in decode)
    log(f"[runtime] actor served {served['mixed_ticks']} mixed and "
        f"{served['decode_ticks']} decode ticks, launches "
        f"{served['launches']}; decode tick median "
        f"{res['decode_tick_ms']:.2f} ms (phase 5 "
        f"{res['decode_tick_ms_phase5']:.2f}), all ticks "
        f"{statistics.median(served['ticks_ms']):.2f} (phase 5 "
        f"{statistics.median(ticks5):.2f}); first request to first "
        f"token {res['first_request_to_first_token_ms']:.1f} ms")
    expect(served["launches"] == want and min(want.values()) > 0,
           f"actor launches {served['launches']}, expected {want}")
    expect(served["routes"].get("paged_decode") ==
           {"pipelined": want["paged_decode"]},
           f"decode routes {served['routes'].get('paged_decode')}")
    exact = served["out"] == out5
    log(f"[runtime] actor greedy streams identical to phase 5's: {exact}")
    for i, (a, b) in enumerate(zip(served["out"], out5)):
        if a == b:
            continue
        j = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        lg = rt.get(actor.teacher.remote(tok_prompts[i] + a[:j]))
        gap = abs(lg[a[j]].item() - lg[b[j]].item())
        log(f"[runtime] request {i} diverges at output {j}: actor {a[j]}, "
            f"phase 5 {b[j]}, gap {gap:.4f} (margin {NEAR_TIE})")
        expect(len(a) == len(b) and gap <= NEAR_TIE,
               f"request {i}: the actor's stream differs beyond a near tie")
    mem = rt.get(actor.memory.remote())
    res.update(exact=exact, ticks_ms=served["ticks_ms"],
               tick_ms=statistics.median(served["ticks_ms"]),
               tick_ms_phase5=statistics.median(ticks5),
               mixed_ticks=served["mixed_ticks"],
               decode_ticks=served["decode_ticks"],
               actor_peak_bytes=mem["cuda_max_allocated_bytes"],
               actor_rss_bytes=mem["rss_bytes"], actor_pid=facts["pid"])
    # (d) a second GPU actor waits for the card, then starts fresh
    other = rt.remote(num_gpus=1)(FreshActor).remote()
    ready, _ = rt.wait([other.facts.remote()], timeout=3.0)
    expect(not ready, "a second num_gpus=1 actor started beside the first")
    t0 = time.perf_counter()
    rt.kill(actor)
    fresh = rt.get(other.facts.remote(), timeout=300)
    res["second_actor_after_kill_s"] = time.perf_counter() - t0
    log(f"[runtime] second GPU actor pending while the first held the "
        f"card; after kill it started in {res['second_actor_after_kill_s']:.2f}"
        f" s: pid {fresh['pid']} (parent {fresh['ppid']}), CUDA at start "
        f"{fresh['cuda_at_start']}, after init {fresh['cuda_now']}, "
        f"CUDA_VISIBLE_DEVICES={fresh['visible']}")
    expect(fresh["pid"] != facts["pid"] and fresh["ppid"] == facts["ppid"]
           and fresh["ppid"] != os.getpid(),
           "the second actor is not a fresh fork of the zygote")
    expect(not fresh["cuda_at_start"] and fresh["cuda_now"]
           and fresh["visible"] == "0", f"second actor: {fresh}")
    rt.kill(other)
    return res, served["launches"]


def rt_host_numbers(rt):
    """6e (e): the runtime's host costs on this machine."""
    @rt.remote
    def noop():
        return None

    @rt.remote
    class Pinger:
        def ping(self):
            return None

    rt.get([noop.remote() for _ in range(200)], timeout=300)   # warm
    t0 = time.perf_counter()
    rt.get([noop.remote() for _ in range(RT_TASKS)], timeout=600)
    tasks_s = RT_TASKS / (time.perf_counter() - t0)
    p = Pinger.remote()
    for _ in range(50):
        rt.get(p.ping.remote())
    rtt = []
    for _ in range(RT_CALLS):
        t0 = time.perf_counter()
        rt.get(p.ping.remote())
        rtt.append((time.perf_counter() - t0) * 1e6)
    rtt.sort()
    rt.kill(p)
    big = torch.ones(RT_PUT_BYTES // 2, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    ref = rt.put(big)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rt.get(ref)
    get_s = time.perf_counter() - t0
    expect(back.dtype == torch.bfloat16 and torch.equal(back, big),
           "the 1 GiB bf16 tensor came back changed")
    del back, ref, big
    # the host's own rate into fresh pages (one thread), which bounds a
    # put (into a new segment) and a get (into a new tensor)
    t0 = time.perf_counter()
    fresh = torch.empty(RT_PUT_BYTES, dtype=torch.uint8)
    fresh.numpy()[:] = 1
    fill_s = time.perf_counter() - t0
    del fresh

    @rt.remote(num_gpus=1)
    def gpu_tensor(nbytes):
        return torch.full((nbytes // 4,), 3.0, device="cuda")

    rt.get(gpu_tensor.remote(1 << 20), timeout=300)     # warm the worker
    t0 = time.perf_counter()
    out = rt.get(gpu_tensor.remote(RT_GPU_RETURN_BYTES), timeout=300)
    gpu_ms = (time.perf_counter() - t0) * 1e3
    expect(out.device.type == "cpu" and out.numel() * 4 ==
           RT_GPU_RETURN_BYTES and bool((out == 3.0).all()),
           "the GPU task's tensor did not arrive whole on the CPU")
    res = dict(tasks_per_s=tasks_s,
               actor_call_us_p50=rtt[len(rtt) // 2],
               actor_call_us_p99=rtt[int(len(rtt) * 0.99) - 1],
               put_gb_s=RT_PUT_BYTES / put_s / 1e9,
               get_gb_s=RT_PUT_BYTES / get_s / 1e9,
               fresh_fill_gb_s=RT_PUT_BYTES / fill_s / 1e9,
               gpu_return_256mib_ms=gpu_ms)
    log(f"[runtime] host (this card's machine): {tasks_s:.0f} empty tasks/s "
        f"over {RT_TASKS}; actor call round trip p50 "
        f"{res['actor_call_us_p50']:.0f} us, p99 "
        f"{res['actor_call_us_p99']:.0f} us over {RT_CALLS}; 1 GiB bf16 "
        f"put {res['put_gb_s']:.2f} GB/s, get {res['get_gb_s']:.2f} GB/s "
        f"(1 GiB into fresh pages, one thread: "
        f"{res['fresh_fill_gb_s']:.2f} GB/s); "
        f"256 MiB CUDA tensor from a GPU task {gpu_ms:.1f} ms")
    return res


def run_runtime(dev, out5, ticks5):
    """Phase 6f: the actor runtime on the card. Returns its numbers and
    the engine actor's launch counts by kernel; leaves the runtime up
    for 6g (shuts it down if 6f fails)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import ByteTokenizer
    from ray_tpu_torch.ops import _kernels
    gc.collect()
    torch.cuda.empty_cache()
    before = _kernels.launch_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt.init()
    try:
        res = dict(init_s=time.perf_counter() - t0,
                   resources=rt.cluster_resources(), main_held_bytes=held)
        types = {k: v for k, v in res["resources"].items()
                 if k.startswith("GPU-")}
        log(f"[runtime] init {res['init_s']:.2f} s; cluster resources "
            f"{res['resources']}")
        expect(res["resources"].get("GPU") == 1.0 and list(types.values())
               == [1.0], f"GPU detection: {res['resources']}")
        tok = ByteTokenizer(128256)
        prompts = [tok.encode(t) for t in PROMPT_TEXTS]
        served, actor_launches = rt_serve(rt, prompts, out5, ticks5)
        res.update(served)
        # (b) a GPU task's view and its tensor
        probe = rt.get(rt.remote(num_gpus=1)(rt_probe).remote(7, 1 << 20),
                       timeout=300)
        mine = rt_probe(7, 1 << 20)["tensor"].cpu()
        log(f"[runtime] GPU task: CUDA_VISIBLE_DEVICES={probe['visible']}, "
            f"{probe['name']}; its tensor on {probe['tensor'].device}, "
            f"bit-equal to this process's: "
            f"{torch.equal(probe['tensor'], mine)}")
        expect(probe["visible"] == "0" and probe["name"] ==
               torch.cuda.get_device_name(0), f"GPU task saw {probe}")
        expect(probe["tensor"].device.type == "cpu"
               and torch.equal(probe["tensor"].view(torch.int16),
                               mine.view(torch.int16)),
               "the GPU task's tensor differs from this process's")
        res["host"] = rt_host_numbers(rt)
        res["main_peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[runtime] device memory: this process held "
            f"{held / 2**30:.3f} GiB at 6f's start, peak "
            f"{res['main_peak_bytes'] / 2**30:.3f} "
            f"GiB in 6f; engine actor peak "
            f"{res['actor_peak_bytes'] / 2**30:.3f} GiB")
    except BaseException:
        rt.shutdown()
        raise
    after = _kernels.launch_counts()
    expect(after == before, f"this process's launch counters moved in 6f: "
           f"{before} -> {after}")
    return res, actor_launches


# ------------------------------------------- the libraries on the runtime

PHASE6_PR14_STEP_MS = 337.85   # PERF.md: phase 6's step median in PR 14
LIB_TRAIN_PRESET = "8b"  # phase 6's preset
LIB_DEVICE = None       # the loops' device: None is each worker's card
LIB_USE_GPU = True      # TrainWorkers reserve a GPU
# 6g(b)'s resume drill and 6g(d)'s trials: the `tiny` preset cut to 2
# layers (8.4M float32 parameters), batch 4 x 512, no remat (a fresh
# worker's first remat step imports torch's checkpoint machinery, ~840
# modules, and each of these runs starts a fresh worker)
LIB_DRILL = dict(preset="tiny", layers=2, batch=4, seq=512, seed=0,
                 lr=1e-3, warmup=0, remat=False)
LIB_DRILL_STEPS = 6
LIB_DRILL_FAIL_AFTER = 3
LIB_TUNE_LRS = (1e-5, 1e-3)
LIB_TUNE_STEPS = 3
LIB_IMPALA_ITERS = 5


def _lib_sync(device):
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lib_train_loop(config):
    """6g(a)'s train_loop_per_worker: phase 6's configuration (the `8b`
    preset at full width, TRAIN_LAYERS layers, seed 0, the same tokens,
    a warm-up and TRAIN_STEPS timed steps) in a TrainWorker, each step
    reported with its loss, grad norm, ms and the worker's launch
    counters."""
    import numpy as np
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (TrainStepBundle,
                                               default_optimizer)
    from ray_tpu_torch.ops import _kernels
    t_enter = time.time()
    dev = config["device"]
    compiled = _kernels.build()["compiled"] if dev is None else []
    cfg = llama.config(config["preset"], n_layers=config["layers"],
                       max_seq=config["seq"])
    bundle = TrainStepBundle(cfg, dev, optimizer=default_optimizer(
        learning_rate=3e-4, warmup_steps=2, total_steps=100))
    state = bundle.init_state(0)
    rng = np.random.default_rng(0)
    tokens = bundle.shard_batch(rng.integers(
        0, cfg.vocab_size, (config["batch"], config["seq"])).astype(
            np.int32))
    _lib_sync(dev)
    t_ready = time.time()
    if bundle.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    for i in range(1 + config["steps"]):
        t0 = time.perf_counter()
        state, m = bundle.step(state, tokens)
        _lib_sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rep = {k: v.item() for k, v in m.items()}
        rep.update(step=i, ms=ms, launches=_kernels.launch_counts(),
                   t_enter=t_enter, t_ready=t_ready,
                   device=str(bundle.device), compiled=len(compiled),
                   visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                   peak_bytes=(torch.cuda.max_memory_allocated()
                               if bundle.device.type == "cuda" else 0))
        train.report(rep)


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def lib_drill_loop(config):
    """6g(b) and (d)'s loop at LIB_DRILL's configuration: with
    config["scratch"], every step saves parameters and AdamW's state
    with Checkpoint.save_pytree and reports them; a checkpoint to start
    from resumes the run after its step; with config["marker"], the
    first attempt raises once after step LIB_DRILL_FAIL_AFTER."""
    import numpy as np
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (TrainStepBundle,
                                               default_optimizer)
    from ray_tpu_torch.train import Checkpoint
    t_enter = time.time()
    dev = config["device"]
    if dev is None:
        from ray_tpu_torch.ops import _kernels
        _kernels.build()
    cfg = llama.config(config["preset"], n_layers=config["layers"],
                       max_seq=config["seq"], remat=config["remat"])
    bundle = TrainStepBundle(cfg, dev, optimizer=default_optimizer(
        learning_rate=config["lr"], warmup_steps=config["warmup"],
        total_steps=100))
    start, resumed = 0, train.get_checkpoint()
    if resumed is None:
        state = bundle.init_state(config["seed"])
    else:
        tree = resumed.load_pytree(device=dev)
        state = (_requires_grad(tree["params"]), tree["opt"])
        start = tree["step"] + 1
    rng = np.random.default_rng(config["seed"])
    tokens = bundle.shard_batch(rng.integers(
        0, cfg.vocab_size, (config["batch"], config["seq"])).astype(
            np.int32))
    for i in range(start, config["steps"]):
        state, m = bundle.step(state, tokens)
        rep = dict(step=i, loss=m["loss"].item(), resumed=start > 0,
                   params=cfg.num_params(), t_enter=t_enter)
        ckpt = None
        if config.get("scratch"):
            d = os.path.join(config["scratch"], f"{start}-{i}")
            ckpt = Checkpoint.save_pytree(
                {"params": state[0], "opt": state[1], "step": i}, d)
        train.report(rep, checkpoint=ckpt)
        marker = config.get("marker")
        if (marker and i == config["fail_after"]
                and not os.path.exists(marker)):
            open(marker, "w").close()
            raise RuntimeError(f"6g(b): the drill's failure after step {i}")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


class CheckpointHolder:
    """6g(b): a worker-side checkpoint that the driver fetches, as a
    TrainWorker's fetch_checkpoint packs and ships one."""

    def __init__(self, path):
        from ray_tpu_torch.train import Checkpoint
        self.ckpt = Checkpoint(path)

    def fetch(self):
        return self.ckpt.pack()


def lib_train(rt, storage, ref):
    """6g(a): phase 6's training in a GPU TrainWorker. `ref`: phase 6's
    numbers from this run."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    before = _kernels.launch_counts()
    first = {}

    def on_report(metrics, checkpoint=None):
        first.setdefault("t", time.perf_counter())
    t_fit = time.time()
    trainer = TorchTrainer(
        lib_train_loop,
        train_loop_config=dict(device=LIB_DEVICE, preset=LIB_TRAIN_PRESET,
                               layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, steps=TRAIN_STEPS),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=LIB_USE_GPU),
        run_config=RunConfig(name="6g-train", storage_path=storage))
    t0 = time.perf_counter()
    result = trainer.fit(on_report=on_report)
    wall = time.perf_counter() - t0
    expect(result.error is None, f"6g(a): {result.error}")
    steps = result.metrics_dataframe
    want = [s["loss"] for s in ref["steps"]]
    got = [s["loss"] for s in steps]
    expect(len(got) == len(want), f"6g(a): {len(got)} reports, phase 6 "
           f"ran {len(want)} steps")
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    bit_equal = got == want
    last = steps[-1]
    counts = last["launches"]
    n = len(steps)
    expected = dict(flash_fwd=2 * TRAIN_LAYERS * n,
                    flash_dq=TRAIN_LAYERS * n, flash_dkv=TRAIN_LAYERS * n)
    timed = [s["ms"] for s in steps[1:]]
    step_ms = statistics.median(timed)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    res = dict(losses=got, phase6_losses=want, loss_rel=rel,
               bit_equal=bit_equal, launches=counts, step_ms_median=step_ms,
               steps_ms=timed, tokens_per_s=tok_s,
               phase6_step_ms_median=ref["step_ms_median"],
               create_to_first_report_s=first["t"] - t0, fit_wall_s=wall,
               worker_peak_bytes=last["peak_bytes"], device=last["device"],
               visible=last["visible"], compiled=last["compiled"],
               fit_to_loop_s=last["t_enter"] - t_fit,
               loop_to_ready_s=last["t_ready"] - last["t_enter"])
    log(f"[libraries] (a) TorchTrainer, 1 GPU worker ({last['device']}, "
        f"CUDA_VISIBLE_DEVICES={last['visible']}, {last['compiled']} "
        f"sources compiled there): phase 6's 8b-width {TRAIN_LAYERS}-layer "
        f"run; losses {[round(x, 5) for x in got]} against phase 6's "
        f"{[round(x, 5) for x in want]}: largest rel {max(rel):.2e} (tol "
        f"{TRAIN_LOSS_RTOL}), bit-equal {bit_equal}")
    log(f"[libraries] (a) step median {step_ms:.2f} ms (phase 6 here "
        f"{ref['step_ms_median']:.2f} ms, PR 14 {PHASE6_PR14_STEP_MS} ms); "
        f"{tok_s:.0f} tokens/s; fit() to the first report "
        f"{res['create_to_first_report_s']:.2f} s (to the loop's start "
        f"{res['fit_to_loop_s']:.2f} s, then to its state on the card "
        f"{res['loop_to_ready_s']:.2f} s), fit() {wall:.2f} s; "
        f"worker peak memory {last['peak_bytes'] / 2**30:.2f} GiB; worker "
        f"launches {({k: v for k, v in counts.items() if v})} (expected "
        f"{expected})")
    expect(max(rel) <= TRAIN_LOSS_RTOL, f"6g(a): losses apart: {rel}")
    if LIB_DEVICE is None:
        for k, w in expected.items():
            expect(counts[k] == w, f"6g(a): worker {k} {counts[k]} != {w}")
        expect(not any(v for k, v in counts.items()
                       if not k.startswith("flash")),
               f"6g(a): a serving kernel ran in the worker: {counts}")
    after = _kernels.launch_counts()
    expect(after == before, f"6g(a): this process's launch counters moved: "
           f"{before} -> {after}")
    return res, counts


def lib_drill(rt, storage):
    """6g(b): the resume drill, against an uninterrupted run."""
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)
    scratch = tempfile.mkdtemp(prefix="6g-drill-", dir=storage)
    marker = os.path.join(storage, "6g-drill-failed-once")
    base = dict(LIB_DRILL, device=LIB_DEVICE, steps=LIB_DRILL_STEPS,
                fail_after=LIB_DRILL_FAIL_AFTER)

    def fit(name, **extra):
        trainer = TorchTrainer(
            lib_drill_loop, train_loop_config=dict(base, **extra),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=LIB_USE_GPU),
            run_config=RunConfig(
                name=name, storage_path=storage,
                failure_config=FailureConfig(max_failures=1),
                checkpoint_config=CheckpointConfig(num_to_keep=2)))
        t0, t_fit = time.perf_counter(), time.time()
        result = trainer.fit()
        expect(result.error is None, f"6g(b) {name}: {result.error}")
        entries = sorted({m["t_enter"] for m in result.metrics_dataframe})
        starts[name] = [t - t_fit for t in entries]
        return result, time.perf_counter() - t0
    starts = {}
    plain, plain_s = fit("6g-plain")
    drill, drill_s = fit("6g-drill", scratch=scratch, marker=marker)
    want = {m["step"]: m["loss"] for m in plain.metrics_dataframe}
    hist = drill.metrics_dataframe
    resumed = [m for m in hist if m["resumed"]]
    expect(os.path.exists(marker) and resumed, "6g(b): the drill did not "
           "fail and resume")
    equal = all(m["loss"] == want[m["step"]] for m in hist)
    kept = sorted(d for d in os.listdir(os.path.join(storage, "6g-drill"))
                  if d.startswith("checkpoint_"))
    last = drill.checkpoint.path
    nbytes = dir_bytes(os.path.join(last, "pytree"))
    holder = rt.remote(num_cpus=1)(CheckpointHolder).remote(last)
    rt.get(holder.fetch.remote(), timeout=120)        # warm
    fetch_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        packed = rt.get(holder.fetch.remote(), timeout=120)
        fetch_ms.append((time.perf_counter() - t0) * 1e3)
    rt.kill(holder)
    res = dict(config=LIB_DRILL, params=hist[0]["params"],
               checkpoint_bytes=nbytes, packed_bytes=len(packed.blob),
               pack_fetch_ms=fetch_ms,
               resumed_steps=[m["step"] for m in resumed],
               losses=[m["loss"] for m in hist], plain=want,
               bit_equal=equal, kept=kept, plain_s=plain_s, drill_s=drill_s,
               loop_starts_s=starts)
    log(f"[libraries] (b) resume drill: `{LIB_DRILL['preset']}` preset, "
        f"{LIB_DRILL['layers']} layers, {hist[0]['params'] / 1e6:.2f}M "
        f"params, batch {LIB_DRILL['batch']}x{LIB_DRILL['seq']}, "
        f"{LIB_DRILL_STEPS} steps, a failure after step "
        f"{LIB_DRILL_FAIL_AFTER}; steps reported {[m['step'] for m in hist]}"
        f", resumed at {res['resumed_steps'][0]}; every loss bit-equal to "
        f"the uninterrupted run's: {equal}; checkpoints kept {kept}; "
        f"one checkpoint {nbytes / 2**20:.1f} MiB (tar "
        f"{len(packed.blob) / 2**20:.1f} MiB), pack and fetch "
        f"{[round(x, 1) for x in fetch_ms]} ms "
        f"({nbytes / 1e6 / statistics.median(fetch_ms):.3f} GB/s); fits "
        f"{plain_s:.1f} s uninterrupted, {drill_s:.1f} s with the restart; "
        f"each attempt's loop started {starts} s after fit()")
    expect(equal, "6g(b): resumed losses differ from the uninterrupted run")
    expect(len(kept) == 2, f"6g(b): checkpoints kept {kept}")
    return res


def lib_rllib(rt, dev):
    """6g(c): PPO with 2 remote runners and 2 learners at the gate's
    configuration, then IMPALA with 2 async remote runners."""
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig

    def ppo(remote):
        cfg = (PPOConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=2 if remote else 0,
                            num_envs_per_env_runner=16,
                            rollout_fragment_length=128)
               .training(lr=3e-4, minibatch_size=256, num_epochs=4)
               .learners(num_learners=2 if remote else 0)
               .debugging(seed=0))
        return (cfg.resources(device=LIB_DEVICE) if LIB_DEVICE
                else cfg).build()

    def timed_iters(algo, n, gate=None):
        times = dict(sample=[], update=[], iteration=[])
        group, learners = algo.env_runner_group, algo.learner_group

        def wrap(name, fn):
            def call(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                times[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        group.sample = wrap("sample", group.sample)
        learners.update = wrap("update", learners.update)
        rets = []
        for _ in range(n):
            t0 = time.perf_counter()
            rets.append(algo.train()["episode_return_mean"])
            times["iteration"].append((time.perf_counter() - t0) * 1e3)
            if gate is not None and max(rets) > gate:
                break
        del group.sample, learners.update
        return rets, times

    algo = ppo(True)
    placement = dict(runners=algo.env_runner_group.device_info(),
                     learners=algo.learner_group.device_info())
    log(f"[libraries] (c) PPO runners {placement['runners']}, learners "
        f"{placement['learners']}")
    t0 = time.perf_counter()
    rets, times = timed_iters(algo, RL_GATE_ITERS, RL_GATE)
    wall = time.perf_counter() - t0
    algo.stop()
    local = ppo(False)
    _, ltimes = timed_iters(local, 3)
    local.stop()
    med = lambda v: statistics.median(v[1:]) if len(v) > 1 else v[0]
    res = dict(returns=rets, iterations=len(rets), wall_s=wall,
               placement=placement, times=times, local_times=ltimes,
               remote_ms={k: med(v) for k, v in times.items()},
               local_ms={k: med(v) for k, v in ltimes.items()})
    log(f"[libraries] (c) PPO CartPole-v1, 2 remote runners x 16 envs x "
        f"128, 2 learners (minibatch 256, 4 epochs, seed 0): returns "
        f"{[round(r, 1) for r in rets]} in {wall:.2f} s; an iteration "
        f"(median after the first) sample {res['remote_ms']['sample']:.2f}"
        f" ms, update {res['remote_ms']['update']:.2f} ms, iteration "
        f"{res['remote_ms']['iteration']:.2f} ms; 6d(a)'s local path here: "
        f"sample {res['local_ms']['sample']:.2f} ms, update "
        f"{res['local_ms']['update']:.2f} ms, iteration "
        f"{res['local_ms']['iteration']:.2f} ms")
    expect(max(rets) > RL_GATE, f"6g(c): PPO best {max(rets):.1f} within "
           f"{RL_GATE_ITERS} iterations, not > {RL_GATE}")
    want = "cpu" if LIB_DEVICE else "cuda"
    expect(all(p["device"].startswith(want)
               for p in placement["runners"] + placement["learners"]),
           f"6g(c): placement {placement}")
    cfg = (IMPALAConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=16,
                        rollout_fragment_length=64)
           .training(lr=2e-3, entropy_coeff=0.005).debugging(seed=0))
    imp = (cfg.resources(device=LIB_DEVICE) if LIB_DEVICE else cfg).build()
    t0 = time.perf_counter()
    ms = [imp.train() for _ in range(LIB_IMPALA_ITERS)]
    res["impala"] = dict(
        losses=[m["learner/total_loss"] for m in ms],
        returns=[m["episode_return_mean"] for m in ms],
        wall_s=time.perf_counter() - t0,
        inflight=len(imp.env_runner_group._inflight))
    imp.stop()
    log(f"[libraries] (c) IMPALA, 2 async remote runners x 16 envs x 64: "
        f"{LIB_IMPALA_ITERS} iterations {res['impala']['wall_s']:.2f} s, "
        f"total_loss {[round(x, 4) for x in res['impala']['losses']]}, "
        f"samples in flight {res['impala']['inflight']}")
    expect(all(math.isfinite(x) for x in res["impala"]["losses"]),
           "6g(c): IMPALA losses not finite")
    return res


def lib_tune(rt, storage):
    """6g(d): Tune over a GPU TorchTrainer, trials in turn."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    trainer = TorchTrainer(
        lib_drill_loop,
        train_loop_config=dict(LIB_DRILL, device=LIB_DEVICE,
                               steps=LIB_TUNE_STEPS),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=LIB_USE_GPU),
        run_config=RunConfig(name="6g-tune", storage_path=storage))
    t0 = time.perf_counter()
    grid = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(LIB_TUNE_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1)).fit()
    wall = time.perf_counter() - t0
    best = grid.get_best_result()
    res = dict(trials=[dict(lr=r.config["lr"], loss=r.metrics.get("loss"),
                            wall_s=r.metrics.get("time_total_s"))
                       for r in grid.results],
               errors=grid.errors, best_lr=best.config["lr"], wall_s=wall)
    log(f"[libraries] (d) Tune over TorchTrainer (1 GPU worker a trial, "
        f"max_concurrent_trials 1, {LIB_TUNE_STEPS} steps): "
        f"{res['trials']}; best lr {res['best_lr']}; errors {grid.errors}; "
        f"{wall:.1f} s")
    expect(len(grid) == 2 and not grid.errors, f"6g(d): {res}")
    expect(res["best_lr"] == max(LIB_TUNE_LRS), f"6g(d): best {res}")
    return res


def run_libraries(dev, train_ref):
    """Phase 6g: Train, RLlib's remote paths and Tune on the runtime 6f
    left up (started here if none runs), left up for 6h (shut down if 6g
    fails). `train_ref`: phase 6's numbers. Returns them and the
    TrainWorker's launch counts by kernel."""
    import ray_tpu_torch as rt
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[libraries] this process holds {held / 2**30:.3f} GiB on the "
        f"card before 6g")
    storage = tempfile.mkdtemp(prefix="chip_smoke_6g_")
    if not rt.is_initialized():
        rt.init()
    try:
        res = dict(main_held_bytes=held)
        t0 = time.perf_counter()
        res["train"], worker_counts = lib_train(rt, storage, train_ref)
        res["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["drill"] = lib_drill(rt, storage)
        res["drill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["rllib"] = lib_rllib(rt, dev)
        res["rllib_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["tune"] = lib_tune(rt, storage)
        res["tune_s"] = time.perf_counter() - t0
    except BaseException:
        rt.shutdown()
        raise
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    return res, worker_counts


# ------------------------------------------------ the Serve plane (6h)

SERVE_WARM = dict(prompt="Hello there.", max_tokens=2, temperature=0.0)
# (c)'s body, which (b) serves alone first: its first page shares no
# prefix with 5e's bodies
SERVE_PROBE = dict(prompt="Recovery probe. " + PROMPT_TEXTS[2],
                   max_tokens=SERVER_TOKENS, temperature=0.0)
SERVE_RECOVERY_S = 300.0  # kill to a served token, the longest waited


def card_holders():
    """Processes holding a CUDA context on the card: those with one of
    its device nodes (/dev/nvidia<N>, not nvidiactl or nvidia-uvm) open,
    read from /proc with each pid's CUDA_VISIBLE_DEVICES and cwd.
    (nvidia-smi's compute-apps query lists one process for the whole
    container when the card is reached from inside a container.)"""
    import re
    holders = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        pid = int(d)
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        nodes = set()
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                nodes.add(target)
        if not nodes:
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
            visible = env.get(b"CUDA_VISIBLE_DEVICES", b"").decode() or None
            cwd = os.readlink(f"/proc/{pid}/cwd")
        except OSError as e:
            visible, cwd = None, f"unreadable: {e!r}"
        holders[pid] = dict(nodes=sorted(nodes), visible=visible, cwd=cwd)
    return holders


def replica_on_card(label, before):
    """The one process besides this one that holds the card: the GPU
    replica, pinned with CUDA_VISIBLE_DEVICES, its cwd outside the
    checkout."""
    holders = card_holders()
    others = {p: h for p, h in holders.items() if p not in before}
    log(f"[serve {label}] processes on the card (device nodes open): "
        f"{holders}; this process {os.getpid()}")
    expect(os.getpid() in holders, f"this process (pid {os.getpid()}) is "
           f"not among the card's holders {holders}")
    expect(len(others) == 1, f"{label}: expected the replica alone beside "
           f"the processes already on the card, found {others}")
    (pid, h), = others.items()
    here = os.path.dirname(os.path.abspath(__file__))
    expect(not h["cwd"].startswith(here), f"{label}: replica pid {pid}'s "
           f"cwd {h['cwd']!r} lies inside the checkout {here}")
    return pid


def replica_pin(stats, label):
    """The replica's engine on CUDA in a worker pinned to card 0."""
    log(f"[serve {label}] replica engine on {stats['device']}, "
        f"CUDA_VISIBLE_DEVICES={stats['visible_devices']}")
    expect(stats["device"].startswith("cuda")
           and stats["visible_devices"] == "0",
           f"{label}: replica engine on {stats['device']}, pin "
           f"{stats['visible_devices']!r}")


def wait_released(pid, label, timeout=120.0):
    """Wait until `pid` no longer holds the card; returns the seconds."""
    t0 = time.perf_counter()
    while pid in card_holders():
        expect(time.perf_counter() - t0 < timeout,
               f"{label}: pid {pid} still holds the card after {timeout} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def http_call(port, method, path, body=None, timeout=600):
    """One HTTP/1.1 exchange with the serve proxy: (status, content type,
    body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=(
            {"Content-Type": "application/json"} if data else {}))
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def proxy_routes_to(port, app, ingress, timeout=30.0):
    """Wait until the proxy's route table (polled from the controller
    once a second) sends "/" to `app`'s ingress."""
    t0 = time.perf_counter()
    while http_json(port, "GET", "/-/routes").get("/") != f"{app}#{ingress}":
        expect(time.perf_counter() - t0 < timeout,
               f"the proxy does not route / to {app} after {timeout} s")
        time.sleep(0.1)


def http_json(port, method, path, body=None, status=200):
    got, ctype, data = http_call(port, method, path, body)
    expect(got == status, f"{method} {path}: HTTP {got} (want {status}): "
           f"{data[:300]!r}")
    return json.loads(data) if ctype.startswith("application/json") \
        else data.decode()


def http_sse(port, path, body, timeout=600):
    """A streamed POST: the SSE events' payloads with their arrival
    times, the last one "[DONE]"."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            raise AssertionError(f"POST {path} (stream): HTTP {r.status}: "
                                 f"{r.read()[:300]!r}")
        ctype = r.getheader("Content-Type") or ""
        expect(ctype.startswith("text/event-stream"), f"SSE {ctype!r}")
        events = []
        for line in iter(r.readline, b""):
            if line.startswith(b"data: "):
                events.append((time.perf_counter(), line[6:].strip().decode()))
    finally:
        conn.close()
    expect(events and events[-1][1] == "[DONE]",
           f"POST {path}: the stream did not end in [DONE]: {events[-2:]}")
    docs = [(t, json.loads(e)) for t, e in events[:-1]]
    for _, d in docs:
        expect("error" not in d, f"POST {path}: SSE error event {d}")
    return t0, docs


def serve_routes(bodies):
    """(path, body) of 5e's bodies in its order: 8 completions, 2 chats,
    2 streams (completions)."""
    comp, chat, stream = bodies
    return ([("/v1/completions", b) for b in comp]
            + [("/v1/chat/completions", b) for b in chat]
            + [("/v1/completions", b) for b in stream])


def cold_pass(port, routes, stream_all):
    """The 12 bodies once on a fresh replica, each prompt behind "~ " (a
    first page no measured body shares, so no prefix-cache hit later):
    the new process's first use of its shapes, and more ticks than the
    anomaly detector's 64-tick warm-up, so the profiles it arms for the
    cold ticks it flags (in a fresh process the first one imports
    torch.profiler's dependencies on the step thread) fall here, not in
    the measured pass. Returns its wall s and tokens/s."""
    def shifted(body):
        if "prompt" in body:
            return dict(body, prompt="~ " + body["prompt"])
        msgs = [dict(m) for m in body["messages"]]
        msgs[0]["content"] = "~ " + msgs[0]["content"]
        return dict(body, messages=msgs)
    out, wall = http_at_once(port, [(p, shifted(b)) for p, b in routes],
                             stream_all)
    n = sum(r["doc"]["usage"]["completion_tokens"] if r["kind"] == "unary"
            else len(sse_parts(r["docs"])[1]) for r in out)
    return dict(wall_s=wall, output_tokens=n, tokens_per_s=n / wall)


def sse_parts(docs):
    """Text, token ids (fleet chunks carry them), finish reason."""
    text, toks, reason = "", [], None
    for _, d in docs:
        c = d["choices"][0]
        text += c.get("text") or (c.get("delta") or {}).get("content") or ""
        toks += c.get("token_ids") or []
        reason = c.get("finish_reason") or reason
    return text, toks, reason


def stream_text_agrees(streamed, final):
    """SSE deltas are suffixes of whole-prefix decodes: a multi-byte
    character still incomplete when its chunk went out was sent as one
    U+FFFD, so the concatenation has the final text's length and agrees
    with it everywhere else."""
    return len(streamed) == len(final) and all(
        a == b or a == "�" for a, b in zip(streamed, final))


class MetricsProbe:
    """While the replica serves, call its `metrics` (the controller's
    health probe, health_check_timeout_s 10 s) every 0.5 s from a thread;
    every call must answer inside the timeout."""

    def __init__(self, rt, replica):
        self.rt, self.replica = rt, replica
        self.ms, self.stop = [], threading.Event()

    def _run(self):
        while not self.stop.is_set():
            t0 = time.perf_counter()
            self.rt.get(self.replica.metrics.remote(), timeout=10)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.stop.wait(0.5)

    def __enter__(self):
        from concurrent.futures import ThreadPoolExecutor
        self._ex = ThreadPoolExecutor(1)
        self._fut = self._ex.submit(self._run)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self._fut.result()          # a probe that timed out raises here
        self._ex.shutdown()
        return False

    def summary(self):
        expect(self.ms, "no metrics call completed while the replica served")
        return dict(n=len(self.ms), p50=pctl(self.ms, 0.5), max=max(self.ms))


def http_at_once(port, routes, stream_all):
    """All bodies at once over HTTP, one connection each. Streams go as
    SSE (every body when `stream_all`, else 5e's two streams)."""
    from concurrent.futures import ThreadPoolExecutor
    n_stream = len(routes) if stream_all else 2

    def one(i):
        path, body = routes[i]
        body = dict(body, model="8b")
        if i >= len(routes) - n_stream:
            t0, docs = http_sse(port, path, dict(body, stream=True))
            return dict(kind="stream", t0=t0, docs=docs,
                        times=[t for t, _ in docs], t1=docs[-1][0])
        t0 = time.perf_counter()
        doc = http_json(port, "POST", path, body)
        return dict(kind="unary", t0=t0, doc=doc, t1=time.perf_counter())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(routes)) as ex:
        res = list(ex.map(one, range(len(routes))))
    return res, time.perf_counter() - t0


def http_times(res, per_token):
    """HTTP-side ms: e2e of every response and, where the SSE chunks
    come one a token (`per_token`: the fleet's token chunks), TTFT and
    TPOT of the streams (first data chunk; chunks after it). The OpenAI
    app's text chunks carry only the text a token adds, and the byte
    tokenizer maps most of the 8b vocabulary to none."""
    e2e = [(r["t1"] - r["t0"]) * 1e3 for r in res]
    ttft, tpot = [], []
    for r in res:
        if r["kind"] == "stream" and per_token:
            ttft.append((r["times"][0] - r["t0"]) * 1e3)
            if len(r["times"]) > 1:
                tpot.append((r["times"][-1] - r["times"][0]) * 1e3
                            / (len(r["times"]) - 1))
    return {k: dict(p50=pctl(v, 0.5), p99=pctl(v, 0.99), n=len(v))
            for k, v in (("e2e", e2e), ("ttft", ttft), ("tpot", tpot))}


def engine_times(trace, exclude):
    lc = {k: v for k, v in lifecycles(trace).items() if k not in exclude}
    return {k: dict(p50=pctl([x[k] for x in lc.values()], 0.5),
                    p99=pctl([x[k] for x in lc.values()], 0.99))
            for k in ("ttft", "tpot", "e2e")}, lc


def in_step_s(st0, st1):
    """Seconds the replica spent inside step() between two /stats reads
    (its tick_times window holds up to 512 ticks: the two windows'
    sums, while the replica has ticked fewer)."""
    a, b = st0["tick_times"], st1["tick_times"]
    expect(st1["ticks"] <= 512, f"{st1['ticks']} ticks: past the window")
    return (b["wall_ms_avg"] * b["window"]
            - a["wall_ms_avg"] * a["window"]) / 1e3


def replica_launches(stats, label):
    """The replica's own launch counters against its ticks: #1 layers x
    mixed ticks, #2/#3 layers x decode ticks, every decode launch on
    the pipelined route."""
    from ray_tpu_torch.models import llama
    L = llama.config(SERVER_MODEL).n_layers
    want = {"ragged_paged": L * stats["ragged_ticks"],
            "paged_decode": L * stats["decode_ticks"]}
    got = {k: n for k, n in stats["kernel_launches"].items() if n}
    log(f"[serve {label}] replica: {stats['ragged_ticks']} mixed and "
        f"{stats['decode_ticks']} decode ticks, launches {got}, routes "
        f"{stats['kernel_routes']}, device {stats['device']}, graph "
        f"captures {stats['graph_captures']}")
    expect(got == want and min(want.values()) > 0,
           f"{label}: replica launches {got}, expected {want}")
    expect(stats["kernel_routes"].get("paged_decode") ==
           {"pipelined": want["paged_decode"]},
           f"{label}: decode routes {stats['kernel_routes']}")
    return got


def serve_teacher(engine_kw, cases):
    """6h's near-tie oracle in a num_gpus=1 task: the seed's weights
    rebuilt on the gather impl; for each (tokens, a, b) the next-token
    logits of a and b after `tokens`."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    eng = InferenceEngine(EngineConfig(model=SERVER_MODEL,
                                       decode_impl="gather", **engine_kw))
    out = []
    for tokens, a, b in cases:
        lg = teacher_logits(eng, tokens).float()
        out.append((lg[a].item(), lg[b].item()))
    return out


def first_split(a, b):
    return next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                None if len(a) == len(b) else min(len(a), len(b)))


def serve_openai(rt, serve, cfg, routes, ref, tok, before):
    """6h (a): build_openai_app behind the HTTP proxy, the 12 bodies at
    once. Returns the numbers, the replica's launches and the texts."""
    from ray_tpu_torch.llm import build_openai_app
    res = {}
    t0 = time.perf_counter()
    serve.run(build_openai_app({"llm_configs": [cfg]}), name="openai",
              route_prefix="/", http_options=serve.HTTPOptions(port=0),
              timeout_s=600)
    res["to_running_s"] = time.perf_counter() - t0
    port = rt.get(rt.get_actor("SERVE_PROXY").ready.remote(), timeout=60)
    proxy_routes_to(port, "openai", "LLMRouter")
    pid = replica_on_card("openai", before)
    stats = http_json(port, "GET", "/stats")["models"]["8b"]
    log(f"[serve openai] serve.run to RUNNING {res['to_running_s']:.2f} s; "
        f"proxy on port {port}; replica pid {pid}")
    replica_pin(stats, "openai")
    models = http_json(port, "GET", "/v1/models")
    expect([m["id"] for m in models["data"]] == ["8b"], f"/v1/models {models}")
    t0 = time.perf_counter()
    _, warm = http_sse(port, "/v1/completions", dict(SERVE_WARM, stream=True))
    res["first_request_to_first_token_ms"] = (warm[0][0] - t0) * 1e3
    res["cold"] = cold_pass(port, routes, stream_all=False)
    warm_ids = set(lifecycles(http_json(port, "GET", "/debug/trace")))
    st0 = http_json(port, "GET", "/stats")["models"]["8b"]
    controller = rt.get_actor("SERVE_CONTROLLER")
    (_, replica, _), = rt.get(controller.get_deployment_targets.remote(
        "openai#LLMServer:8b"), timeout=30)["replicas"]
    with MetricsProbe(rt, replica) as probe:
        out, wall = http_at_once(port, routes, stream_all=False)
    res["metrics_probe_ms"] = probe.summary()
    texts = []
    for i, (r, want) in enumerate(zip(out, ref)):
        if r["kind"] == "unary":
            d = r["doc"]
            c = d["choices"][0]
            chat = d["object"] == "chat.completion"
            expect(d["object"] in ("text_completion", "chat.completion")
                   and (not chat or c["message"]["role"] == "assistant"),
                   f"body {i}: response shape {d}")
            text = c["message"]["content"] if chat else c["text"]
            expect(d["usage"]["completion_tokens"] == len(want),
                   f"body {i}: completion_tokens "
                   f"{d['usage']['completion_tokens']}, 5e {len(want)}")
            texts.append(("unary", text))
        else:
            text, _, reason = sse_parts(r["docs"])
            expect(reason is not None and all(
                d["object"] == "text_completion" for _, d in r["docs"]),
                f"body {i}: SSE chunks {r['docs'][-1]}")
            texts.append(("stream", text))
    n_out = sum(len(w) for w in ref)
    status, ctype, data = http_call(port, "POST", "/v1/completions",
                                    dict(model="nope", prompt="x"))
    expect(status == 404, f"unknown model: HTTP {status} {data[:200]!r}")
    status, ctype, metrics = http_call(port, "GET", "/metrics")
    expect(status == 200 and ctype.startswith("text/plain"),
           f"/metrics HTTP {status} {ctype}")
    n_samples = check_exposition(metrics.decode())
    stats = http_json(port, "GET", "/stats")["models"]["8b"]
    launches = replica_launches(stats, "openai")
    res["in_step_s"] = in_step_s(st0, stats)
    eng_t, lc = engine_times(http_json(port, "GET", "/debug/trace"),
                             warm_ids)
    expect(len(lc) == len(ref), f"{len(lc)} lifecycles for {len(ref)} bodies")
    res.update(wall_s=wall, output_tokens=n_out, tokens_per_s=n_out / wall,
               http=http_times(out, False), engine=eng_t, samples=n_samples,
               mixed_ticks=stats["ragged_ticks"],
               decode_ticks=stats["decode_ticks"], replica_pid=pid)
    log(f"[serve openai] first request to first token "
        f"{res['first_request_to_first_token_ms']:.1f} ms; the cold pass "
        f"(12 shifted bodies on the fresh replica) "
        f"{res['cold']['tokens_per_s']:.1f} tokens/s in "
        f"{res['cold']['wall_s']:.2f} s; 12 bodies over "
        f"HTTP: {n_out} output tokens in {wall:.2f} s, "
        f"{n_out / wall:.1f} tokens/s; lifecycles ms p50 / p99: "
        + "; ".join(f"{k} {v['p50']:.2f} / {v['p99']:.2f}"
                    for k, v in eng_t.items())
        + f"; {res['in_step_s']:.2f} s of the pass inside the replica's "
        f"step()"
        + f"; the replica's metrics (the controller's health probe) "
        f"answered {res['metrics_probe_ms']['n']} calls while it served, "
        f"p50 {res['metrics_probe_ms']['p50']:.1f} ms, max "
        f"{res['metrics_probe_ms']['max']:.1f} ms"
        + f"; over HTTP e2e {res['http']['e2e']['p50']:.2f} / "
        f"{res['http']['e2e']['p99']:.2f}; unknown model 404; /metrics "
        f"{n_samples} samples")
    t0 = time.perf_counter()
    serve.delete("openai")
    res["released_s"] = wait_released(pid, "openai") + (
        time.perf_counter() - t0)
    log(f"[serve openai] deleted; card released {res['released_s']:.2f} s "
        f"after the delete")
    return res, launches, texts


def serve_fleet(rt, serve, cfg, routes, ref, before):
    """6h (b): build_llm_fleet_app on one replica behind HTTP, every body
    as an SSE stream with token ids, then unary calls. Returns the
    numbers, the replica's launches and each body's tokens."""
    from ray_tpu_torch.serve.llm import FleetConfig, build_llm_fleet_app
    res = {}
    t0 = time.perf_counter()
    serve.run(build_llm_fleet_app(FleetConfig(
        llm_config=cfg, min_replicas=1, max_replicas=1)), name="fleet",
        route_prefix="/", timeout_s=600)
    res["to_running_s"] = time.perf_counter() - t0
    port = rt.get(rt.get_actor("SERVE_PROXY").ready.remote(), timeout=60)
    proxy_routes_to(port, "fleet", "LLMFleet:8b")
    pid = replica_on_card("fleet", before)
    _, warm = http_sse(port, "/v1/completions", dict(SERVE_WARM, stream=True))
    res["cold"] = cold_pass(port, routes, stream_all=True)
    st0 = http_json(port, "GET", "/stats")["replicas"]["r0"]
    out, wall = http_at_once(port, routes, stream_all=True)
    res["in_step_s"] = in_step_s(
        st0, http_json(port, "GET", "/stats")["replicas"]["r0"])
    toks = []
    for i, r in enumerate(out):
        _, ids, reason = sse_parts(r["docs"])
        expect(reason is not None and len(ids) == len(ref[i]),
               f"fleet body {i}: {len(ids)} tokens (5e {len(ref[i])}), "
               f"finish {reason}")
        toks.append(ids)
    unary = []
    for path, body in (routes[0], routes[8]):
        unary.append(http_json(port, "POST", path, dict(body, model="8b")))
    fleet = http_json(port, "GET", "/fleet")
    rows = {rid: (r["status"], r.get("chips"))
            for rid, r in fleet["replicas"].items()}
    expect(rows == {"r0": ("ACTIVE", 1)}, f"/fleet rows {rows}")
    events = http_json(port, "GET", "/fleet/debug/events")
    expect(events["object"] == "events" and events["events"],
           "/fleet/debug/events is empty")
    status, ctype, metrics = http_call(port, "GET", "/metrics")
    expect(status == 200, f"fleet /metrics HTTP {status}")
    text = metrics.decode()
    n_samples = check_exposition(text)
    missing = [f for f in FLEET_FAMILIES if text.count(f"# TYPE {f} ") != 1]
    expect(not missing, f"fleet /metrics: families {missing} not declared "
           f"exactly once")
    stats = http_json(port, "GET", "/stats")["replicas"]["r0"]
    replica_pin(stats, "fleet")
    launches = replica_launches(stats, "fleet")
    # the body (c) sends again, alone: no page of it in the cache
    _, docs = http_sse(port, "/v1/completions", dict(SERVE_PROBE, stream=True))
    probe = sse_parts(docs)[1]
    res.update(wall_s=wall, http=http_times(out, True), replica_pid=pid,
               unary=[u["usage"]["completion_tokens"] for u in unary],
               samples=n_samples,
               mixed_ticks=stats["ragged_ticks"],
               decode_ticks=stats["decode_ticks"],
               output_tokens=sum(len(t) for t in toks),
               fleet_events=len(events["events"]))
    res["tokens_per_s"] = res["output_tokens"] / wall
    log(f"[serve fleet] serve.run to RUNNING {res['to_running_s']:.2f} s; "
        f"cold pass {res['cold']['tokens_per_s']:.1f} tokens/s; 12 "
        f"SSE streams: {res['output_tokens']} tokens in {wall:.2f} s "
        f"({res['in_step_s']:.2f} s inside step()), "
        f"{res['tokens_per_s']:.1f} tokens/s; over HTTP ms p50 / p99: "
        + "; ".join(f"{k} {v['p50']:.2f} / {v['p99']:.2f} (n {v['n']})"
                    for k, v in res["http"].items())
        + f"; /fleet rows {rows}; {len(events['events'])} fleet events; "
        f"/metrics {n_samples} samples, the fleet families once each")
    return res, launches, toks, unary, port, pid, probe


def serve_recovery(rt, serve, port, pid, probe, before):
    """6h (c): kill the LLMServer replica's actor under the fleet app;
    the controller starts a new one, which pins the released card and
    serves the first body again."""
    controller = rt.get_actor("SERVE_CONTROLLER")
    key = "fleet#LLMServer:8b:r0"
    wire = rt.get(controller.get_deployment_targets.remote(key), timeout=30)
    (old_id, victim, _), = wire["replicas"]
    t0 = time.perf_counter()
    rt.kill(victim)
    released = wait_released(pid, "killed replica")
    new_id = None
    while new_id is None:
        expect(time.perf_counter() - t0 < SERVE_RECOVERY_S,
               f"no new replica RUNNING {SERVE_RECOVERY_S} s after the kill")
        states = serve.status()["applications"]["fleet"]["deployments"][
            "LLMServer:8b:r0"]["replica_states"]
        new_id = next((r for r, s in states.items()
                       if r != old_id and s == "RUNNING"), None)
        time.sleep(0.2)
    running_s = time.perf_counter() - t0
    attempts = []
    while True:
        try:
            _, docs = http_sse(port, "/v1/completions",
                               dict(SERVE_PROBE, stream=True))
            break
        except AssertionError as e:
            # the fleet's router learns of the new replica within its
            # refresh period: a request routed to the dead one fails
            attempts.append(repr(e)[:200])
            expect(time.perf_counter() - t0 < SERVE_RECOVERY_S,
                   f"no token {SERVE_RECOVERY_S} s after the kill: "
                   f"{attempts[-3:]}")
            time.sleep(0.5)
    next_token_s = docs[0][0] - t0
    _, toks, _ = sse_parts(docs)
    log(f"[serve recovery] killed {old_id}: card released {released:.2f} s "
        f"after the kill, {new_id} RUNNING after {running_s:.2f} s, next "
        f"token {next_token_s:.2f} s after the kill ({len(attempts)} "
        f"requests failed before it: {attempts[:2]}); tokens equal (b)'s: "
        f"{toks == probe}")
    expect(toks == probe and toks, "the recovered "
           "replica's tokens differ from (b)'s for the same lone body")
    new_pid = replica_on_card("recovered", before)
    stats = http_json(port, "GET", "/stats")["replicas"]["r0"]
    replica_pin(stats, "recovered")
    launches = replica_launches(stats, "recovered")
    return dict(card_released_s=released, running_s=running_s,
                next_token_s=next_token_s, failed_requests=len(attempts),
                new_pid=new_pid), launches


def rtpu_segments():
    return {f for f in os.listdir("/dev/shm") if f.startswith("rtpu_")}


def run_serve_plane(server5, shm_before):
    """Phase 6h: the Serve plane on 6f's runtime (started here if none
    runs), shut down at the end. `server5`: phase 5e's numbers, with
    each body's tokens; `shm_before`: the rtpu_* segments before the
    runtime started. Returns the numbers and the replicas' launch counts
    by part."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import ByteTokenizer, serve
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.ops import _kernels
    before_counts = _kernels.launch_counts()
    if not rt.is_initialized():
        rt.init()
    try:
        types = [k for k in rt.cluster_resources() if k.startswith("GPU-")]
        expect(len(types) == 1, f"GPU types {types}")
        cfg = LLMConfig(
            model_id="8b", model_source=SERVER_MODEL, engine_kwargs=SERVER_KW,
            accelerator_type=types[0], deployment_config=dict(
                ray_actor_options=dict(runtime_env=dict(
                    working_dir=tempfile.gettempdir()))))
        tok = ByteTokenizer(128256)
        routes = serve_routes(server_bodies())
        ref = server5["body_tokens"]
        before = set(card_holders())
        res = dict(accelerator_type=types[0], on_card_before=sorted(before))
        res["openai"], l_openai, texts = serve_openai(
            rt, serve, cfg, routes, ref, tok, before)
        res["fleet"], l_fleet, ftoks, unary, port, pid, probe = serve_fleet(
            rt, serve, cfg, routes, ref, before)
        res["recovery"], l_rec = serve_recovery(rt, serve, port, pid, probe,
                                                before)
        serve.delete("fleet")
        wait_released(res["recovery"]["new_pid"], "fleet")
        serve.shutdown()
        # judge: (b)'s tokens against 5e's, first divergences by the
        # near-tie rule on a gather engine of the seed's weights; (a)'s
        # texts against 5e's tokens, else (b)'s
        cases, prompts = [], [tok.encode(b["prompt"]) if "prompt" in b else
                              tok.encode(tok.apply_chat_template(
                                  b["messages"])) for _, b in routes]
        for i, (a, b) in enumerate(zip(ftoks, ref)):
            j = first_split(a, b)
            if j is not None:
                expect(len(a) == len(b) and j < len(a), f"body {i}: fleet "
                       f"stream of {len(a)} tokens, 5e {len(b)}")
                cases.append((i, j, (prompts[i] + a[:j], a[j], b[j])))
        gaps = []
        if cases:
            lg = rt.get(rt.remote(num_gpus=1)(serve_teacher).remote(
                SERVER_KW, [c for _, _, c in cases]), timeout=600)
            for (i, j, c), (la, lb) in zip(cases, lg):
                gaps.append(abs(la - lb))
                log(f"[serve] fleet body {i} diverges from 5e at output {j}: "
                    f"{c[1]} against {c[2]}, gap {gaps[-1]:.4f} (margin "
                    f"{NEAR_TIE})")
                expect(gaps[-1] <= NEAR_TIE, f"fleet body {i}: beyond a "
                       f"near tie")
        for i, (kind, text) in enumerate(texts):
            finals = {tok.decode(ref[i]), tok.decode(ftoks[i])}
            ok = any((text == f) if kind == "unary"
                     else stream_text_agrees(text, f) for f in finals)
            expect(ok, f"openai body {i} ({kind}): text agrees with neither "
                   f"5e's tokens nor (b)'s")
        for u, i in zip(unary, (0, 8)):
            c = u["choices"][0]
            got = c["text"] if "text" in c else c["message"]["content"]
            expect(got == tok.decode(ftoks[i]) and u["usage"][
                "completion_tokens"] == len(ftoks[i]),
                f"fleet unary body {i} disagrees with its stream")
        res.update(exact_fleet=not cases, near_tie_gaps=gaps,
                   server5=dict(times=server5["times"],
                                tokens_per_s=server5["tokens_per_s"]))
        log(f"[serve] fleet streams equal 5e's: {not cases} ({len(cases)} "
            f"near ties); openai texts agree; 5e's lifecycles ms p50 / p99: "
            + "; ".join(f"{k} {v['p50']:.2f} / {v['p99']:.2f}"
                        for k, v in server5["times"].items())
            + f", {server5['tokens_per_s']:.1f} tokens/s")
    finally:
        rt.shutdown()
    left = sorted(rtpu_segments() - shm_before)
    expect(not left, f"rtpu_* segments left behind: {left}")
    expect(_kernels.launch_counts() == before_counts,
           "this process's launch counters moved in 6h")
    return res, dict(openai=l_openai, fleet=l_fleet, recovered=l_rec)


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


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{path}/{k}")
    else:
        yield path, tree


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
    build_s = time.perf_counter() - t0
    log(f"[build] {info['compiled']} in {build_s:.1f} s into {info['dir']}")
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
    phase_s = {"1-2": build_s, "3-4": time.perf_counter() - t_kernels}
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
            run_quant_engine(dev, kind, params)
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
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = run_fleet(dev, params)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5h"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sanitizer = run_sanitizer(dev, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5i"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = run_server()
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["5e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_counts, train = run_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_moe = run_train_moe(dev)
    phase_s["6b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint = run_checkpoint(dev)
    phase_s["6c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rllib = run_rllib(dev)
    phase_s["6d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rllib_more = run_rllib_more(dev)
    phase_s["6e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shm_before = rtpu_segments()
    runtime, actor_launches = run_runtime(dev, out_bf16,
                                          engine["ticks_ms_kernel"])
    phase_s["6f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    libraries, worker_launches = run_libraries(dev, train)
    phase_s["6g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_plane, serve_launches = run_serve_plane(server, shm_before)
    phase_s["6h"] = time.perf_counter() - t0
    log(f"[phases] seconds: {({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"[profiler] {PROFILES['windows']} profile windows, "
        f"{PROFILES['lost']} of them lost records and were taken again; "
        f"short profiles kept {PROFILES['short_kept']}; timed with CUDA "
        f"events instead {PROFILES['event_timed']}")
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
    # phase 5h's main paths (the fleet drives over both replicas) launches
    for k in kernels:
        base = k["name"].replace("_narrow_table", "")
        if base in FLEET_LAUNCHES:
            k["launches_fleet"] = FLEET_LAUNCHES[base]
    # phase 5i's main path (the armed engine's guarded window) launches
    for k in kernels:
        if k["name"] in ("paged_decode", "paged_decode_narrow_table"):
            k["launches_sanitizer"] = sanitizer["armed"]["paged_decode"]
    # phase 6b's main path (MoE training) launches
    for k in kernels:
        if k["name"] in MOE_LAUNCHES:
            k["launches_moe"] = MOE_LAUNCHES[k["name"]]
    # phase 6f's main path (the engine in the GPU actor) launches, counted
    # in the actor's process
    for k in kernels:
        k["launches_actor"] = actor_launches.get(
            k["name"].replace("_narrow_table", ""), 0)
    # phase 6g's main path (phase 6's training in a GPU TrainWorker)
    # launches, counted in the worker's process
    for k in kernels:
        k["launches_train_worker"] = worker_launches.get(
            k["name"].replace("_narrow_table", ""), 0)
    # phase 6h's main paths (the 8b engine in the serve replica of the
    # OpenAI app, of the fleet app, and of the fleet app's replacement
    # replica) launches, counted in each replica's process
    for k in kernels:
        base = k["name"].replace("_narrow_table", "")
        k["launches_serve"] = {part: n.get(base, 0)
                               for part, n in serve_launches.items()}
    summary = {"kernels": kernels,
               "phase_seconds": {k: round(v, 1) for k, v in phase_s.items()}}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(summary, card=card, ragged_ticks=ticks,
                           engine=engine,
                           quant_engine=quant_engine, train=train,
                           train_moe=train_moe, checkpoint=checkpoint,
                           rllib=rllib, rllib_more=rllib_more,
                           runtime=runtime, libraries=libraries,
                           serve_plane=serve_plane,
                           sanitizer=sanitizer,
                           tick_mechanics=tick_mechanics,
                           kv_hierarchy=kv_hierarchy, server=server,
                           lora=lora, spec=spec, fleet=fleet,
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
