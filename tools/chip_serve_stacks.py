"""Where a fresh serve replica's time goes: the OpenAI app over phase
5e's configuration (chip_smoke.py's SERVER_KW, the `8b` preset) in a
num_gpus=1 replica, 5e's 12 bodies sent at once over HTTP twice, the
replica's thread stacks sampled while they run.

    python3 tools/chip_serve_stacks.py [--out FILE] [--every S]

For each pass: its wall, the replica's ticks and the seconds inside
step() (from /stats), and the share of the samples in which the step
thread (the executor thread running InferenceEngine.step) was inside
an import, a profiler trace merge, or the step's device work. The
second pass repeats the first's prompts, so it hits the prefix cache.
Writes every sample to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_thread_state(sample: str) -> str:
    """What the thread running InferenceEngine.step was doing in one
    stack sample of the replica's process."""
    for thread in sample.split("--- thread ")[1:]:
        if "engine.py" not in thread or ", in step" not in thread:
            continue
        if "importlib" in thread:
            return "import"
        if "merge_traces" in thread or "profiler" in thread:
            return "profiler"
        return "step"
    return "no step running"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the samples here")
    ap.add_argument("--every", type=float, default=0.2,
                    help="seconds between stack samples")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_serve_stacks: no CUDA device available")
    sys.path.insert(0, HERE)
    smoke = runpy.run_path(os.path.join(HERE, "chip_smoke.py"),
                           run_name="chip_serve_stacks")
    G = smoke["run_serve_plane"].__globals__
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    from ray_tpu_torch.ops import _kernels
    _kernels.build()
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, build_openai_app
    rt.init()
    try:
        gpu = next(k for k in rt.cluster_resources() if k.startswith("GPU-"))
        serve.run(build_openai_app({"llm_configs": [LLMConfig(
            model_id="8b", model_source=G["SERVER_MODEL"],
            engine_kwargs=G["SERVER_KW"], accelerator_type=gpu)]}),
            name="stacks", route_prefix="/",
            http_options=serve.HTTPOptions(port=0), timeout_s=600)
        port = rt.get(rt.get_actor("SERVE_PROXY").ready.remote(), timeout=60)
        routes = G["serve_routes"](G["server_bodies"]())
        G["http_sse"](port, "/v1/completions",
                      dict(G["SERVE_WARM"], stream=True))
        runtime = rt.current_runtime()
        pid = next(p for p in G["card_holders"]() if p != os.getpid())
        worker = next(w for w in runtime.head_daemon.workers.values()
                      if w.pid == pid)
        samples = []
        for n in range(2):
            st0 = G["http_json"](port, "GET", "/stats")["models"]["8b"]
            stop = threading.Event()
            got = []

            def sample():
                while not stop.wait(args.every):
                    got.append(runtime.client.daemon_rpc(worker.addr,
                                                         "dump_stacks"))
            th = threading.Thread(target=sample)
            th.start()
            try:
                _, wall = G["http_at_once"](port, routes, stream_all=False)
            finally:
                stop.set()
                th.join()
            st1 = G["http_json"](port, "GET", "/stats")["models"]["8b"]
            states = collections.Counter(step_thread_state(s) for s in got)
            print(json.dumps(dict(
                pass_index=n, wall_s=wall, ticks=st1["ticks"] - st0["ticks"],
                in_step_s=G["in_step_s"](st0, st1), samples=len(got),
                step_thread=dict(states))), flush=True)
            samples += got
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n######## sample\n".join(samples))
    finally:
        serve.shutdown()
        rt.shutdown()


if __name__ == "__main__":
    main()
