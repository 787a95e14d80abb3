"""Time chip_smoke.py's int8 and fp8 drives at the full 32 layers of the
`8b` preset against QUANT_LAYERS, in one process on one card.

    python3 tools/chip_depth_ab.py [--out FILE]

Builds the kernels, runs phase 5 for the bf16 weights, then each phase
whose int8/fp8 drives QUANT_LAYERS cuts, once at each depth, the legs
in alternating order: 5b with 5c on its graph sides (32, then the cut),
5d (the cut, then 32), 5f (32, then the cut). Every leg runs the phase
as chip_smoke.py does, checks included. Prints the card and one JSON
line of seconds by phase and depth. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import runpy
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_depth_ab: no CUDA device available")
    sys.path.insert(0, HERE)
    smoke = runpy.run_path(os.path.join(HERE, "chip_smoke.py"),
                           run_name="chip_depth_ab")
    G = smoke["run_engine"].__globals__   # the functions' own globals
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    from ray_tpu_torch.ops import _kernels
    _kernels.build()
    dev = torch.device("cuda:0")
    _, _, params, _, graph_f32 = G["run_engine"](dev)
    cut = G["QUANT_LAYERS"]

    def quant_and_ticks():
        sides = dict(f32=graph_f32)
        t0 = time.perf_counter()
        for kind in ("int8", "fp8"):
            sides[kind] = G["run_quant_engine"](dev, kind, params)[2]
            gc.collect()
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        G["run_tick_mechanics"](dev, params, sides)
        return {"5b": t1 - t0, "5c": time.perf_counter() - t1}

    def timed(phase, fn):
        def run():
            t0 = time.perf_counter()
            fn()
            return {phase: time.perf_counter() - t0}
        return run

    legs = [(quant_and_ticks, (32, cut)),
            (timed("5d", lambda: G["run_kv_hierarchy"](params)), (cut, 32)),
            (timed("5f", lambda: G["run_lora"](dev, params)), (32, cut))]
    res = {}
    for fn, depths in legs:
        for layers in depths:
            G["QUANT_LAYERS"] = layers
            for phase, s in fn().items():
                res.setdefault(phase, {})[layers] = s
                print(f"[depth] {phase} int8/fp8 at {layers} layers: "
                      f"{s:.2f} s", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    G["QUANT_LAYERS"] = cut
    out = dict(card=card, cut=cut, seconds=res, saved={
        p: v[32] - v[cut] for p, v in res.items()})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
