"""Host costs of the port's actor runtime on this machine, each round in
a fresh interpreter:

- tasks/s of 2 000 empty tasks, and the round trip of 1 000 empty actor
  calls (p50, p99 us);
- `put` and `get` of a large object, three times each: a numpy uint8
  array (the path the port keeps unchanged: zero-copy out-of-band
  buffers, a read-only view on `get`) and a bfloat16 tensor (the port's
  tensor path: raw bytes on `put`, a copy on `get`);
- the same objects through the object store's own stages, timed one by
  one (`serialize`, `write_to_shm`, `read_from_shm`, and inside the
  last the tensor's `_rebuild_tensor`);
- the rates one thread fills fresh pages (numpy's, torch's and
  `/dev/shm`'s), reads a new mapping of filled `/dev/shm` pages, and
  fills and copies warm pages: what bounds a put into a new segment and
  a get into a new tensor;
- with a card, a 256 MiB CUDA tensor returned from a `num_gpus=1` task,
  beside the task's own copy to the host and a 256 MiB CPU tensor
  returned from a CPU task.

    PYTHONPATH=. python tools/runtime_host_costs.py [--rounds N]
        [--gib G] [--out FILE]

Prints one JSON line per round (and appends it to FILE).
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
import ray_tpu_torch as rt
from ray_tpu_torch._private import worker
from ray_tpu_torch._private.object_store import (
    attach_arena, attach_shm, create_untracked_shm, read_from_shm,
    write_to_shm)
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.serialization import serialize

nbytes = int(float(sys.argv[1]) * (1 << 30))
out = {"bytes": nbytes}
runtime = rt.init(num_cpus=4)
session = worker._runtime.client.session_name


def ms(t0):
    return (time.perf_counter() - t0) * 1e3


rebuilds = []
rebuild = serialization._rebuild_tensor


def timed_rebuild(*args):
    # the unpickler finds _rebuild_tensor by name in its module
    t0 = time.perf_counter()
    out = rebuild(*args)
    rebuilds.append(ms(t0))
    return out


def free(name):
    if name.startswith("arena:"):       # an object that fit the arena
        _, seg, oid = name.split(":", 2)
        attach_arena(seg).delete(oid)
    else:                               # a segment of its own
        os.unlink("/dev/shm/" + name.lstrip("/"))


@rt.remote
def noop():
    return None


@rt.remote
class Pinger:
    def ping(self):
        return None


rt.get([noop.remote() for _ in range(200)], timeout=300)
t0 = time.perf_counter()
rt.get([noop.remote() for _ in range(2000)], timeout=600)
out["tasks_per_s"] = 2000 / (ms(t0) / 1e3)
p = Pinger.remote()
for _ in range(100):
    rt.get(p.ping.remote())
rtt = []
for _ in range(1000):
    t0 = time.perf_counter()
    rt.get(p.ping.remote())
    rtt.append((time.perf_counter() - t0) * 1e6)
rtt.sort()
out["call_us_p50"], out["call_us_p99"] = rtt[500], rtt[989]
rt.kill(p)

objects = {
    "numpy": lambda: np.ones(nbytes, dtype=np.uint8),
    "tensor_bf16": lambda: torch.ones(nbytes // 2, dtype=torch.bfloat16),
}
for kind, make in objects.items():
    x = make()
    puts, gets = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        ref = rt.put(x)
        puts.append(ms(t0))
        t0 = time.perf_counter()
        y = rt.get(ref)
        gets.append(ms(t0))
        assert y.shape == x.shape
        del y, ref
    out[kind] = {"put_ms": puts, "get_ms": gets,
                 "put_gbs": [nbytes / m / 1e6 for m in puts],
                 "get_gbs": [nbytes / m / 1e6 for m in gets]}
    # the store's stages, one by one (the daemon's registration RPC
    # and the owner's bookkeeping are what put_ms holds beyond them)
    stages = {}
    for i in range(2):
        t0 = time.perf_counter()
        s = serialize(x)
        stages.setdefault("serialize_ms", []).append(ms(t0))
        t0 = time.perf_counter()
        name, size = write_to_shm(f"stage{kind}{i}", s, session)
        stages.setdefault("write_to_shm_ms", []).append(ms(t0))
        serialization._rebuild_tensor = timed_rebuild   # reads only
        t0 = time.perf_counter()
        value, keep, _ = read_from_shm(name, size)
        stages.setdefault("read_from_shm_ms", []).append(ms(t0))
        serialization._rebuild_tensor = rebuild
        del value, keep, s
        free(name)
    if rebuilds:
        stages["rebuild_tensor_ms"] = rebuilds[:]
        rebuilds.clear()
    out[kind]["stages"] = stages
    del x

# the host's own rates, one thread
t0 = time.perf_counter()
fresh = np.empty(nbytes, dtype=np.uint8)
fresh[:] = 1
out["fresh_anon_fill_gbs"] = nbytes / ms(t0) / 1e6
t0 = time.perf_counter()
fresh_t = torch.empty(nbytes, dtype=torch.uint8)
fresh_t.numpy()[:] = 1
out["fresh_torch_fill_gbs"] = nbytes / ms(t0) / 1e6
del fresh_t
t0 = time.perf_counter()
fresh[:] = 2
out["warm_fill_gbs"] = nbytes / ms(t0) / 1e6
src = np.full(nbytes, 3, dtype=np.uint8)
t0 = time.perf_counter()
np.copyto(fresh, src)
out["warm_copy_gbs"] = nbytes / ms(t0) / 1e6
seg = f"rtpu_hostcost_{os.getpid()}"
shm = create_untracked_shm(seg, nbytes)
t0 = time.perf_counter()
np.frombuffer(shm.buf, dtype=np.uint8)[:] = 1
out["fresh_shm_fill_gbs"] = nbytes / ms(t0) / 1e6
shm.close()
shm = attach_shm(seg)                   # a new mapping of filled pages
t0 = time.perf_counter()
np.copyto(fresh, np.frombuffer(shm.buf, dtype=np.uint8))
out["mapped_shm_read_gbs"] = nbytes / ms(t0) / 1e6
shm.close()
shm.unlink()
del fresh, src

if torch.cuda.is_available():
    n = 256 << 20

    @rt.remote(num_gpus=1)
    def cuda_tensor():
        return torch.ones(n // 2, dtype=torch.bfloat16, device="cuda")

    @rt.remote(num_gpus=1)
    def cuda_copy_ms():
        t = torch.ones(n // 2, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.cpu()
        return (time.perf_counter() - t0) * 1e3

    @rt.remote
    def cpu_tensor():
        return torch.ones(n // 2, dtype=torch.bfloat16)

    rt.get(cuda_tensor.remote(), timeout=300)          # the worker's CUDA up
    gpu = {}
    for name, fn in (("cuda_return_ms", cuda_tensor),
                     ("cpu_return_ms", cpu_tensor)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rt.get(fn.remote(), timeout=300)
            times.append(ms(t0))
        gpu[name] = times
    gpu["in_task_copy_ms"] = [rt.get(cuda_copy_ms.remote(), timeout=300)
                              for _ in range(3)]
    out["return_256mib"] = gpu
rt.shutdown()
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    for _ in range(a.rounds):
        res = subprocess.run([sys.executable, "-c", CHILD, str(a.gib)],
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            sys.exit(res.returncode)
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
