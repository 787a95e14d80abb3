"""Device trace scopes.

The counterpart of ``ray_tpu/util/profiling.py``'s ``trace``: where the
JAX package's runs ``jax.profiler`` and writes a TensorBoard directory,
this one runs ``torch.profiler`` over the host's operators and, on a
CUDA device, the card's kernels, copies and runtime calls, and writes
one Chrome trace JSON into ``log_dir`` (``chrome://tracing``,
Perfetto); with helpers to find, merge and count what it wrote. (The
JAX module's stack dump, memory summary and ``profile_step`` serve its
dashboard and have no caller here.)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

# traces written by this process, for unique file names in one log_dir
_trace_seq = itertools.count(1)

# The profiler loses device records at the start of a session. On the
# H100 (torch 2.11, CUPTI through Kineto), once a process had run a few
# profiles, sessions at times missed the first kernel launched after the
# start, or every kernel of a short window. A first launch that is
# itself a kernel kept running for a while, followed by a synchronise,
# took the loss in its place. So a device trace opens with one
# LEAD_CYCLES spin kernel ("spin_kernel", which readers leave out), a
# synchronise and LEAD_S of idle time, and closes with a synchronise
# and SETTLE_S of idle time before the profiler stops. A session must
# stop on the thread that started it.
LEAD_CYCLES = 4_000_000         # ~2 ms of the card's clock
LEAD_S = 0.005
SETTLE_S = 0.05
LEAD_KERNEL = "spin_kernel"


def lead_in() -> None:
    """Open a device trace: a spin kernel, a synchronise, idle time."""
    torch.cuda._sleep(LEAD_CYCLES)
    torch.cuda.synchronize()
    time.sleep(LEAD_S)


def settle() -> None:
    """Close a device trace: a synchronise, then idle time."""
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False
          ) -> Iterator[None]:
    """torch.profiler trace scope: the host's operators and, when CUDA
    is initialised in this process, the card's kernels, copies and
    runtime calls. On the card the trace opens with ``lead_in`` and
    closes with ``settle`` (work enqueued inside the scope lands in the
    trace), then one Chrome trace JSON lands in `log_dir`
    (``trace-<pid>-<n>.json``). `create_perfetto_link` is kept for the
    JAX package's signature; a Chrome trace opens in Perfetto as is."""
    from torch.profiler import ProfilerActivity, profile

    del create_perfetto_link
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        if cuda:
            lead_in()
        yield
    finally:
        try:
            if cuda:
                settle()
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace-{os.getpid()}-{next(_trace_seq)}.json"))


def trace_files(log_dir: str) -> List[str]:
    """The Chrome trace files `trace` wrote into `log_dir`, oldest
    first."""
    names = [n for n in os.listdir(log_dir)
             if n.startswith("trace-") and n.endswith(".json")]
    return [os.path.join(log_dir, n) for n in sorted(
        names, key=lambda n: int(n[:-5].rsplit("-", 1)[1]))]


def merge_traces(paths: List[str]) -> Optional[str]:
    """Merge Chrome trace files (sessions of one capture, oldest first)
    into the first path: their events concatenated, the first one's
    other keys kept; the others are removed. Returns the merged path."""
    if not paths:
        return None
    with open(paths[0]) as f:
        doc = json.load(f)
    for p in paths[1:]:
        with open(p) as f:
            doc["traceEvents"].extend(json.load(f)["traceEvents"])
    with open(paths[0], "w") as f:
        json.dump(doc, f)
    for p in paths[1:]:
        os.remove(p)
    return paths[0]


def kernel_launches(events: List[Dict[str, Any]], *keys: str
                    ) -> Dict[str, int]:
    """Device kernel records of a Chrome trace's events, counted by
    name, for the names holding one of `keys` (all kernels but the
    trace's lead-in without keys)."""
    out: Dict[str, int] = {}
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        if LEAD_KERNEL in name or (keys and not any(k in name
                                                    for k in keys)):
            continue
        out[name] = out.get(name, 0) + 1
    return out
