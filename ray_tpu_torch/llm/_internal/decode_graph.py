"""One pure-decode tick, or one multi-step round, as one CUDA graph.

Counterpart of the JAX engine's jitted decode programs (``_build_decode``
and ``_build_multi_decode`` in ``ray_tpu/llm/_internal/engine.py``,
cached per ``all_greedy``): the engine keeps one ``DecodeGraph`` per
sampling mode, adapter stacks present or not, and steps a call, whose
body runs the decode forward (K times for a round), the KV write,
sampling, the seen update and the on-device feedback of tokens and
positions over the engine's static device buffers. On a CUDA device the first call runs the body eagerly
(it is that tick's work, and it makes every one-time setup: the kernels'
shared-memory opt-ins, cached launch plans, library handles) and then
captures it; every later call replays the graph: one launch for the
whole tick. Without capture (the CPU, or ``cuda_graph=False``) every
call runs the body.

A replay runs no Python, so the kernel wrappers' launch counters
(``ops/_kernels.py``) would not move: the launches the body counted
while it was being captured are taken back (capture launches nothing)
and added again at every replay.

Every tensor the body reads must keep its address between calls: the
engine fills its static buffers in place. Temporaries of the body live
in the graph's private memory pool, which the engine shares between its
graphs (they never run concurrently, and each keeps its output alive).

Python's cyclic garbage collector is off during a capture. An engine
and its graphs form reference cycles, so a dead engine's graphs are
freed by that collector, whenever it runs; freeing a graph releases its
memory pool, and a ``cudaFree`` while a stream captures invalidates the
capture (the next launch in it fails, e.g. as
CUBLAS_STATUS_EXECUTION_FAILED in a product). Collections wait until
the capture ends.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, ContextManager, Optional

import torch

from ...ops import _kernels


class DecodeGraph:
    """`body()` -> the tick's (B,) int32 tokens (a multi-step round's
    (K, B)), captured once and replayed (`capture`), or run every call.
    `capturing()` is entered around the capture (the engine counts it
    and lets its syncs through an armed dispatch guard)."""

    def __init__(self, body: Callable[[], torch.Tensor], capture: bool,
                 pool=None,
                 capturing: Callable[[], ContextManager] = (
                     contextlib.nullcontext)):
        self._body = body
        self._capture = capture
        self._pool = pool
        self._capturing = capturing
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self._launches = None
        self.capture_s = 0.0        # host seconds the capture took

    def __call__(self) -> torch.Tensor:
        if self.graph is not None:
            self.graph.replay()
            _kernels.add_counts(self._launches)
            return self.out
        out = self._body()
        if self._capture:
            before = _kernels.counter_state()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with self._capturing():
                    with torch.cuda.graph(graph, pool=self._pool):
                        self.out = self._body()
            finally:
                if collecting:
                    gc.enable()
            self.capture_s = time.perf_counter() - t0
            self._launches = _kernels.rewind_counts(before)
            self.graph = graph
        return out
