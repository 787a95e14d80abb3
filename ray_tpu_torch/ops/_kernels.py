"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers
in the build, so a build takes seconds). One source may hold several
kernels, each with its own C entry point. Builds happen at first use,
from the sources in this checkout only, into
``<checkout>/build/ray_tpu_torch/<hash>/``; the hash covers every
source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. All sources compile in parallel, one ``nvcc``
each.

Every kernel has a launch counter (``Kernel.launches``) that its
wrapper increments once per launch and nowhere else, so a run can show
that its main path went through the kernel. A CUDA graph replay runs no
wrapper: it adds the launches its capture recorded (``rewind_counts``,
``add_counts``). Nothing here runs at
import: the CPU tests import every module without ``nvcc`` present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "ray_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Kernel:
    """One C entry point of a compiled source: its argument types and
    launch counter. An entry that routes between kernels by type and
    shape also counts its launches by route (``count``)."""

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.routes: Dict[str, int] = {}
        self._fn = None

    def count(self, route: str) -> None:
        """One launch, taken by `route`."""
        self.launches += 1
        self.routes[route] = self.routes.get(route, 0) + 1

    def fn(self):
        if self._fn is None:
            build()
        return self._fn


_DECODE_ARGS = [_P] * 15 + [_I] * 10 + [_P]
_RAGGED_ARGS = [_P] * 18 + [_I] * 15 + [_P]
# The serving kernels take the page pools' kind as an argument (0: pools
# in q's dtype; 1: int8 and 2: fp8 pools with float32 scale pools, the
# dequant fused into the page loads). Each kind has its own Kernel and
# launch counter over the one C entry point, so a run shows which
# variant its main path took.
PAGED_DECODE = Kernel("paged_decode", "paged_decode.cu",
                      "paged_decode_launch", _DECODE_ARGS)
PAGED_DECODE_INT8 = Kernel("paged_decode_int8", "paged_decode.cu",
                           "paged_decode_launch", _DECODE_ARGS)
PAGED_DECODE_FP8 = Kernel("paged_decode_fp8", "paged_decode.cu",
                          "paged_decode_launch", _DECODE_ARGS)
RAGGED_PAGED = Kernel("ragged_paged", "ragged_paged.cu",
                      "ragged_paged_launch", _RAGGED_ARGS)
RAGGED_PAGED_INT8 = Kernel("ragged_paged_int8", "ragged_paged.cu",
                           "ragged_paged_launch", _RAGGED_ARGS)
RAGGED_PAGED_FP8 = Kernel("ragged_paged_fp8", "ragged_paged.cu",
                          "ragged_paged_launch", _RAGGED_ARGS)
PAGED_DECODE_BY_KIND = (PAGED_DECODE, PAGED_DECODE_INT8, PAGED_DECODE_FP8)
RAGGED_PAGED_BY_KIND = (RAGGED_PAGED, RAGGED_PAGED_INT8, RAGGED_PAGED_FP8)
# (B, Sq, Sk, H, KVH, D, causal), scale, dtype, stream
_FLASH_TAIL = [_I] * 7 + [_F, _I, _P]
FLASH_FWD = Kernel("flash_fwd", "flash_attention.cu", "flash_fwd_launch",
                   [_P] * 5 + _FLASH_TAIL)
FLASH_DQ = Kernel("flash_dq", "flash_attention.cu", "flash_dq_launch",
                  [_P] * 7 + _FLASH_TAIL)
FLASH_DKV = Kernel("flash_dkv", "flash_attention.cu", "flash_dkv_launch",
                   [_P] * 8 + _FLASH_TAIL)
# the sampler's Gumbel noise: seeds, index, out, (B, V, stage), stream
ROW_GUMBEL = Kernel("row_gumbel", "threefry.cu", "row_gumbel_launch",
                    [_P] * 3 + [_I] * 3 + [_P])
KERNELS: List[Kernel] = [*PAGED_DECODE_BY_KIND, *RAGGED_PAGED_BY_KIND,
                         FLASH_FWD, FLASH_DQ, FLASH_DKV, ROW_GUMBEL]

_lock = threading.Lock()
_build_info: Dict[str, object] = {}
# builds in this process that compiled or loaded the libraries (the
# engine's compile events: a first use stalls the tick it lands in)
_builds = 0


def _lib(source: str) -> str:
    return f"lib{os.path.splitext(source)[0]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "build with nvcc (set CUDA_HOME)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Dict[str, object]:
    """Compile (or reuse) and load every kernel library. Returns
    {"dir", "seconds", "compiled": [sources], "ptxas": {source: text}}.
    nvcc's output (ptxas -v) is kept beside each library, so a reused
    build reports it too."""
    global _builds
    with _lock:
        if all(k._fn is not None for k in KERNELS):
            return _build_info
        t0 = time.perf_counter()
        out_dir = os.path.join(BUILD_ROOT, source_hash())
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        ptxas = {}
        for source in sorted({k.source for k in KERNELS}):
            so = os.path.join(out_dir, _lib(source))
            if os.path.exists(so) and os.path.exists(so + ".ptxas"):
                with open(so + ".ptxas") as f:
                    ptxas[source] = f.read()
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
            procs[source] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        failed = []
        for name, (p, tmp, so) in procs.items():
            text, _ = p.communicate()
            ptxas[name] = text
            if p.returncode != 0:
                failed.append(f"{name} (rc {p.returncode}):\n{text}")
            else:
                with open(so + ".ptxas", "w") as f:
                    f.write(text)
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        libs = {}
        for k in KERNELS:
            if k.source not in libs:
                libs[k.source] = ctypes.CDLL(
                    os.path.join(out_dir, _lib(k.source)))
            fn = getattr(libs[k.source], k.entry)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            k._fn = fn
        _build_info.update(dir=out_dir, seconds=time.perf_counter() - t0,
                           compiled=sorted(procs), ptxas=ptxas)
        _builds += 1
        if verbose:
            for name in procs:
                print(f"[nvcc {name}]\n{ptxas[name]}")
        return _build_info


def build_count() -> int:
    """Builds (compile or load of the libraries) so far in this
    process: 0 before the first kernel use, 1 after."""
    return _builds


def check(rc: int, name: str) -> None:
    """Raise on a launch the C side refused (-1: arguments; -2: a TMA
    tensor map it could not encode) or CUDA reported."""
    if rc != 0:
        what = {-1: "arguments the kernel does not take",
                -2: "TMA tensor map could not be encoded"}.get(
                    rc, f"cudaError {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {what}")


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches by route, for the kernels that count them."""
    return {k.name: dict(k.routes) for k in KERNELS if k.routes}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.routes.clear()


def counter_state() -> Dict[str, tuple]:
    """Every kernel's (launches, launches by route), as they stand."""
    return {k.name: (k.launches, dict(k.routes)) for k in KERNELS}


def rewind_counts(before: Dict[str, tuple]) -> Dict[str, tuple]:
    """Set the counters back to `before` (``counter_state``) and return
    what was counted since, in the same form: the launches a CUDA graph
    capture recorded, which ``add_counts`` adds at each replay."""
    delta = {}
    for k in KERNELS:
        n0, routes0 = before[k.name]
        moved = {r: n - routes0.get(r, 0) for r, n in k.routes.items()
                 if n != routes0.get(r, 0)}
        if k.launches != n0 or moved:
            delta[k.name] = (k.launches - n0, moved)
        k.launches, k.routes = n0, dict(routes0)
    return delta


def add_counts(delta: Dict[str, tuple]) -> None:
    """Count the launches of one graph replay (``rewind_counts``)."""
    for k in KERNELS:
        if k.name in delta:
            n, routes = delta[k.name]
            k.launches += n
            for route, m in routes.items():
                k.routes[route] = k.routes.get(route, 0) + m


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype) -> Optional[int]:
    """The kernels' query-type code: 0 float32, 1 bfloat16, 2 float16."""
    return _DTYPE_CODES.get(dtype)
