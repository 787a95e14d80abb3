"""Native (C++) components, loaded via ctypes.

The port's copy of ``ray_tpu/_native/__init__.py``. The .so builds on
demand with ``g++`` from this package's own ``csrc/`` (a copy of
``src/arena_store.cc``) into ``<checkout>/build/ray_tpu_torch/``, apart
from the reference's ``build/libarena.so``; failures degrade gracefully
— callers fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

_lock = threading.Lock()
_libs = {}

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build_dir() -> str:
    d = os.environ.get("RAY_TPU_BUILD_DIR")
    if d:
        return os.path.join(d, "ray_tpu_torch")
    d = os.path.join(_REPO_ROOT, "build")
    if os.access(os.path.dirname(d), os.W_OK):
        return os.path.join(d, "ray_tpu_torch")
    return os.path.join(tempfile.gettempdir(), "ray_tpu_build",
                        "ray_tpu_torch")


def load_library(name: str, source: str) -> Optional[ctypes.CDLL]:
    """Load build/ray_tpu_torch/<name>.so, compiling csrc/<source> first
    if needed."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        build = _build_dir()
        so_path = os.path.join(build, f"{name}.so")
        src_path = os.path.join(_CSRC, source)
        try:
            have_src = os.path.exists(src_path)
            if not os.path.exists(so_path) or (
                    have_src and os.path.getmtime(so_path)
                    < os.path.getmtime(src_path)):
                if not have_src:
                    raise FileNotFoundError(src_path)
                os.makedirs(build, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                # -lrt: shm_open/shm_unlink live in librt on older
                # glibc (no-op on newer where they moved into libc)
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall",
                     "-shared", "-pthread", "-o", tmp, src_path,
                     "-lrt"],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)   # atomic: racing builds OK
            lib = ctypes.CDLL(so_path)
        except Exception:
            lib = None
        _libs[name] = lib
        return lib
