"""Process-level properties of the port's runtime: the worker zygote
forks from a process with no CUDA context and one thread, and the
port's runtime and the JAX package's can follow each other in one
process without leaking shared memory. Each case runs in a fresh
interpreter, so nothing it does can leak into the test worker."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, timeout: float = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("what", ["zygote_imports", "every_module"])
def test_import_leaves_no_cuda_context_and_one_thread(what):
    """What the zygote imports before it forks (worker_main, hence the
    package and torch) and, wider, every module of the port: neither
    initializes CUDA nor starts a thread."""
    load = ("from ray_tpu_torch._private import zygote, worker_main"
            if what == "zygote_imports" else
            "import importlib, pkgutil, ray_tpu_torch\n"
            "for m in pkgutil.walk_packages(ray_tpu_torch.__path__,\n"
            "                               'ray_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)")
    got = _python(load + "\nimport json, threading, torch\n"
                  "print(json.dumps({'threads': threading.active_count(),\n"
                  "  'cuda': torch.cuda.is_initialized()}))")
    assert got == {"threads": 1, "cuda": False}


_TWO_RUNTIMES = r"""
import json, os
import ray_tpu, ray_tpu_torch
from ray_tpu._private.object_store import arena_name_for as jax_arena
from ray_tpu_torch._private.object_store import arena_name_for as port_arena

def run(pkg, arena_name):
    rt = pkg.init(num_cpus=2)
    session = rt.session_name

    @pkg.remote
    def f(x):
        return x + 1

    assert pkg.get(f.remote(41)) == 42
    big = pkg.get(pkg.put(bytes(1 << 20)))      # through the arena
    assert len(big) == 1 << 20
    pkg.shutdown()
    leaked = [n for n in os.listdir("/dev/shm")
              if session in n or n == arena_name(session)]
    return session, leaked

order = [(ray_tpu, jax_arena), (ray_tpu_torch, port_arena)]
if os.environ["ORDER"] == "port_first":
    order.reverse()
out = [run(pkg, arena) for pkg, arena in order]
print(json.dumps({"sessions": [s for s, _ in out],
                  "leaked": [n for _, l in out for n in l]}))
"""


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_two_runtimes_in_one_process(order):
    env = dict(os.environ, PYTHONPATH=REPO, ORDER=order)
    out = subprocess.run([sys.executable, "-c", _TWO_RUNTIMES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(set(got["sessions"])) == 2
    assert got["leaked"] == []


_SESSION_FILES = r"""
import json, os
import ray_tpu_torch
from ray_tpu_torch._private.config import get_config

rt = ray_tpu_torch.init(num_cpus=2)

@ray_tpu_torch.remote
def f(x):
    return x + 1

assert ray_tpu_torch.get(f.remote(1)) == 2
ray_tpu_torch.shutdown()
print(json.dumps({"session": rt.session_name,
                  "workflows": get_config().workflow_storage}))
"""


def test_session_files_follow_tmpdir(tmp_path):
    """The session's logs and the workflow root lie under TMPDIR, not
    under a fixed /tmp path that another checkout's runtime shares."""
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    env.pop("RAY_TPU_WORKFLOW_STORAGE", None)
    out = subprocess.run([sys.executable, "-c", _SESSION_FILES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    root = tmp_path / "ray_tpu"
    assert (root / got["session"] / "logs").is_dir()
    assert got["workflows"] == str(root / "workflows")
    assert not os.path.exists(os.path.join("/tmp/ray_tpu", got["session"]))
