"""Worker forkserver (zygote) specifics: forked-worker liveness
accounting and the cold-Popen fallback path."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(env_extra):
    code = """
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=4)

@ray_tpu_torch.remote
class C:
    def ping(self):
        import os
        return os.getpid()

a, b = C.remote(), C.remote()
pids = ray_tpu_torch.get([a.ping.remote(), b.ping.remote()])
assert pids[0] != pids[1]
ray_tpu_torch.kill(a)

@ray_tpu_torch.remote
def f(x):
    return x + 1

assert ray_tpu_torch.get(f.remote(41)) == 42
print("SPAWN_OK")
ray_tpu_torch.shutdown()
"""
    env = dict(os.environ, **env_extra)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert "SPAWN_OK" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_forkserver_spawn():
    _run({"RAY_TPU_FORKSERVER": "1"})


def test_cold_popen_fallback():
    """RAY_TPU_FORKSERVER=0 must keep everything working on the cold
    Popen path (the fallback used when the zygote dies)."""
    _run({"RAY_TPU_FORKSERVER": "0"})
