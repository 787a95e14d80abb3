"""Worker forkserver ("zygote"): pay interpreter + import cost once.

Reference parity: the role of worker prestarting
(worker_pool.h maximum_startup_concurrency / prestart) — but solving
the deeper cost: a cold `python -m worker_main` pays the interpreter,
numpy, cloudpickle and torch (which the package imports) on every
spawn, seconds a worker. The zygote imports everything once, then forks
per worker in ~10 ms; children apply their env vars (among them the
CUDA_VISIBLE_DEVICES pin), re-open their log file, and run the normal
worker main. Safe because the zygote never initializes CUDA (importing
torch does not; a child forked after cuInit could not use CUDA),
starts an event loop, or spawns threads — fork happens from a
single-threaded, CUDA-less process.

Protocol (zygote stdin/stdout, one JSON line per message; replies are
routed by worker_id, and child exits are pushed asynchronously so the
daemon never has to probe possibly-reused pids):
    -> {"worker_id", "argv": [...], "env": {...}, "log_path", "cwd"}
    <- {"worker_id", "pid": N}
    <- {"exited": pid, "code": N}          (async, from the reaper)
The daemon holds one zygote per node and falls back to cold Popen if
the zygote dies (RAY_TPU_FORKSERVER=0 disables entirely).
"""

from __future__ import annotations

import json
import os
import signal
import sys


def _emit(out_fd: int, msg: dict) -> None:
    # os.write of a short line is atomic (< PIPE_BUF) and shares no
    # Python-level locks with the reaper thread or forked children
    os.write(out_fd, (json.dumps(msg) + "\n").encode())


def zygote_main() -> None:
    # Pre-import the worker's world. Everything imported here is shared
    # COW memory across all workers on the node.
    from . import worker_main  # noqa: F401  (pulls core/protocol/serialization)

    stdin = os.fdopen(os.dup(0), "rb")
    out_fd = os.dup(1)
    # stop anything imported later from scribbling on the protocol pipe
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)

    # Reap forked children ON THE MAIN THREAD via SIGCHLD (no zombies;
    # the daemon cannot reap them — they are OUR children). Python runs
    # signal handlers between bytecodes on the main thread, so a sweep
    # can never overlap a fork: the process stays single-threaded and
    # the fork-safety claim in the module docstring holds. PEP 475
    # transparently restarts the interrupted stdin read.
    signal.signal(signal.SIGCHLD, lambda _sig, _frm: _reap_sweep(out_fd))

    protocol_fds = [stdin.fileno(), out_fd, devnull]
    for line in stdin:
        try:
            req = json.loads(line)
        except Exception:
            continue
        pid = os.fork()
        if pid == 0:
            _child(req, protocol_fds)        # never returns
        _emit(out_fd, {"worker_id": req["worker_id"], "pid": pid})


def _reap_sweep(out_fd: int) -> None:
    """SIGCHLD handler body: drain every exited child (signals coalesce,
    so one delivery may cover several exits) and push exit notices."""
    while True:
        try:
            pid, status = os.waitpid(-1, os.WNOHANG)
        except (ChildProcessError, OSError):
            return
        if pid == 0:
            return
        code = (os.waitstatus_to_exitcode(status)
                if hasattr(os, "waitstatus_to_exitcode") else -1)
        _emit(out_fd, {"exited": pid, "code": code})


def _child(req: dict, protocol_fds) -> None:
    try:
        os.setsid()
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        log_fd = os.open(req["log_path"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(log_fd, 1)
        os.dup2(log_fd, 2)
        os.close(log_fd)
        # Drop the zygote's protocol fds: a worker holding the stdout
        # pipe's write end would keep the daemon from seeing EOF (and
        # thus zygote death) for as long as the worker lives.
        for fd in protocol_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        for key, val in (req.get("env") or {}).items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        # runtime-env import paths land at the FRONT so they shadow
        # driver-side modules (only ray_tpu_torch itself + stdlib are already
        # imported and hence unshadowable — documented limitation)
        for p in reversed(req.get("path_prepend") or []):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        if req.get("cwd"):
            os.chdir(req["cwd"])
        sys.argv = ["worker_main"] + list(req["argv"])
        from .worker_main import main
        main()
        os._exit(0)
    except BaseException:
        import traceback
        traceback.print_exc()
        os._exit(1)


if __name__ == "__main__":
    zygote_main()
