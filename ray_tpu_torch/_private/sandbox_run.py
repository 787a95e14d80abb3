"""Container-lite worker launcher: user+mount namespaces + chroot.

Role of the reference's container runtime-env plugin
(python/ray/_private/runtime_env/image_uri.py, which shells out to
podman): bare TPU nodes in this stack's target environments have no
container runtime, but Linux user namespaces are available everywhere —
so ``image_uri: sandbox://<rootfs-dir>`` activates an unprivileged
filesystem sandbox instead:

- a new user namespace (root inside, unprivileged outside) + mount
  namespace;
- the image rootfs is mounted through an OVERLAY with a tmpfs upper
  layer, so launches never mutate the user's image directory and
  read-only rootfs (squashfs, ro binds) work; kernels without
  unprivileged overlayfs fall back to binding into the rootfs
  directly;
- the HOST runtime is recursively bind-mounted in (/usr, /lib, /opt,
  /proc, /dev incl. /dev/shm — the object-store arena must stay
  shared — plus ``--bind`` extras such as the ray_tpu_torch package dir and
  the worker interpreter's prefix), so the sandbox always has a
  working Python;
- everything else inside the image shadows or extends the host view,
  and host paths OUTSIDE the bind set are invisible;
- ``chroot`` pivots in, the pre-chroot working directory is restored
  when it exists inside (working_dir runtime envs compose), and the
  worker command execs.

Usage:  python -m ray_tpu_torch._private.sandbox_run ROOTFS \
            [--bind PATH]... -- CMD ARG...
"""

from __future__ import annotations

import ctypes
import os
import shlex
import sys
import tempfile

DEFAULT_BINDS = ("/usr", "/lib", "/lib64", "/bin", "/sbin", "/opt",
                 "/etc", "/proc", "/sys", "/dev", "/tmp", "/var",
                 "/run")

_CLONE_NEWUSER = 0x10000000
_CLONE_NEWNS = 0x00020000


def build_script(rootfs: str, binds, cmd) -> str:
    q = shlex.quote
    stage = q(os.path.join(tempfile.gettempdir(), ".ray_tpu_sbx"))
    lines = [
        "set -e",
        f"mkdir -p {stage}",
        # per-namespace tmpfs: upper/work dirs and any mkdir fallout
        # live here, never in the user's image directory
        f"mount -t tmpfs tmpfs {stage}",
        f"mkdir -p {stage}/u {stage}/w {stage}/m",
        f"if mount -t overlay overlay -o "
        f"lowerdir={q(rootfs)},upperdir={stage}/u,workdir={stage}/w "
        f"{stage}/m 2>/dev/null; then R={stage}/m; "
        f"else R={q(rootfs)}; fi",
    ]
    for b in binds:
        if not os.path.exists(b):
            continue
        target = "$R" + b
        lines.append(f"mkdir -p {target}")
        lines.append(f"mount --rbind {q(b)} {target}")
    inner = (' cd "$RAY_TPU_SANDBOX_CWD" 2>/dev/null || cd /; '
             'exec "$@" ')
    lines.append(f"exec chroot \"$R\" /bin/sh -c {q(inner)} sh "
                 + " ".join(q(c) for c in cmd))
    return "\n".join(lines)


def _run_wide_map(script: str) -> None:
    """Root-launched namespaces get a FULL-RANGE uid/gid map.

    ``--map-root-user`` maps only the caller's uid; every file owned
    by any OTHER uid appears as the overflow uid inside the
    namespace, and mode-700 directories owned by such uids become
    untraversable even for namespace-root (no CAP_DAC_OVERRIDE over
    unmapped owners) — so binding a working dir that lives under
    e.g. a mode-700 home directory owned by a different account fails
    EACCES.
    A real-root launcher holds CAP_SETUID/CAP_SETGID and may map the
    whole range, restoring normal DAC behavior with no privilege
    gained (root outside is root inside). Multi-entry maps can only
    be written by a PARENT process, so: fork, child unshares and
    execs the mount script, parent writes the maps and mirrors the
    child's exit status. Returns (falls through to the single-map
    CLI path) if the namespace or map setup is refused.
    """
    r_ready, w_ready = os.pipe()
    r_go, w_go = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r_ready)
        os.close(w_go)
        libc = ctypes.CDLL(None, use_errno=True)
        if libc.unshare(_CLONE_NEWUSER | _CLONE_NEWNS) != 0:
            os._exit(125)
        os.write(w_ready, b"x")
        os.close(w_ready)
        go = os.read(r_go, 1)
        os.close(r_go)
        if go != b"g":
            os._exit(125)
        os.execvp("sh", ["sh", "-c", script])
    os.close(w_ready)
    os.close(r_go)
    mapped = False
    try:
        if os.read(r_ready, 1) == b"x":
            try:
                with open(f"/proc/{pid}/setgroups", "w") as f:
                    f.write("deny")
            except OSError:
                pass            # not required when CAP_SETGID held
            with open(f"/proc/{pid}/uid_map", "w") as f:
                f.write("0 0 65536\n")
            with open(f"/proc/{pid}/gid_map", "w") as f:
                f.write("0 0 65536\n")
            mapped = True
    except OSError:
        mapped = False
    finally:
        os.close(r_ready)
    go_ok = False
    try:
        os.write(w_go, b"g" if mapped else b"n")
        go_ok = True
    except OSError:
        pass
    os.close(w_go)
    _, status = os.waitpid(pid, 0)
    code = (os.WEXITSTATUS(status) if os.WIFEXITED(status)
            else 128 + os.WTERMSIG(status))
    if not (mapped and go_ok):
        # the child never exec'd (unshare refused, map write failed,
        # or the go byte was lost) — fall back to the unshare CLI
        # path. A mapped child that received its go byte DID exec the
        # script, so its exit status is the command's own (even 125)
        # and must be mirrored, never re-run.
        return
    sys.exit(code)


def main() -> None:
    args = sys.argv[1:]
    if not args or "--" not in args:
        sys.stderr.write(__doc__ + "\n")
        sys.exit(2)
    split = args.index("--")
    head, cmd = args[:split], args[split + 1:]
    rootfs = os.path.abspath(head[0])
    extra = []
    i = 1
    while i < len(head):
        if head[i] == "--bind" and i + 1 < len(head):
            extra.append(head[i + 1])
            i += 2
        else:
            sys.stderr.write(f"unknown arg {head[i]!r}\n")
            sys.exit(2)
    if not os.path.isdir(rootfs):
        sys.stderr.write(f"rootfs {rootfs} is not a directory\n")
        sys.exit(2)
    # the session's files live under tempfile.gettempdir() (TMPDIR),
    # which need not lie under /tmp
    binds = list(DEFAULT_BINDS)
    for b in [tempfile.gettempdir()] + extra:
        if b not in binds:
            binds.append(b)
    os.environ.setdefault("RAY_TPU_SANDBOX_CWD", os.getcwd())
    script = build_script(rootfs, binds, cmd)
    if os.geteuid() == 0:
        _run_wide_map(script)   # exits unless setup was refused
    os.execvp("unshare", ["unshare", "--user", "--map-root-user",
                          "--mount", "sh", "-c", script])


if __name__ == "__main__":
    main()
