"""Runtime-env plugin system: pluggable env materialization + URI cache.

Reference parity: python/ray/_private/runtime_env/plugin.py:24
(RuntimeEnvPlugin) and :118 (RuntimeEnvPluginManager), conda.py, uv.py,
image_uri.py, working_dir.py — re-shaped for this runtime: plugins run
inside the node daemon (there is no separate runtime-env agent process)
and produce a RuntimeEnvContext the worker spawn consumes. Per-node URI
caching: every expensive artifact (downloaded working_dir, pip target,
conda env, uv venv) lands in a content-keyed cache directory guarded by
a marker file + flock, so N workers (and N daemons sharing a session
temp dir) build each env once.

Built-ins: env_vars, working_dir (local dir or storage URI), py_modules
(local paths or URIs), pip, conda (named env or create-on-demand), uv
(venv + packages), image_uri (container stub for the GKE story).
External plugins register via `register_plugin()` or the
RAY_TPU_RUNTIME_ENV_PLUGINS env var ("module:Class,module:Class").
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional

import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RuntimeEnvContext:
    """What a materialized env means for a worker process."""

    env_vars: Dict[str, str] = dataclasses.field(default_factory=dict)
    extra_paths: List[str] = dataclasses.field(default_factory=list)
    cwd: Optional[str] = None
    # conda/uv envs run the worker under a different interpreter
    py_executable: Optional[str] = None
    # image_uri stub: propagated so a container runtime integration
    # (KubeRay/GKE) can wrap the worker command
    container: Optional[Dict[str, Any]] = None


class RuntimeEnvPlugin:
    """One runtime_env key's materializer (reference plugin.py:24).

    Subclass and set `name` to the runtime_env dict key consumed;
    `priority` orders creation (lower first, reference: priority field).
    """

    name: str = ""
    priority: int = 50

    def validate(self, value: Any) -> None:
        """Raise on malformed config (called at env build start)."""

    async def create(self, value: Any, ctx: RuntimeEnvContext,
                     node: "NodeServices") -> None:
        raise NotImplementedError


class NodeServices:
    """What plugins may use from the hosting daemon."""

    def __init__(self, temp_dir: str):
        self.temp_dir = temp_dir
        self.cache = URICache(os.path.join(temp_dir, "runtime_envs"))

    async def run(self, cmd: List[str], timeout: float = 600.0
                  ) -> "subprocess.CompletedProcess":
        """Run a subprocess off the event loop (stderr kept separate so
        callers can parse stdout — e.g. conda's JSON — cleanly)."""
        def _run():
            return subprocess.run(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                timeout=timeout)
        return await asyncio.get_running_loop().run_in_executor(None, _run)


class URICache:
    """Per-node content-keyed artifact cache (reference: the runtime-env
    agent's URI cache). get_or_create builds once under flock; every
    later env with the same key reuses the directory."""

    def __init__(self, root: str):
        self.root = root
        self.hits = 0
        self.misses = 0

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, key)

    async def get_or_create(
            self, key: str,
            create: Callable[[str], None]) -> str:
        """`create(target_dir)` materializes the artifact; it runs in an
        executor thread, at most once per key per node."""
        target = self.path_for(key)
        marker = os.path.join(target, ".ready")
        if os.path.exists(marker):
            self.hits += 1
            return target
        os.makedirs(self.root, exist_ok=True)
        lock_path = target + ".lock"

        def _locked_create():
            import fcntl
            with open(lock_path, "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if os.path.exists(marker):
                    return False
                # Partial artifacts must never poison the key (e.g. a
                # half-made conda prefix fails 'prefix already exists'
                # on every retry): clear any prior debris, build, and
                # clean up again on failure. Build-and-rename is NOT an
                # option — conda/venv prefixes bake absolute paths.
                shutil.rmtree(target, ignore_errors=True)
                os.makedirs(target)
                try:
                    create(target)
                except BaseException:
                    shutil.rmtree(target, ignore_errors=True)
                    raise
                with open(marker, "w") as f:
                    f.write("ok")
                return True

        created = await asyncio.get_running_loop().run_in_executor(
            None, _locked_create)
        if created:
            self.misses += 1
        else:
            self.hits += 1
        return target


def _content_key(prefix: str, payload: Any) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return f"{prefix}-{hashlib.sha1(blob).hexdigest()[:16]}"


def _is_uri(path: str) -> bool:
    from ..train.storage import is_uri
    return is_uri(path)


# ------------------------------------------------------------ built-ins

class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 10

    def validate(self, value):
        if not isinstance(value, dict):
            raise ValueError("env_vars must be a dict of str -> str")

    async def create(self, value, ctx, node):
        ctx.env_vars.update({str(k): str(v) for k, v in value.items()})


class WorkingDirPlugin(RuntimeEnvPlugin):
    """Local directory, or a storage URI (gs://, mock://, ...) that is
    downloaded once per node into the URI cache (reference
    working_dir.py + URI caching)."""

    name = "working_dir"
    priority = 20

    async def create(self, value, ctx, node):
        wd = str(value)
        if _is_uri(wd):
            from ..train.storage import download_dir
            wd = await node.cache.get_or_create(
                _content_key("workdir", wd),
                lambda target: download_dir(value, target))
        else:
            wd = os.path.abspath(wd)
            if not os.path.isdir(wd):
                raise RuntimeError(f"runtime_env working_dir {wd!r} "
                                   "does not exist on this node")
        ctx.cwd = wd
        ctx.extra_paths.append(wd)


class PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 30

    async def create(self, value, ctx, node):
        for mod in value or []:
            mod = str(mod)
            if _is_uri(mod):
                from ..train.storage import download_dir
                local = await node.cache.get_or_create(
                    _content_key("pymod", mod),
                    lambda target, uri=mod: download_dir(uri, target))
                ctx.extra_paths.append(local)
                continue
            mod = os.path.abspath(mod)
            if not os.path.exists(mod):
                raise RuntimeError(f"runtime_env py_module {mod!r} "
                                   "does not exist on this node")
            # a module's import root is its parent directory (works for
            # both package dirs and single .py files)
            ctx.extra_paths.append(os.path.dirname(mod))


class PipPlugin(RuntimeEnvPlugin):
    # priority AFTER conda/uv: combined envs must install with the
    # worker's actual interpreter (ABI) — host-interpreter wheels on a
    # conda py3.10 path would fail to import
    name = "pip"
    priority = 45

    async def create(self, value, ctx, node):
        pkgs = list(value.get("packages", [])) if isinstance(value, dict) \
            else list(value)
        if not pkgs:
            return
        py = ctx.py_executable or sys.executable

        def install(target):
            cmd = [py, "-m", "pip", "install",
                   "--target", target, "--quiet"]
            from .config import get_config
            find_links = get_config().pip_find_links
            if find_links:
                cmd += ["--no-index", "--find-links", find_links]
            cmd += pkgs
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"runtime_env pip install failed "
                    f"(rc={proc.returncode}): "
                    f"{proc.stdout.decode(errors='replace')[-2000:]}")

        target = await node.cache.get_or_create(
            _content_key("pip", [py] + pkgs), install)
        ctx.extra_paths.append(target)


class CondaPlugin(RuntimeEnvPlugin):
    """Named existing env, or {dependencies: [...]} created on demand
    (reference conda.py). The worker runs under the env's interpreter."""

    name = "conda"
    priority = 40

    def validate(self, value):
        if not isinstance(value, (str, dict)):
            raise ValueError(
                "conda must be an env name or an environment dict")

    def _conda_exe(self) -> str:
        exe = os.environ.get("CONDA_EXE") or shutil.which("conda")
        if not exe:
            raise RuntimeError(
                "runtime_env conda requested but no conda executable "
                "found (set CONDA_EXE or install conda on this node)")
        return exe

    async def create(self, value, ctx, node):
        exe = self._conda_exe()
        if isinstance(value, str):
            # named env: resolve its prefix once
            out = await node.run([exe, "env", "list", "--json"])
            if out.returncode != 0:
                raise RuntimeError(
                    f"conda env list failed (rc={out.returncode}): "
                    f"{out.stderr.decode(errors='replace')[-1000:]}")
            envs = json.loads(out.stdout.decode())["envs"]
            prefix = next(
                (e for e in envs
                 if os.path.basename(e) == value or e == value), None)
            if prefix is None:
                raise RuntimeError(f"conda env {value!r} not found")
        else:
            def build(target):
                import yaml
                spec_path = os.path.join(target, "environment.yml")
                with open(spec_path, "w") as f:
                    yaml.safe_dump(value, f)
                proc = subprocess.run(
                    [exe, "env", "create", "-p",
                     os.path.join(target, "env"), "-f", spec_path],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"conda env create failed: "
                        f"{proc.stdout.decode(errors='replace')[-2000:]}")

            target = await node.cache.get_or_create(
                _content_key("conda", value), build)
            prefix = os.path.join(target, "env")
        ctx.py_executable = os.path.join(prefix, "bin", "python")


class UvPlugin(RuntimeEnvPlugin):
    """uv-managed venv with packages (reference uv.py): a venv is built
    once per package set in the URI cache; packages install with `uv
    pip` when uv is on PATH, plain pip otherwise."""

    name = "uv"
    priority = 40

    async def create(self, value, ctx, node):
        pkgs = list(value.get("packages", [])) if isinstance(value, dict) \
            else list(value)

        def build(target):
            venv_dir = os.path.join(target, "venv")
            import venv as venv_mod
            venv_mod.EnvBuilder(with_pip=True,
                                system_site_packages=True).create(venv_dir)
            py = os.path.join(venv_dir, "bin", "python")
            if pkgs:
                uv = shutil.which("uv")
                cmd = ([uv, "pip", "install", "--python", py] if uv
                       else [py, "-m", "pip", "install", "--quiet"])
                from .config import get_config
                find_links = get_config().pip_find_links
                if find_links:
                    cmd += ["--no-index", "--find-links", find_links]
                proc = subprocess.run(cmd + pkgs, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"uv env install failed: "
                        f"{proc.stdout.decode(errors='replace')[-2000:]}")

        target = await node.cache.get_or_create(
            _content_key("uv", pkgs), build)
        ctx.py_executable = os.path.join(target, "venv", "bin", "python")


class ImageURIPlugin(RuntimeEnvPlugin):
    """Container images (reference image_uri.py, which shells out to
    podman). Two modes:

    - ``sandbox://<rootfs-dir>``: NATIVE container-lite — workers run
      inside an unprivileged user+mount namespace chrooted into the
      rootfs, with the host runtime bind-mounted in
      (_private/sandbox_run.py). No container runtime needed; works on
      bare TPU nodes.
    - any other URI: propagated for an external runtime to wrap the
      worker command (KubeRay/GKE supplies
      RAY_TPU_CONTAINER_RUN_PREFIX; bare nodes fail loudly).
    """

    name = "image_uri"
    priority = 5

    def validate(self, value):
        if not isinstance(value, str) or not value:
            raise ValueError("image_uri must be a non-empty string")
        if value.startswith("sandbox://"):
            rootfs = value[len("sandbox://"):]
            if not os.path.isdir(rootfs):
                raise ValueError(
                    f"sandbox:// rootfs {rootfs!r} is not a directory")

    async def create(self, value, ctx, node):
        if value.startswith("sandbox://"):
            import sys
            rootfs = os.path.abspath(value[len("sandbox://"):])
            pkg_parent = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            prefix_args = ["--bind", pkg_parent]
            # a venv/conda interpreter outside the default bind set
            # (e.g. a venv in a home directory) must be visible inside the chroot or
            # the exec dies invisibly after the pivot
            from .sandbox_run import DEFAULT_BINDS
            for pfx in {sys.prefix, sys.base_prefix}:
                if not any(pfx == b or pfx.startswith(b + "/")
                           for b in DEFAULT_BINDS):
                    prefix_args += ["--bind", pfx]
            ctx.container = {
                "image_uri": value,
                # the daemon prepends this to the worker argv
                "run_prefix": [sys.executable, "-m",
                               "ray_tpu_torch._private.sandbox_run", rootfs]
                              + prefix_args + ["--"],
            }
            return
        ctx.container = {"image_uri": value}


_BUILTIN_PLUGINS = (ImageURIPlugin, EnvVarsPlugin, WorkingDirPlugin,
                    PyModulesPlugin, PipPlugin, CondaPlugin, UvPlugin)
_registered: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    """Register an external RuntimeEnvPlugin (reference
    RuntimeEnvPluginManager.add; also loadable via the
    RAY_TPU_RUNTIME_ENV_PLUGINS env var)."""
    if not plugin.name:
        raise ValueError("plugin needs a non-empty name")
    _registered[plugin.name] = plugin


def _load_env_var_plugins() -> None:
    spec = os.environ.get("RAY_TPU_RUNTIME_ENV_PLUGINS", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            module_name, cls_name = item.split(":", 1)
            import importlib
            cls = getattr(importlib.import_module(module_name), cls_name)
            register_plugin(cls())
        except Exception:
            logger.exception("failed to load runtime-env plugin %r", item)


class RuntimeEnvPluginManager:
    """Builds RuntimeEnvContexts by running each configured key's plugin
    in priority order (reference plugin.py:118)."""

    def __init__(self, temp_dir: str):
        self.node = NodeServices(temp_dir)
        self.plugins: Dict[str, RuntimeEnvPlugin] = {
            p.name: p for p in (cls() for cls in _BUILTIN_PLUGINS)}
        _load_env_var_plugins()
        self.plugins.update(_registered)

    async def build(self, runtime_env: Optional[dict]
                    ) -> RuntimeEnvContext:
        ctx = RuntimeEnvContext()
        if not runtime_env:
            return ctx
        # late-registered plugins (register_plugin after daemon start)
        for name, plugin in _registered.items():
            self.plugins.setdefault(name, plugin)
        unknown = set(runtime_env) - set(self.plugins)
        if unknown:
            raise ValueError(
                f"unknown runtime_env key(s) {sorted(unknown)} "
                f"(known: {sorted(self.plugins)})")
        todo = sorted((self.plugins[k] for k in runtime_env),
                      key=lambda p: p.priority)
        for plugin in todo:
            value = runtime_env[plugin.name]
            plugin.validate(value)
            await plugin.create(value, ctx, self.node)
        return ctx
