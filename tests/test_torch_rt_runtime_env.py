"""Runtime env system: env applied at worker spawn, env-keyed worker
reuse. Reference parity: python/ray/_private/runtime_env/plugin.py:24,118
+ src/ray/raylet/worker_pool.h:224 (env-keyed idle pools)."""

import os
import sys
import textwrap

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_env_vars_applied(ray_start):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_TEST_FLAG": "hello42"}})
    def read_env():
        import os
        return os.environ.get("MY_TEST_FLAG")

    assert ray_tpu_torch.get(read_env.remote()) == "hello42"


def test_env_isolation_between_envs(ray_start):
    """Tasks without the env never see its variables (distinct workers)."""
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ISOLATED_VAR": "yes"}})
    def with_env():
        import os
        return os.environ.get("ISOLATED_VAR"), os.getpid()

    @ray_tpu_torch.remote
    def without_env():
        import os
        return os.environ.get("ISOLATED_VAR"), os.getpid()

    v1, pid1 = ray_tpu_torch.get(with_env.remote())
    v2, pid2 = ray_tpu_torch.get(without_env.remote())
    assert v1 == "yes" and v2 is None
    assert pid1 != pid2


def test_env_keyed_worker_reuse(ray_start):
    """Same runtime env -> same worker reused; different env -> new one."""
    env_a = {"env_vars": {"POOL_TAG": "a"}}

    @ray_tpu_torch.remote(runtime_env=env_a)
    def pid_a():
        import os
        return os.getpid()

    @ray_tpu_torch.remote(runtime_env={"env_vars": {"POOL_TAG": "b"}})
    def pid_b():
        import os
        return os.getpid()

    a1 = ray_tpu_torch.get(pid_a.remote())
    a2 = ray_tpu_torch.get(pid_a.remote())
    b1 = ray_tpu_torch.get(pid_b.remote())
    assert a1 == a2            # env-keyed reuse
    assert b1 != a1            # env mismatch -> different worker


def test_py_modules_module_driver_lacks(ray_start, tmp_path):
    """A task imports a module that does NOT exist on the driver's path —
    delivered via runtime_env py_modules."""
    mod_dir = tmp_path / "exotic_pkg"
    mod_dir.mkdir()
    (mod_dir / "__init__.py").write_text(
        textwrap.dedent("""
        SECRET = "from-runtime-env"
        def double(x):
            return 2 * x
        """))

    with pytest.raises(ImportError):
        import exotic_pkg  # noqa: F401

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod_dir)]})
    def use_it():
        import exotic_pkg
        return exotic_pkg.SECRET, exotic_pkg.double(21)

    secret, doubled = ray_tpu_torch.get(use_it.remote())
    assert secret == "from-runtime-env" and doubled == 42


def test_working_dir(ray_start, tmp_path):
    (tmp_path / "data.txt").write_text("payload")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(tmp_path)})
    def read_file():
        import os
        with open("data.txt") as f:
            return os.path.basename(os.getcwd()), f.read()

    base, content = ray_tpu_torch.get(read_file.remote())
    assert content == "payload"
    assert base == os.path.basename(str(tmp_path))


def test_actor_runtime_env(ray_start):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_ENV": "actorval"}})
    class EnvActor:
        def read(self):
            import os
            return os.environ.get("ACTOR_ENV")

    a = EnvActor.remote()
    assert ray_tpu_torch.get(a.read.remote()) == "actorval"


def test_bad_runtime_env_fails_task(ray_start):
    @ray_tpu_torch.remote(runtime_env={"working_dir": "/nonexistent/dir/xyz"})
    def never_runs():
        return 1

    with pytest.raises(Exception, match="working_dir|spawn"):
        ray_tpu_torch.get(never_runs.remote(), timeout=60)


def test_registered_plugin_applies(ray_start):
    """An externally registered RuntimeEnvPlugin's key works end-to-end
    (reference parity: RuntimeEnvPluginManager, plugin.py:118)."""
    from ray_tpu_torch.runtime_env import RuntimeEnvPlugin, register_plugin

    class StampPlugin(RuntimeEnvPlugin):
        name = "stamp"
        priority = 15

        async def create(self, value, ctx, node):
            ctx.env_vars["STAMP_FROM_PLUGIN"] = str(value).upper()

    register_plugin(StampPlugin())

    @ray_tpu_torch.remote(runtime_env={"stamp": "hello"})
    def read():
        import os
        return os.environ.get("STAMP_FROM_PLUGIN")

    assert ray_tpu_torch.get(read.remote()) == "HELLO"


def test_unknown_runtime_env_key_fails_loudly(ray_start):
    @ray_tpu_torch.remote(runtime_env={"no_such_plugin": 1})
    def f():
        return 1

    with pytest.raises(Exception, match="no_such_plugin"):
        ray_tpu_torch.get(f.remote(), timeout=60)


def test_working_dir_uri_cached_per_node(ray_start, tmp_path):
    """A storage-URI working_dir downloads ONCE per node and is reused
    by every later env with the same URI (per-node URI caching,
    reference: runtime-env agent URI cache)."""
    from ray_tpu_torch.train import storage

    src = tmp_path / "wd"
    src.mkdir()
    (src / "data.txt").write_text("uri-cached-content")
    storage.upload_dir(str(src), "mock://renv/wd1")

    @ray_tpu_torch.remote(runtime_env={"working_dir": "mock://renv/wd1",
                                 "env_vars": {"WD_ROUND": "1"}})
    def read1():
        return open("data.txt").read()

    @ray_tpu_torch.remote(runtime_env={"working_dir": "mock://renv/wd1",
                                 "env_vars": {"WD_ROUND": "2"}})
    def read2():
        return open("data.txt").read()

    assert ray_tpu_torch.get(read1.remote()) == "uri-cached-content"
    assert ray_tpu_torch.get(read2.remote()) == "uri-cached-content"
    rt = ray_tpu_torch.init(ignore_reinit_error=True)
    cache = rt.head_daemon._env_manager.node.cache
    assert cache.misses == 1 and cache.hits >= 1, (
        cache.hits, cache.misses)


def test_uv_env_builds_venv_worker(ray_start):
    """uv plugin: worker runs under a venv interpreter built on demand
    (create-on-demand + cache; uv binary optional, pip fallback)."""
    @ray_tpu_torch.remote(runtime_env={"uv": {"packages": []}})
    def which_python():
        import sys
        return sys.executable

    exe = ray_tpu_torch.get(which_python.remote(), timeout=120)
    assert "venv" in exe, exe


def test_conda_missing_binary_fails_loudly(ray_start, monkeypatch):
    @ray_tpu_torch.remote(runtime_env={"conda": "someenv"})
    def f():
        return 1

    rt = ray_tpu_torch.init(ignore_reinit_error=True)
    import shutil as _sh
    if _sh.which("conda") or os.environ.get("CONDA_EXE"):
        pytest.skip("conda present on this box")
    with pytest.raises(Exception, match="conda"):
        ray_tpu_torch.get(f.remote(), timeout=60)


def test_image_uri_stub_wraps_spawn(ray_start, tmp_path):
    """image_uri propagates through a configured container prefix (the
    GKE/KubeRay hook); bare nodes without a prefix fail loudly."""
    rt = ray_tpu_torch.init(ignore_reinit_error=True)
    daemon = rt.head_daemon
    from ray_tpu_torch._private.config import get_config

    @ray_tpu_torch.remote(runtime_env={"image_uri": "gcr.io/proj/img:1"})
    def containered():
        import os
        return os.environ.get("FAKE_CONTAINER_IMAGE")

    # no container runtime configured -> loud failure
    if not get_config().container_run_prefix:
        with pytest.raises(Exception, match="container"):
            ray_tpu_torch.get(containered.remote(), timeout=60)
    # configure a fake runtime: env-wrapper stands in for podman/docker
    old = get_config().container_run_prefix
    get_config().container_run_prefix = "env FAKE_CONTAINER_IMAGE={image}"
    try:
        assert ray_tpu_torch.get(containered.remote(),
                           timeout=120) == "gcr.io/proj/img:1"
    finally:
        get_config().container_run_prefix = old
