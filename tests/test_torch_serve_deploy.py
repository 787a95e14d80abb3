"""ray_tpu_torch.serve: declarative deploy (YAML/schema) and local
testing mode.

Mirrors tests/test_serve_deploy.py case for case; the YAML deploy runs
on the port's runtime, and the import path names
torch_serve_test_app.py, this file's counterpart of serve_test_app.py.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))   # the test app importable

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.schema import (DeploymentSchema,
                                        ServeApplicationSchema,
                                        ServeDeploySchema,
                                        build_app_from_schema)


@pytest.fixture()
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ----------------------------------------------------------- local testing

def test_local_testing_mode_no_cluster():
    """Handles work with NO cluster: composition, methods, streaming."""
    @serve.deployment
    class Child:
        def __call__(self, x):
            return x * 2

        def describe(self):
            return "child"

    @serve.deployment
    class Parent:
        def __init__(self, child):
            self.child = child

        async def __call__(self, x):
            return await self.child.remote(x) + 1

        def stream(self, n):
            for i in range(n):
                yield i * 10

    h = serve.run(Parent.bind(Child.bind()), name="local-app",
                  local_testing_mode=True)
    assert h.remote(5).result() == 11
    # direct child handle + non-default method
    ch = serve.get_deployment_handle("Child", "local-app")
    assert ch.remote(3).result() == 6
    assert ch.describe.remote().result() == "child"
    # streaming
    items = list(h.options(method_name="stream", stream=True).remote(3))
    assert items == [0, 10, 20]
    serve.shutdown()


def test_local_testing_mode_init_errors_raise_eagerly():
    @serve.deployment
    class Broken:
        def __init__(self):
            raise RuntimeError("constructor boom")

    with pytest.raises(RuntimeError, match="constructor boom"):
        serve.run(Broken.bind(), name="broken-app",
                  local_testing_mode=True)
    serve.shutdown()


def test_local_testing_user_config():
    @serve.deployment(user_config={"k": 7})
    class Cfg:
        def __init__(self):
            self.k = 0

        def reconfigure(self, cfg):
            self.k = cfg["k"]

        def __call__(self):
            return self.k

    h = serve.run(Cfg.bind(), name="cfg-local", local_testing_mode=True)
    assert h.remote().result() == 7
    serve.shutdown()


# ----------------------------------------------------------------- schema

def test_schema_validation():
    with pytest.raises(ValueError, match="import_path"):
        ServeApplicationSchema.from_dict({"name": "x"})
    with pytest.raises(ValueError, match="unknown application"):
        ServeApplicationSchema.from_dict(
            {"import_path": "a:b", "bogus": 1})
    with pytest.raises(ValueError, match="duplicate application"):
        ServeDeploySchema.from_dict({"applications": [
            {"import_path": "a:b", "name": "x"},
            {"import_path": "c:d", "name": "x"}]})
    with pytest.raises(ValueError, match="duplicate route_prefix"):
        ServeDeploySchema.from_dict({"applications": [
            {"import_path": "a:b", "name": "x", "route_prefix": "/"},
            {"import_path": "c:d", "name": "y", "route_prefix": "/"}]})
    # null route_prefix never collides
    s = ServeDeploySchema.from_dict({"applications": [
        {"import_path": "a:b", "name": "x", "route_prefix": None},
        {"import_path": "c:d", "name": "y", "route_prefix": None}]})
    assert len(s.applications) == 2
    with pytest.raises(ValueError, match="needs a 'name'"):
        DeploymentSchema.from_dict({"num_replicas": 2})


def test_build_app_from_schema_overrides_and_builder():
    app = build_app_from_schema(ServeApplicationSchema(
        import_path="torch_serve_test_app:app",
        deployments=[DeploymentSchema(name="Doubler", num_replicas=2)]))
    # find the Doubler node and check the override landed
    child = app._args[0]
    assert child._deployment.config.num_replicas == 2
    # typo'd override name must raise, not silently no-op
    with pytest.raises(ValueError, match="match no deployment"):
        build_app_from_schema(ServeApplicationSchema(
            import_path="torch_serve_test_app:app",
            deployments=[DeploymentSchema(name="Dublor")]))
    # builder function + args
    b = build_app_from_schema(ServeApplicationSchema(
        import_path="torch_serve_test_app:build_app", args={"bias": 5}))
    h = serve.run(b, name="builder-local", local_testing_mode=True)
    assert h.remote(1).result() == 6
    serve.shutdown()


# ------------------------------------------------------------- YAML deploy

def test_yaml_deploy_e2e(ray_start, tmp_path):
    cfg = tmp_path / "app.yaml"
    # the proxy on a port it picks: the JAX suite's serve tests bind the
    # default 8000 in other workers
    cfg.write_text("""
http_options:
  port: 0
applications:
  - name: yaml-app
    route_prefix: /yaml
    import_path: torch_serve_test_app:app
    deployments:
      - name: Doubler
        num_replicas: 1
      - name: Gateway
        max_ongoing_requests: 4
""")
    try:
        handles = serve.deploy_config(str(cfg))
        assert set(handles) == {"yaml-app"}
        assert handles["yaml-app"].remote(4).result() == 9
        st = serve.status()
        assert st["applications"]["yaml-app"]["status"] == "RUNNING"
    finally:
        serve.shutdown()


def test_overrides_reach_container_nested_deployments():
    """Applications bound inside list/dict args get overrides and
    runtime_env folding too (shared map_deployments walker)."""
    @serve.deployment
    class Leaf:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Fan:
        def __init__(self, children):
            self.children = children

        async def __call__(self, x):
            out = x
            for c in self.children:
                out = await c.remote(out)
            return out

    from ray_tpu_torch.serve.schema import _apply_overrides
    app = Fan.bind([Leaf.bind()])
    out = _apply_overrides(
        app, {"Leaf": DeploymentSchema(name="Leaf", num_replicas=3)})
    leaf = out._args[0][0]
    assert leaf._deployment.config.num_replicas == 3
    from ray_tpu_torch.serve.api import _fold_runtime_env
    folded = _fold_runtime_env(app, {"env_vars": {"A": "1"}})
    leaf2 = folded._args[0][0]
    assert leaf2._deployment.config.ray_actor_options[
        "runtime_env"] == {"env_vars": {"A": "1"}}
    # and the graph still works end-to-end in local mode
    h = serve.run(out, name="fan-local", local_testing_mode=True)
    assert h.remote(1).result() == 2
    serve.shutdown()
