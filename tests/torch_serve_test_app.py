"""Importable app of the port's serve for the YAML-deploy tests (the
import_path target); the counterpart of serve_test_app.py."""

from ray_tpu_torch import serve


@serve.deployment
class Doubler:
    def __call__(self, x):
        return x * 2


@serve.deployment
class Gateway:
    def __init__(self, doubler):
        self.doubler = doubler

    async def __call__(self, x):
        return await self.doubler.remote(x) + 1


app = Gateway.bind(Doubler.bind())


def build_app(args=None):
    """Builder form: `import_path: torch_serve_test_app:build_app` +
    args."""
    bias = (args or {}).get("bias", 0)

    @serve.deployment(name="Biaser")
    def biaser(x):
        return x + bias

    return biaser.bind()
