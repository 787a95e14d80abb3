"""Public runtime-env surface: plugin API + context.

Reference parity: python/ray/runtime_env + the RuntimeEnvPlugin
extension point (python/ray/_private/runtime_env/plugin.py:24,118).
Register a plugin in the process hosting the node daemon (or point
RAY_TPU_RUNTIME_ENV_PLUGINS at "module:Class" so every daemon loads it):

    class MyPlugin(ray_tpu_torch.runtime_env.RuntimeEnvPlugin):
        name = "my_key"
        async def create(self, value, ctx, node):
            ctx.env_vars["MY_KEY"] = str(value)

    ray_tpu_torch.runtime_env.register_plugin(MyPlugin())
    ray_tpu_torch.remote(runtime_env={"my_key": 1})(fn)
"""

from ._private.runtime_env import (NodeServices, RuntimeEnvContext,
                                   RuntimeEnvPlugin, URICache,
                                   register_plugin)

__all__ = ["RuntimeEnvPlugin", "RuntimeEnvContext", "NodeServices",
           "URICache", "register_plugin"]
