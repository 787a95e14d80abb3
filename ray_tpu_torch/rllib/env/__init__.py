from .torch_env import (CartPole, CatchPixels, EnvSpec, Pendulum, TorchEnv,
                        make_env, register_env, stacked_spec)
from .env_runner import SingleAgentEnvRunner
from .env_runner_group import EnvRunnerGroup
