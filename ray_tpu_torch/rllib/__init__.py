"""ray_tpu_torch.rllib: RLlib's single-learner path on PyTorch.

Counterpart of ``ray_tpu/rllib`` (the new-stack RLlib: EnvRunners +
Connectors + RLModule + Learner). Environments are batched tensor code
(``env/torch_env.py``), so a rollout steps every env on the device, and
the learner's update runs there too. One local env runner and one local
learner: remote runners and several learners wait for an actor runtime
in the port (ROADMAP.md §A5, §A8).
"""

from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.appo import APPO, APPOConfig
from .algorithms.dqn import DQN, DQNConfig, QModule
from .algorithms.impala import IMPALA, IMPALAConfig
from .algorithms.ppo import PPO, PPOConfig
from .core.learner import Learner, LearnerGroup
from .core.rl_module import (CNNRLModule, DefaultRLModule, RLModule,
                             params_from_flax)
from .env.env_runner import SingleAgentEnvRunner
from .env.env_runner_group import EnvRunnerGroup
from .env.torch_env import (CartPole, CatchPixels, EnvSpec, Pendulum,
                            TorchEnv, make_env, register_env)
from .utils.replay_buffers import ReplayBuffer

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "QModule",
    "ReplayBuffer", "Learner", "LearnerGroup", "RLModule", "CNNRLModule",
    "DefaultRLModule", "params_from_flax", "SingleAgentEnvRunner",
    "EnvRunnerGroup", "TorchEnv", "CartPole", "Pendulum", "CatchPixels",
    "EnvSpec", "register_env", "make_env",
]
