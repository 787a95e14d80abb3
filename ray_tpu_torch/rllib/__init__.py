"""ray_tpu_torch.rllib: RLlib on PyTorch.

Counterpart of ``ray_tpu/rllib`` (the new-stack RLlib: EnvRunners +
Connectors + RLModule + Learner): PPO, IMPALA, APPO, DQN, SAC, CQL,
DreamerV3, offline BC and MARWIL, and multi-agent PPO. Environments are
batched tensor code (``env/torch_env.py``, ``env/multi_agent_env.py``),
so a rollout steps every env on the device, and the learners' updates
run there too.

Remote env runners (``num_env_runners > 0``) and several learners
(``num_learners > 1``, PPO, IMPALA and APPO) run as actors of the
port's runtime; an Algorithm is a Tune Trainable
(``ray_tpu_torch.tune``).
"""

from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.appo import APPO, APPOConfig
from .algorithms.cql import CQL, CQLConfig
from .algorithms.dqn import DQN, DQNConfig, QModule
from .algorithms.dreamer_v3 import DreamerV3, DreamerV3Config
from .algorithms.impala import IMPALA, IMPALAConfig
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
from .algorithms.ppo import PPO, PPOConfig
from .algorithms.sac import SAC, SACConfig
from .core.learner import Learner, LearnerGroup
from .core.multi_rl_module import MultiRLModule
from .core.rl_module import (CNNRLModule, DefaultRLModule, RLModule,
                             params_from_flax)
from .env.env_runner import SingleAgentEnvRunner
from .env.env_runner_group import EnvRunnerGroup
from .env.multi_agent_env import (DualCartPole, MultiAgentJaxEnv,
                                  MultiAgentTorchEnv, RockPaperScissors,
                                  make_multi_agent_env,
                                  register_multi_agent_env)
from .env.multi_agent_env_runner import (MultiAgentEnvRunner,
                                         MultiAgentEnvRunnerGroup)
from .env.torch_env import (CartPole, CatchPixels, EnvSpec, Pendulum,
                            TorchEnv, make_env, register_env)
from .offline import (BC, BCConfig, MARWIL, MARWILConfig, OfflineData,
                      record_samples)
from .utils.replay_buffers import ReplayBuffer

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "QModule",
    "SAC", "SACConfig", "CQL", "CQLConfig", "DreamerV3", "DreamerV3Config",
    "BC", "BCConfig", "MARWIL", "MARWILConfig", "OfflineData",
    "record_samples",
    "ReplayBuffer", "Learner", "LearnerGroup", "RLModule", "CNNRLModule",
    "DefaultRLModule", "params_from_flax", "SingleAgentEnvRunner",
    "EnvRunnerGroup", "TorchEnv", "CartPole", "Pendulum", "CatchPixels",
    "EnvSpec", "register_env", "make_env",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiRLModule",
    "MultiAgentTorchEnv", "MultiAgentJaxEnv", "DualCartPole",
    "RockPaperScissors", "register_multi_agent_env", "make_multi_agent_env",
    "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup",
]
