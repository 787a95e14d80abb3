from .algorithm import Algorithm, AlgorithmConfig
from .ppo import PPO, PPOConfig, PPOLearner
from .impala import IMPALA, IMPALAConfig, IMPALALearner, vtrace
from .appo import APPO, APPOConfig, APPOLearner
from .dqn import DQN, DQNConfig, DQNLearner, QModule
